# compare.py — the comparisons that decide a run's ``correct``.
"""Each returns a count or a distance, never a verdict: the harness holds
each reading against its limit in the cell's file."""
from __future__ import annotations

import numpy as np


def png_diff(path: str, want: np.ndarray) -> int:
    """Channel values of the PNG at `path` that differ from `want` (u8
    ``[H, W, 3]``); a file that is missing, does not decode or has another
    shape differs in every value."""
    from plainref.io.png_read import read_png
    want = np.asarray(want)
    try:
        got = read_png(path)
    except (OSError, ValueError, KeyError, EOFError):
        return int(want.size)
    except Exception:               # zlib.error, struct.error
        return int(want.size)
    if got.shape != want.shape:
        return int(want.size)
    return int(np.count_nonzero(got != want))


def json_diff(got, want, skip=()) -> int:
    """Leaves of two JSON trees that differ (a key or item on one side
    only counts once); keys named in `skip` are not compared."""
    if isinstance(want, dict):
        if not isinstance(got, dict):
            return 1
        n = 0
        for k in set(got) | set(want):
            if k in skip:
                continue
            if k not in got or k not in want:
                n += 1
            else:
                n += json_diff(got[k], want[k], skip)
        return n
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return 1
        return sum(json_diff(g, w, skip) for g, w in zip(got, want))
    return int(type(got) is not type(want) or got != want)


def hamming_hex(a: str, b: str) -> int:
    """Bits that differ between two hex pHashes (64 when one is absent)."""
    try:
        x = bytes.fromhex(a)
        y = bytes.fromhex(b)
    except (TypeError, ValueError):
        return 64
    if len(x) != len(y) or not x:
        return 64
    return sum(bin(p ^ q).count("1") for p, q in zip(x, y))


def _hash_bytes(hexhash):
    try:
        b = bytes.fromhex(hexhash)
    except (TypeError, ValueError):
        return None
    return np.frombuffer(b, np.uint8) if len(b) == 8 else None


def kept_violations(metas_in_order, threshold: int) -> int:
    """Greedy first-wins dedup replayed over one call's index entries, in
    the order the generator submitted them: a kept entry without a pHash,
    or within `threshold` bits of an earlier kept one, is a violation (a
    duplicate entry's hash is not exported; ``duplicate_violation`` checks
    those the reference recomputes)."""
    kept = np.zeros((len(metas_in_order), 8), np.uint8)
    n = bad = 0
    for m in metas_in_order:
        if m is None or m.get("error") or m.get("duplicate"):
            continue
        h = _hash_bytes(m.get("grid_phash"))
        if h is None:
            bad += 1
            continue
        if n and (np.unpackbits(kept[:n] ^ h, axis=1).sum(1)
                  <= threshold).any():
            bad += 1
        kept[n] = h
        n += 1
    return bad


def duplicate_violation(hexhash: str, earlier_metas, threshold: int) -> int:
    """1 when an entry marked duplicate has no earlier kept entry within
    `threshold` bits of its (recomputed) hash."""
    for m in earlier_metas:
        if m is None or m.get("error") or m.get("duplicate"):
            continue
        if hamming_hex(hexhash, m.get("grid_phash", "")) <= threshold:
            return 0
    return 1
