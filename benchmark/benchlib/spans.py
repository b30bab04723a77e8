# spans.py — per-layer metrics read from the program's own spans over the
# traced stretch.
"""The program records spans (``reasoning_image_generation_tpu_torch/utils/
profiling.py``) while a ``torch.profiler`` session is active, so the traced
stretch (``trace.Stretch``) records them with no switch of its own: the
generators' calls and batches, the main thread's stages (dispatch, scene
build, pinning, the wait for a copy, export, the wait for the export
threads) and every export task on its worker thread.  They are stamped on
the profiler's clock, so each lines up with the stretch's device events.

Each reader returns None when its run has nothing for it to read: another
system's cell, an untraced run, a trace that dropped records (as
``readers._trace``), or a program that records no spans (an older one),
or none of this system's calls in the stretch.  Shares are of the
stretch's wall (``wall_s``), each span clipped to the stretch (its first
and last event, ``lo_us`` .. ``hi_us``); a span's self time is its
duration less what its children on its thread cover.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import NamedTuple

from . import readers, trace


def program_spans():
    """The spans the program recorded in this process, or None from a
    program that records none."""
    try:
        from reasoning_image_generation_tpu_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, "spans", None)
    return None if get is None else get()


class View(NamedTuple):
    """The stretch and the spans that overlap it: bounds in ns, the spans
    closed by now, and the main thread (the one the call ran on)."""
    trace: dict
    lo: float
    hi: float
    spans: list
    main: int


def view(ctx: dict, system: str):
    tr = readers._trace(ctx, system)
    if tr is None or tr["wall_s"] <= 0:
        return None
    sps = program_spans()
    if sps is None:
        return None
    lo, hi = tr["lo_us"] * 1e3, tr["hi_us"] * 1e3
    sps = [s for s in sps if s.end_ns is not None
           and s.end_ns > lo and s.start_ns < hi]
    calls = [s for s in sps if s.name == f"{system}.call"]
    if not calls:
        return None
    return View(tr, lo, hi, sps, calls[0].tid)


def merge(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _clipped(v: View, s):
    return max(s.start_ns, v.lo), min(s.end_ns, v.hi)


def self_ns(v: View, name: str) -> float:
    """ns of the main thread inside spans `name` and in none of their
    children, within the stretch."""
    kids = defaultdict(list)
    for s in v.spans:
        if s.tid == v.main:
            kids[s.parent].append(s)
    total = 0.0
    for s in v.spans:
        if s.name != name or s.tid != v.main:
            continue
        a, b = _clipped(v, s)
        if b <= a:
            continue
        cover = merge((max(c.start_ns, a), min(c.end_ns, b))
                      for c in kids[s.id])
        total += (b - a) - sum(e - s0 for s0, e in cover)
    return total


def self_share(ctx: dict, system: str, name: str):
    """Percent of the stretch's wall the main thread spent in spans
    `name`, less their children."""
    v = view(ctx, system)
    if v is None:
        return None
    return 100.0 * self_ns(v, name) / (v.trace["wall_s"] * 1e9)


def pool_busy_share(ctx: dict, system: str):
    """Percent of the export threads' time in the stretch spent in export
    tasks: their summed durations over (the pool's worker count, from the
    tasks' ``workers``, times the stretch's wall)."""
    v = view(ctx, system)
    if v is None:
        return None
    tasks = [s for s in v.spans if s.name == "export.task"]
    workers = max((s.attrs.get("workers", 0) for s in tasks), default=0)
    if not workers:
        return None
    busy = sum(max(0.0, b - a) for a, b in (_clipped(v, s) for s in tasks))
    return 100.0 * busy / (workers * v.trace["wall_s"] * 1e9)


def idle_unattributed_share(ctx: dict, system: str):
    """Percent of the device's idle time in the stretch during which no
    stage span of the main thread (``leaf``) was open."""
    v = view(ctx, system)
    if v is None:
        return None
    tr = v.trace
    idle = trace.gaps([(d[1], d[2]) for d in tr["device"]],
                      tr["lo_us"], tr["hi_us"])
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    stages = merge((s.start_ns / 1e3, s.end_ns / 1e3) for s in v.spans
                   if s.leaf and s.tid == v.main)
    return 100.0 * (total - overlap(idle, stages)) / total


def batch_to_disk_s(ctx: dict, system: str):
    """Median seconds from a batch's dispatch to its last file written,
    over the batches dispatched in the stretch."""
    v = view(ctx, system)
    if v is None:
        return None
    d = [(s.end_ns - s.start_ns) / 1e9 for s in v.spans
         if s.name == f"{system}.batch" and v.lo <= s.start_ns <= v.hi]
    return statistics.median(d) if d else None
