# cache.py — persisted transfer-tier statistics.
"""The run statistics of the transfer codecs (the largest run, palette,
escape ... counts seen per packed stream, io/transfer.transfer_tier),
persisted per configuration so that a fresh process starts with converged
tiers.  They live in a directory of the port's own, never the JAX
package's: ``$RIG_TORCH_CACHE`` if set, else
``~/.cache/reasoning_image_generation_tpu_torch``, read at every call.
"""
from __future__ import annotations

import json
import os


def cache_dir() -> str:
    return os.environ.get("RIG_TORCH_CACHE") or os.path.expanduser(
        "~/.cache/reasoning_image_generation_tpu_torch")


def _path(name: str) -> str:
    return os.path.join(cache_dir(), f"runstats_{name}.json")


def load_run_stats(name: str) -> dict:
    """Persisted statistics of `name`, as floats (the compacted codecs keep
    per-frame averages); {} when there are none."""
    try:
        with open(_path(name), encoding="utf-8") as f:
            return {str(k): float(v) for k, v in json.load(f).items()}
    except (OSError, ValueError, AttributeError):
        return {}


def save_run_stats(name: str, stats: dict) -> None:
    """Max-merge `stats` into the persisted file (atomic replace)."""
    if not stats:
        return
    merged = load_run_stats(name)
    for k, v in stats.items():
        merged[k] = max(float(v), merged.get(k, 0.0))
    try:
        os.makedirs(cache_dir(), exist_ok=True)
        tmp = f"{_path(name)}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(merged, f)
        os.replace(tmp, _path(name))
    except OSError:
        pass
