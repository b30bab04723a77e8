# profiling.py — device tracing and throughput counters.
"""``trace(dir)``: a ``torch.profiler`` context that writes a Chrome trace
(CPU and, on a card, CUDA activity) into `dir` when the block ends; a no-op
when `dir` is falsy.  ``Throughput``: wall-clock accounting by phase with a
samples/s summary.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block and write ``<log_dir>/trace_<pid>_<ms>.json``
    (open it in chrome://tracing or Perfetto); no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    import torch
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))


class Throughput:
    """Phase-tagged wall-clock accounting with a samples/s summary."""

    def __init__(self):
        self.t0 = time.time()
        self.samples = 0
        self.phase_time: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.time()
        try:
            yield
        finally:
            self.phase_time[name] += time.time() - t

    def add(self, n: int):
        self.samples += n

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(time.time() - self.t0, 1e-9)

    def summary(self) -> dict:
        total = time.time() - self.t0
        return {
            "samples": self.samples,
            "wall_s": round(total, 3),
            "samples_per_sec": round(self.samples_per_sec, 3),
            "phases": {k: round(v, 3) for k, v in self.phase_time.items()},
        }
