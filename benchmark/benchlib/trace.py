# trace.py — the profiled stretch of a traced run and what is read from it.
"""A ``--trace 1`` run profiles one bounded stretch inside its window: the
window's first call.  ``torch.profiler`` keeps the device's kernels,
copies and memsets and the host's torch operations and CUDA runtime
calls; ``Stretch.reduce`` turns them into plain lists once the window has
closed, reading the profiler's raw events (``chip_smoke.py``'s
``device_time`` went through ``key_averages``, which takes a minute for
the million kernels of an RPM call).  Only device events count as device
time: a host op's own device time repeats that of what it launched.  The
tracer may drop records when its buffers fill: the stretch counts the
launches of each hand-written kernel the program's own counter
(``LAUNCHES``) saw, and a trace that kept fewer or more events of that
kernel than were launched is a failed trace, which no reader reads.
"""
from __future__ import annotations

import time

# a kernel's name in the breakdown is cut to this many characters
NAME_CHARS = 160


def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals in us."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def gaps(intervals, lo: float, hi: float):
    """The idle stretches between the busy intervals, within [lo, hi]
    (us) -> [(start, end)]."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [g for g in out if g[1] > g[0]]


class Stretch:
    """``with Stretch(counters):`` profiles what runs inside it.
    `counters` maps a kernel's name fragment to its wrapper module, whose
    ``LAUNCHES`` the program keeps true to what the card ran."""

    def __init__(self, counters: dict):
        self.counters = counters
        self.summary = None

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        self._before = {k: m.LAUNCHES for k, m in self.counters.items()}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self._wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        self._launched = {k: m.LAUNCHES - self._before[k]
                          for k, m in self.counters.items()}
        return False

    def reduce(self) -> dict:
        """The stretch as plain data (``summarize``), once the window has
        closed: the reduction takes seconds for a million events."""
        t = time.perf_counter()
        self.summary = summarize(self._prof, self._launched, self._wall)
        self.summary["reduce_s"] = time.perf_counter() - t
        del self._prof
        return self.summary


def _events(prof):
    """(name, is on the device, start us, end us) of every event the
    profiler kept, read from its raw results (building torch's
    FunctionEvent tree for a million events takes a minute)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        yield e.name(), e.device_type() == cuda, start, \
            start + e.duration_ns() / 1e3


def summarize(prof, launched: dict, wall_s: float) -> dict:
    """The stretch as plain data: device events (name, start us, end us,
    is a kernel), host events on the profiler's clock, the launches the
    program counted and the kernel events the trace kept of each."""
    dev, host = [], []
    for name, on_device, start, end in _events(prof):
        if on_device:
            kernel = not ("Memcpy" in name or "Memset" in name)
            dev.append((name, start, end, kernel))
        else:
            host.append((name, start, end))
    kept = {k: sum(1 for d in dev if d[3] and k in d[0]) for k in launched}
    dropped = {k: (kept[k], n) for k, n in launched.items() if kept[k] != n}
    lo = min([d[1] for d in dev] + [h[1] for h in host], default=0.0)
    hi = max([d[2] for d in dev] + [h[2] for h in host], default=0.0)
    return {"device": dev, "host": host, "launched": launched,
            "kept": kept, "dropped": dropped, "wall_s": wall_s,
            "lo_us": lo, "hi_us": hi}


def busy_s(summary: dict) -> float:
    return union_s([(d[1], d[2]) for d in summary["device"]])


def window_s(summary: dict) -> float:
    return summary["wall_s"]


def kernel_s(summary: dict, fragment: str) -> float:
    """Device seconds of the kernels whose name holds `fragment`."""
    return sum(d[2] - d[1] for d in summary["device"]
               if d[3] and fragment in d[0]) / 1e6


def kernels(summary: dict) -> int:
    return sum(1 for d in summary["device"] if d[3])


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the host event that covered most of it."""
    by_name = {}
    for name, s, e, _k in summary["device"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = [(d[1], d[2]) for d in summary["device"]]
    idle = sorted(gaps(busy, summary["lo_us"], summary["hi_us"]),
                  key=lambda g: g[0] - g[1])[:top]
    host = summary["host"]
    named = []
    for lo, hi in idle:
        best, cover = "host, no traced call", 0.0
        for name, s, e in host:
            c = min(e, hi) - max(s, lo)
            if c > cover:
                best, cover = name, c
        named.append([best[:NAME_CHARS], (hi - lo) / 1e6])
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": named}
