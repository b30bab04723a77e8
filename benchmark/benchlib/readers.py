# readers.py — what the per-layer metrics' readers share.
"""Each returns None when its run has nothing for it to read: another
system's cell, an untraced run, or a trace that dropped records of the
kernel it reads."""
from __future__ import annotations

from . import roofline, trace

# a kernel's name fragment in the device trace, per system
KERNEL = {"rpm": "raster_kernel", "mg": "mg_render_kernel"}
WORK = {"rpm": "k1_bytes", "mg": "k2_bytes"}


def _trace(ctx: dict, system: str):
    if ctx.get("system") != system:
        return None
    tr = ctx.get("trace")
    if tr is None or tr["dropped"]:
        return None
    return tr


def idle_share(ctx: dict, system: str):
    """Percent of the profiled stretch in which nothing ran on the card."""
    tr = _trace(ctx, system)
    if tr is None or tr["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / tr["wall_s"])


def kernel_roofline(ctx: dict, system: str):
    """Percent of the bytes' bound the system's rasterizer reached over
    the stretch: the least time its frames' bytes need at the card's peak
    bandwidth, over the kernel's device time."""
    tr = _trace(ctx, system)
    if tr is None:
        return None
    t = trace.kernel_s(tr, KERNEL[system])
    if t <= 0 or not tr.get(WORK[system]):
        return None
    return 100.0 * tr[WORK[system]] / roofline.PEAK_BYTES_PER_S / t


def kernels_per_batch(ctx: dict, system: str):
    """Device kernels in the stretch per launch of the rasterizer, which
    runs once a batch."""
    tr = _trace(ctx, system)
    if tr is None:
        return None
    n = tr["kept"].get(KERNEL[system], 0)
    return trace.kernels(tr) / n if n else None


def transfer_mb(ctx: dict, system: str):
    """Megabytes copied from the card to the host per sample or scene of
    the window (the generator's ``transfer_bytes``)."""
    if ctx.get("system") != system or not ctx.get("samples"):
        return None
    return ctx["transfer_bytes"] / ctx["samples"] / 1e6


def captures(ctx: dict, system: str):
    """CUDA graphs captured inside the window (``graphs.CAPTURES``)."""
    if ctx.get("system") != system:
        return None
    return ctx["captures"]


def window_rate(ctx: dict, system: str):
    """Samples (scenes) of the window's calls per second of their wall
    time; in a traced run, without the profiled first call and its wall."""
    if ctx.get("system") != system or not ctx.get("call_n"):
        return None
    n, wall = ctx["samples"], ctx["window_s"]
    if ctx.get("trace") is not None:
        n -= ctx["call_n"][0]
        wall -= ctx["call_s"][0]
    return n / wall if n > 0 and wall > 0 else None
