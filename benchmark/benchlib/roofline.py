# roofline.py — the card's peaks and the work the two rasterizers need.
"""Frozen with the benchmark, so that a later change to the program cannot
move the yardstick.  Peaks: one NVIDIA H100 SXM (80 GB HBM3) at its full
700 W, from NVIDIA's data sheet.  Work: bytes and float32 operations that
rendering needs, counted from what is rendered (frames or scenes, their
pixels and channels written, their records read), not from how a kernel
does it, so that any later implementation is read the same way.

``k1_work`` and ``k2_work`` also count operations per pixel with the culls
of the plain renderers (``plainref``); at the cells' shapes the bytes bound
both kernels (K1 at 256 frames of 512²: 203.6 MB, 0.0608 ms, against
0.715 GFLOP, 0.0107 ms; K2 at 16 scenes of 1600²: 123.0 MB, 0.0367 ms,
against 0.378 GFLOP, 0.0056 ms), and those counts take seconds a batch on
the host, so a traced run reads the roofline from the bytes alone: a
share of the bytes' bound that never exceeds the share of the full bound.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_PER_S = 67e12         # H100 SXM float32, outside the tensor cores

# float32 operations per pixel, counted from the kernels' sources (a fused
# multiply-add counts 2; per-edge and per-line constants are not counted)
EDGE_DIST_OPS = 16     # one polygon edge of the distance loop
EDGE_CROSS_OPS = 6     # one polygon edge of the crossing count
EDGE_OPS = EDGE_DIST_OPS + EDGE_CROSS_OPS
K1_CIRCLE_OPS = 10     # analytic circle distance + stroke
K1_ELEM_OPS = 20       # stroke ramp, compositing
K2_SHAPE_OPS = 16      # stroke band, mask keep, compositing
K2_GRAD_OPS = 34       # radial gradient fill
K2_RB_OPS = 12         # replace_boundary stroke
K2_LINE_OPS = 35       # one decoration segment
OUT_OPS = 9            # round and clamp 3 channels

K1_NMETA = 20          # float32 fields of an element's record
K1_VERTS = 2 * 2 * 64  # float32 vertices of an element (two outlines, x, y)
K2_NMETA, K2_NCOL = 20, 8   # float32 record of a scene
K2_SHAPES, K2_NV = 3, 64    # shapes and vertices a scene's outlines hold
K2_LINES, K2_NLIN = 24, 16  # decoration lines and their fields


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bytes(N: int, E: int, W: int, H: int) -> int:
    """N frames of E element slots: each frame's pixels written once, each
    element's record and outlines read once, one grid flag a frame."""
    return N * H * W * 3 + N * E * (K1_NMETA + K1_VERTS) * 4 + N


def k2_bytes(N: int, W: int, H: int) -> int:
    """N scenes: each pixel written once; the scene record, its shapes'
    and masks' outlines and its decoration lines read once."""
    meta = N * K2_NMETA * K2_NCOL
    outlines = 4 * N * K2_SHAPES * K2_NV
    lines = N * K2_LINES * K2_NLIN
    return N * H * W * 3 + (meta + outlines + lines) * 4


def k1_work(meta, vx, vy, W: int, H: int):
    """Bytes and float32 operations K1 needs for prepared frames, counted
    per pixel with the kernel's rules at their finest grain
    (raster.tile_culls with a 1x1 tile): an element's stroke and
    compositing for the pixels inside its bbox and wrap gate, the distance
    step for the edges near that pixel, the crossing step for the edges
    that span that pixel's row, and only where the element is filled."""
    import torch
    from plainref.ops import raster as R
    N, E = meta.shape[:2]
    ops = 0.0
    on = meta[..., R.M_VALID].reshape(-1) > 0
    fm = meta.reshape(N * E, 1, R.NMETA)[on]
    fx = vx.reshape(N * E, 1, *vx.shape[2:])[on]
    fy = vy.reshape(N * E, 1, *vy.shape[2:])[on]
    poly = ~((fm[..., R.M_CIRCLE] > 0) | (fm[..., R.M_CRESCENT] > 0))
    big = (poly & ~(fm[..., R.M_SMALL] > 0))[:, 0]
    passes = []
    for idx, V in ((torch.nonzero(~big).squeeze(1), R.SMALL_V),
                   (torch.nonzero(big).squeeze(1), 64)):
        step = max(1, (1 << 26) // (H * W * 2 * V))
        passes += [idx[i:i + step] for i in range(0, len(idx), step)]
    for idx in passes:
        m = fm[idx]
        c = R.tile_culls(m, fx[idx], fy[idx], W, H, (1, 1))
        live = c.live                                     # [n, 1, H, W]
        analytic = (m[..., R.M_CIRCLE] > 0) | (m[..., R.M_CRESCENT] > 0)
        per_px = K1_ELEM_OPS * (1 + (m[..., R.M_HASP1] > 0).float()) + \
            torch.where(m[..., R.M_CIRCLE] > 0, K1_CIRCLE_OPS,
                        2 * K1_CIRCLE_OPS) * analytic
        ops += float((live.sum((-1, -2)) * per_px).sum())
        ops += float(c.near.sum()) * EDGE_DIST_OPS
        cols = live.sum(-1).float()                       # [n, 1, H]
        filled = (m[..., R.M_FILL] != 0)[..., None]
        ops += float((c.rows.sum((-1, -2)) * cols * filled).sum()) \
            * EDGE_CROSS_OPS
        del c, live
    ops += N * H * W * OUT_OPS
    return k1_bytes(N, E, W, H), ops


def k2_work(args, W: int, H: int):
    """Bytes and float32 operations K2 needs for prepared scenes, counted
    per pixel with the kernel's rules at their finest grain
    (renderer.tile_culls with a 1x1 tile): the distance step for the edges
    near that pixel, stroke and compositing where there is one, the
    crossing step for the edges that span the pixel's row where the sign
    is read (gradient, replace_boundary, the mask union under shape 0's
    stroke), the gradient inside a gradient shape's bbox, and a line where
    it is near."""
    from plainref.models.multigraph import renderer as R
    meta = args[0]
    N = meta.shape[0]
    ops = 0.0
    for i in range(N):
        one = [a[i:i + 1] for a in args]
        c = R.tile_culls(*one, H, W, (1, 1))
        m = one[0][0]
        mode = float(m[R.R_MODE, 0])
        live = c.shape_live[0]                            # [3, H, W]
        n_near = (c.shape_near[0].sum(-1) * live)         # [3, H, W]
        m_near = c.mask_near[0].sum(-1).sum(0) * live[0]  # [H, W]
        ops += float(n_near.sum()) * EDGE_DIST_OPS
        ops += float((n_near > 0).sum()) * K2_SHAPE_OPS
        grad = m[R.R_GRAD, :3] > 0
        rb = (m_near > 0) & (mode == 2)
        sign = grad[:, None, None] & live
        sign[0] |= rb
        rows = c.shape_rows[0].sum(-1)[..., None]         # [3, H, 1]
        ops += float((rows * sign).sum()) * EDGE_CROSS_OPS
        ops += float((grad[:, None, None] * live).sum()) * K2_GRAD_OPS
        ops += float(rb.sum()) * K2_RB_OPS
        if mode > 0:
            ops += float(m_near.sum()) * EDGE_DIST_OPS
            read = (n_near[0] > 0) | rb
            mrows = c.mask_rows[0].sum(-1).sum(0)[:, None]  # [H, 1]
            ops += float((mrows * read).sum()) * EDGE_CROSS_OPS
        ops += float((c.line_near[0] & c.line_live[0]).sum()) * K2_LINE_OPS
        del c
    ops += N * H * W * OUT_OPS
    return k2_bytes(N, W, H), ops
