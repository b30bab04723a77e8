# renderer.py — multigraph scene renderer: transform, prep, plain version of K2.
"""Renders batches of multigraph scenes (``scene.build_scene_batch``) to u8
``[N, S, S, 3]``, S = 8·dpi, with the arithmetic of the JAX package's Pallas
kernel ``render_scene_batch_pallas`` (models/multigraph/renderer_pallas.py):

- ``data_to_pixel_transform`` is the data-to-pixel affine of the
  reference's matplotlib figure, computed as matplotlib computes it;
- ``prepare_scene_batch`` maps the scene to pixel space (y down) and packs
  the kernel's inputs: meta ``[N, 20, 8]``, shape and mask vertices
  ``[N, 3, 64]`` (x and y apart) and lines ``[N, 24, 16]``;
- ``render_prepared`` is the plain PyTorch version of the kernel: pixel
  centres at +0.5, the mask-union SDF, each shape's outline stroke (with
  cut / replace_boundary on shape 0) over its radial gradient fill, the 24
  antialiased decoration segments, and round-half-even to u8;
- ``render_scene_tensors`` renders on the scene tensors' device: the plain
  version on the CPU, the CUDA kernel (``renderer_cuda``) on a card;
  ``render_scene_batch`` uploads a scene batch first.

The plain version evaluates every live shape, mask and line at every pixel.
The kernel culls: by bbox per tile and per pixel row, and per tile it keeps
only the edges and lines within a stroke's reach (``tile_culls`` is that
rule as plain tensor code; ``render_prepared(..., cull=tile_culls(...))``
applies it, so a test can show that it changes no pixel: a culled artist
has zero alpha there).  Multiply-adds that XLA's CPU backend fuses in the
JAX package's renders are written as one rounding (``fma``), and the kernel
uses ``__fmaf_rn`` at the same sites, so the plain version, the kernel and
the Pallas kernel in interpret mode agree byte for byte.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ...ops.raster import (NEAR_MARGIN, _poly_field, edge_spans_rows, fma,
                           seg_near_rect, sqrt_rn, tiles_to_pixels)
from .scene import MAX_LINES, MAX_MASKS, MAX_SHAPES, NV

# figure background: axis('off') hides the axes facecolor patch, so the
# saved image is the white figure facecolor
BG = (255.0, 255.0, 255.0)

NMETA = 20        # meta rows per scene
NCOL = 8          # meta columns (shape, or mask for row 1)
NLIN = 16         # fields per decoration line

# the control's precision: None renders from the float32 prepared data;
# a dtype rounds every prepared float tensor through it first
ROUND_INPUTS = None
# meta rows (each holds one value per shape column, or per mask for row 1)
(R_MODE, R_MASK_VALID, R_VALID, R_BX0, R_BX1, R_BY0, R_BY1, R_LW, R_ALPHA,
 R_GRAD, R_GCX, R_GCY, R_GRMAX, R_GALPHA, R_C0R, R_C0G, R_C0B, R_C1R, R_C1G,
 R_C1B) = range(NMETA)
# line fields
(L_VALID, L_BX0, L_BX1, L_BY0, L_BY1, L_X0, L_Y0, L_X1, L_Y1, L_LW, L_ALPHA,
 L_R, L_G, L_B) = range(14)

TILE = (32, 16)       # the kernel's tile, (width, height) in pixels

# the reference's figure (multigraph_generation/generator.py:488-493): an
# 8x8 in figure at matplotlib's default 100 dpi, the default subplot box
# (rcParams figure.subplot.*), aspect 'equal', data limits ±5
FIG_IN = 8.0
FIG_DPI = 100.0
SUBPLOT_LEFT, SUBPLOT_RIGHT = 0.125, 0.9
SUBPLOT_BOTTOM, SUBPLOT_TOP = 0.11, 0.88
SUBPLOT_SPACE = 0.2
LIM_LO, LIM_HI = -5.0, 5.0


def data_to_pixel_transform(dpi: int):
    """(scale, x0, y0, size_px): x_px = x0 + scale*x; y_disp = y0 + scale*y;
    row = size_px - y_disp.

    The float64 values matplotlib gives the JAX package (which queries
    ``ax.transData``), reproduced step by step: the gridspec cell, the
    shrink to a square box and its centring, the figure transform, the
    composed affine, and the transform of (0, 0) and (1, 0)."""
    fig_px = FIG_IN * FIG_DPI
    # GridSpecBase.get_grid_positions for a 1x1 grid
    cell_w = (SUBPLOT_RIGHT - SUBPLOT_LEFT) / (1 + SUBPLOT_SPACE * 0)
    cell_h = (SUBPLOT_TOP - SUBPLOT_BOTTOM) / (1 + SUBPLOT_SPACE * 0)
    x0, x1 = SUBPLOT_LEFT, SUBPLOT_LEFT + cell_w
    y0, y1 = SUBPLOT_TOP - cell_h, SUBPLOT_TOP
    # Axes.apply_aspect, adjustable 'box': Bbox.shrunk_to_aspect with box
    # and figure aspect 1, then Bbox.anchored at 'C' in the original box
    w, h = x1 - x0, y1 - y0
    side_w, side_h = (w, w) if w <= h else (h, h)
    sx0, sy0, sx1, sy1 = x0, y0, x0 + side_w, y0 + side_h
    dx = (x0 + 0.5 * (w - (sx1 - sx0))) - sx0
    dy = (y0 + 0.5 * (h - (sy1 - sy0))) - sy0
    sx0, sx1, sy0, sy1 = sx0 + dx, sx1 + dx, sy0 + dy, sy1 + dy
    # the axes bbox in display pixels (transFigure scales by fig_px)
    ax_l, ax_b = fig_px * sx0, fig_px * sy0
    ax_w, ax_h = fig_px * sx1 - ax_l, fig_px * sy1 - ax_b
    # transAxes @ transLimits: BboxTransformFrom of the view limits
    inv_w = 1.0 / (LIM_HI - LIM_LO)
    inv_h = 1.0 / (LIM_HI - LIM_LO)
    a = ax_w * inv_w
    e = ax_w * (-LIM_LO * inv_w) + ax_l
    f = ax_h * (-LIM_LO * inv_h) + ax_b
    # affine_transform of (0, 0) and (1, 0), scaled from 100 dpi to dpi
    p0x, p0y = e, f
    p1x = a + e
    k = dpi / FIG_DPI
    return ((p1x - p0x) * k, p0x * k, p0y * k, int(8 * dpi))


def scene_batch_to_torch(batch: Dict[str, np.ndarray], device) -> Dict:
    """A scene batch (numpy, as ``scene.build_scene_batch`` returns it, or
    tensors: a shard of one) as tensors on `device`, dtypes kept."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _f32(v: float) -> float:
    return float(np.float32(v))


def scene_to_pixel_space(scene: Dict, dpi: int):
    """Pixel-space geometry (y down) of a scene batch: vertices, line end
    points, stroke widths in pixels and the culling bboxes (half stroke +
    2 px of antialiasing fringe)."""
    scale, x0, y0, size_px = data_to_pixel_transform(dpi)
    s32, x32, y32 = _f32(scale), _f32(x0), _f32(y0)
    H = float(size_px)

    def to_px(x, y):
        return fma(x, s32, x32), H - fma(y, s32, y32)

    lw_scale = _f32(dpi / 72.0)
    # XLA folds the culling margin's lw·lw_scale·0.5 + 2 into one fused
    # multiply-add by the constant lw_scale·0.5 (exact in float32)
    shape_margin = fma(scene["shape_lw"], lw_scale * 0.5, 2.0)
    line_margin = fma(scene["line_lw"], lw_scale * 0.5, 2.0)
    svx, svy = to_px(scene["shape_verts"][..., 0], scene["shape_verts"][..., 1])
    mvx, mvy = to_px(scene["mask_verts"][..., 0], scene["mask_verts"][..., 1])
    lp = scene["line_pts"]
    l0x, l0y = to_px(lp[..., 0], lp[..., 1])
    l1x, l1y = to_px(lp[..., 2], lp[..., 3])
    shape_lw = scene["shape_lw"] * lw_scale
    line_lw = scene["line_lw"] * lw_scale

    def bbox(vx, vy, valid, margin):
        big = torch.full_like(margin, 1e9)
        return (torch.where(valid, vx.amin(-1), big) - margin,
                torch.where(valid, vx.amax(-1), -big) + margin,
                torch.where(valid, vy.amin(-1), big) - margin,
                torch.where(valid, vy.amax(-1), -big) + margin)

    return {
        "svx": svx, "svy": svy, "mvx": mvx, "mvy": mvy,
        "l0x": l0x, "l0y": l0y, "l1x": l1x, "l1y": l1y,
        "shape_lw": shape_lw, "line_lw": line_lw,
        "shape_bbox": bbox(svx, svy, scene["shape_valid"], shape_margin),
        "line_bbox": bbox(torch.stack([l0x, l1x], -1),
                          torch.stack([l0y, l1y], -1), scene["line_valid"],
                          line_margin),
    }


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 ``jnp.hypot`` of finite legs: max·sqrt(1 + (min/max)²), the
    square fused into the add as XLA fuses it (an invalid shape's all-zero
    outline gives max = 0)."""
    x, y = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    r = lo / torch.where(hi == 0, torch.ones_like(hi), hi)
    return torch.where(hi == 0, hi, hi * sqrt_rn(fma(r, r, 1.0)))


def _vertex_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis (NV = 64 vertices) in XLA's CPU order: the
    reduction is split into two windows of 32, each summed in order, and
    the two partial sums are added."""
    def seq(w):
        acc = w[..., 0]
        for i in range(1, w.shape[-1]):
            acc = acc + w[..., i]
        return acc
    half = v.shape[-1] // 2
    return (seq(v[..., :half]) + seq(v[..., half:])) / float(v.shape[-1])


def prepare_scene_batch(scene: Dict, dpi: int):
    """Scene tensors ``[N, ...]`` -> the kernel's inputs (meta, svx, svy,
    mvx, mvy, lin), as the Pallas kernel's prep packs them."""
    data = scene_to_pixel_space(scene, dpi)
    N = scene["shape_valid"].shape[0]
    dev = data["svx"].device
    f = lambda b: b.to(torch.float32)
    meta = torch.zeros((N, NMETA, NCOL), dtype=torch.float32, device=dev)
    meta[:, R_MODE, 0] = f(scene["mask_mode"])
    meta[:, R_MASK_VALID, :MAX_MASKS] = f(scene["mask_valid"])
    meta[:, R_VALID, :MAX_SHAPES] = f(scene["shape_valid"])
    for r, v in zip((R_BX0, R_BX1, R_BY0, R_BY1), data["shape_bbox"]):
        meta[:, r, :MAX_SHAPES] = v
    meta[:, R_LW, :MAX_SHAPES] = data["shape_lw"]
    meta[:, R_ALPHA, :MAX_SHAPES] = scene["shape_alpha"]
    svx, svy = data["svx"], data["svy"]
    cx, cy = _vertex_mean(svx), _vertex_mean(svy)
    rmax = _hypot(svx - cx[..., None], svy - cy[..., None]).amax(-1) + 1e-6
    meta[:, R_GRAD, :MAX_SHAPES] = f(scene["grad_valid"])
    meta[:, R_GCX, :MAX_SHAPES] = cx
    meta[:, R_GCY, :MAX_SHAPES] = cy
    meta[:, R_GRMAX, :MAX_SHAPES] = rmax
    meta[:, R_GALPHA, :MAX_SHAPES] = scene["grad_alpha"]
    for c in range(3):
        meta[:, R_C0R + c, :MAX_SHAPES] = scene["grad_c0"][..., c]
        meta[:, R_C1R + c, :MAX_SHAPES] = scene["grad_c1"][..., c]

    lin = torch.zeros((N, MAX_LINES, NLIN), dtype=torch.float32, device=dev)
    lin[..., L_VALID] = f(scene["line_valid"])
    for j, v in enumerate(data["line_bbox"]):
        lin[..., L_BX0 + j] = v
    lin[..., L_X0], lin[..., L_Y0] = data["l0x"], data["l0y"]
    lin[..., L_X1], lin[..., L_Y1] = data["l1x"], data["l1y"]
    lin[..., L_LW] = data["line_lw"]
    lin[..., L_ALPHA] = scene["line_alpha"]
    for c in range(3):
        lin[..., L_R + c] = scene["line_color"][..., c]
    return (meta.contiguous(), svx.contiguous(), svy.contiguous(),
            data["mvx"].contiguous(), data["mvy"].contiguous(),
            lin.contiguous())


class Cull(NamedTuple):
    """What the kernel keeps (``tile_culls``).  Per pixel, bool
    ``[N, 3, H, W]`` and ``[N, 24, H, W]``: ``shape_live`` and
    ``line_live``, the pixel centres inside the artist's bbox.  Per tile,
    bool: ``shape_near`` and ``mask_near`` ``[N, 3, nty, ntx, 64]`` (the
    edges within the stroke's reach of the tile), ``shape_rows`` and
    ``mask_rows`` ``[N, 3, nty, 64]`` (the edges whose crossing condition
    can hold on the tile's rows), ``line_near`` ``[N, 24, nty, ntx]``.
    ``tile``: (tw, th)."""
    shape_live: torch.Tensor
    line_live: torch.Tensor
    shape_near: torch.Tensor
    mask_near: torch.Tensor
    shape_rows: torch.Tensor
    mask_rows: torch.Tensor
    line_near: torch.Tensor
    tile: tuple


def stroke_reach(lw):
    """lw/2 + 0.5: the distance from which ``_band`` is 0."""
    return lw * 0.5 + 0.5


def tile_culls(meta, svx, svy, mvx, mvy, lin, H: int, W: int, tile=TILE):
    """The kernel's culls on prepared data, as plain tensor code -> Cull.

    A shape or line is live in a tile its bbox reaches (pixel edges, as the
    Pallas kernel tests it) and at a pixel whose centre lies in the bbox;
    masks follow shape 0, which alone reads them.  Per (tw, th) tile the
    rectangle is that of its pixel centres.  An edge is near if
    ``seg_near_rect`` holds with R = lw/2 + 0.5 + NEAR_MARGIN (for a mask
    the lw of shape 0, which strokes it), a line likewise with its own lw;
    an edge counts for the crossing test of a tile row if
    ``edge_spans_rows`` holds on the row's pixel centres.  tile=(1, 1)
    gives the rule per pixel."""
    tw, th = tile
    dev = meta.device
    tx0 = torch.arange(0, W, tw, dtype=torch.float32, device=dev)
    ty0 = torch.arange(0, H, th, dtype=torch.float32, device=dev)[:, None]
    cx, cy = tx0 + tw * 0.5, ty0 + th * 0.5              # [ntx], [nty, 1]
    hw, hh = tw * 0.5 - 0.5, th * 0.5 - 0.5
    px = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    py = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None]
    e = lambda v: v[..., None, None]                     # over tiles / pixels

    def bbox(valid, bx0, bx1, by0, by1):
        """-> (hit per tile [.., nty, ntx], live per pixel [.., H, W])."""
        hit = e(valid) & (e(bx1) >= tx0) & (e(bx0) <= tx0 + tw) & \
            (e(by1) >= ty0) & (e(by0) <= ty0 + th)
        live = e(valid) & (px >= e(bx0)) & (px <= e(bx1)) & \
            (py >= e(by0)) & (py <= e(by1))
        return hit, live

    def edges(vx, vy, hit, lw):
        """Outlines vx/vy [N, 3, 64], hit [N, 3, nty, ntx], lw [N, 3] ->
        (near [N, 3, nty, ntx, 64], rows [N, 3, nty, 64])."""
        nxt = list(range(1, NV)) + [0]
        t = lambda a: a[:, :, None, None]                # edges over tiles
        R = (stroke_reach(lw) + NEAR_MARGIN)[:, :, None, None, None]
        near = hit[..., None] & seg_near_rect(
            t(vx), t(vy), t(vx[..., nxt]), t(vy[..., nxt]), cx[:, None],
            cy[..., None], hw, hh, R)
        live_y = hit.any(-1)
        rows = live_y[..., None] & edge_spans_rows(
            vy[:, :, None], vy[:, :, None, nxt], ty0 + 0.5, ty0 + (th - 0.5))
        return near, rows

    m = lambda r: meta[:, r, :MAX_SHAPES]
    s_hit, s_live = bbox(m(R_VALID) > 0.0, m(R_BX0), m(R_BX1), m(R_BY0),
                         m(R_BY1))
    s_near, s_rows = edges(svx, svy, s_hit, m(R_LW))
    m_on = (meta[:, R_MODE, :1] > 0.0) & \
        (meta[:, R_MASK_VALID, :MAX_MASKS] > 0.0)
    m_hit = e(m_on) & s_hit[:, :1]
    m_near, m_rows = edges(mvx, mvy, m_hit,
                           meta[:, R_LW, :1].expand(-1, MAX_MASKS))
    q = lambda f: lin[..., f]
    l_hit, l_live = bbox(q(L_VALID) > 0.0, q(L_BX0), q(L_BX1), q(L_BY0),
                         q(L_BY1))
    l_near = l_hit & seg_near_rect(
        e(q(L_X0)), e(q(L_Y0)), e(q(L_X1)), e(q(L_Y1)), cx, cy, hw, hh,
        e(stroke_reach(q(L_LW)) + NEAR_MARGIN))
    return Cull(s_live, l_live, s_near, m_near, s_rows, m_rows, l_near, tile)


def _poly_sd(px, py, vx, vy, near=None, rows=None):
    """Signed distance (negative inside) of every pixel to each polygon:
    px/py ``[n, H, W]``, vx/vy ``[n, NV]`` -> ``[n, H, W]``.  `near` and
    `rows` as in ``ops.raster._poly_field``."""
    d2, cross = _poly_field(px, py, vx, vy, NV, near, rows)
    dist = sqrt_rn(d2)
    return torch.where((cross % 2) == 1, -dist, dist)


def _band(lw, alpha, d):
    return alpha * torch.clamp(lw * 0.5 + 0.5 - d, 0.0, 1.0)


def render_prepared(meta, svx, svy, mvx, mvy, lin, H: int, W: int,
                    cull: Optional[Cull] = None):
    """The plain version of the kernel on prepared data -> u8
    ``[N, H, W, 3]``.  With `cull` (``tile_culls`` of the same data) shapes
    and lines are composited only where they are live and the edge loops
    run over the kept edges only, as in the kernel; the result is the
    same."""
    N = meta.shape[0]
    dev = meta.device
    out = torch.empty((N, H, W, 3), dtype=torch.uint8, device=dev)
    # scenes per pass: bounds the pass's temporaries to ~2^24 pixels each
    chunk = max(1, (1 << 24) // (H * W))
    for s in range(0, N, chunk):
        e = s + chunk
        sub = None if cull is None else Cull(
            *(t[s:e] for t in cull[:-1]), cull.tile)
        out[s:e] = _render_chunk(meta[s:e], svx[s:e], svy[s:e], mvx[s:e],
                                 mvy[s:e], lin[s:e], H, W, sub)
    return out


def _render_chunk(meta, svx, svy, mvx, mvy, lin, H: int, W: int, cull):
    N = meta.shape[0]

    def edge_culls(near, rows, idx, j):
        if cull is None:
            return None, None
        return (lambda k: tiles_to_pixels(near[idx, j, :, :, k], cull.tile,
                                          H, W),
                lambda k: tiles_to_pixels(rows[idx, j, :, k], cull.tile, H, W))

    dev = meta.device
    px = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5).expand(H, W)
    py = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None] \
        .expand(H, W)
    acc = [torch.full((N, H, W), BG[c], device=dev) for c in range(3)]
    mode = meta[:, R_MODE, 0]

    msk = torch.full((N, H, W), 1e9, device=dev)
    for m in range(MAX_MASKS):
        idx = torch.nonzero((mode > 0.0) & (meta[:, R_MASK_VALID, m] > 0.0)
                            ).squeeze(1)
        if idx.numel():
            n = idx.numel()
            msk[idx] = torch.minimum(msk[idx], _poly_sd(
                px.expand(n, H, W), py.expand(n, H, W), mvx[idx, m],
                mvy[idx, m], *edge_culls(cull and cull.mask_near,
                                         cull and cull.mask_rows, idx, m)))

    for s in range(MAX_SHAPES):
        idx = torch.nonzero(meta[:, R_VALID, s] > 0.0).squeeze(1)
        if idx.numel() == 0:
            continue
        n = idx.numel()
        m = meta[idx, :, s, None, None]                  # [n, 20, 1, 1]
        pxn, pyn = px.expand(n, H, W), py.expand(n, H, W)
        sd = _poly_sd(pxn, pyn, svx[idx, s], svy[idx, s],
                      *edge_culls(cull and cull.shape_near,
                                  cull and cull.shape_rows, idx, s))
        lw, alpha = m[:, R_LW], m[:, R_ALPHA]
        a = _band(lw, alpha, torch.abs(sd))
        sub = [c[idx] for c in acc]
        before = list(sub)
        if s == 0:
            hm = (mode[idx] > 0.0).to(torch.float32)[:, None, None]
            a = a * (1.0 - hm * (msk[idx] <= 0.0).to(torch.float32))
        g_on = m[:, R_GRAD] > 0.0
        if bool(g_on.any()):
            dx = pxn - m[:, R_GCX]
            dy = pyn - m[:, R_GCY]
            tfrac = torch.clamp(sqrt_rn(fma(dx, dx, dy * dy)) / m[:, R_GRMAX],
                                0.0, 1.0)
            ga = (sd < 0.0).to(torch.float32) * m[:, R_GALPHA]
            for c in range(3):
                col = fma(m[:, R_C0R + c], 1 - tfrac, m[:, R_C1R + c] * tfrac)
                sub[c] = torch.where(g_on, fma(sub[c], 1 - ga, col * ga),
                                     sub[c])
        for c in range(3):
            sub[c] = sub[c] * (1.0 - a)
        if s == 0:
            rb = (mode[idx] == 2.0)[:, None, None]
            if bool(rb.any()):
                ma = _band(lw, alpha, torch.abs(msk[idx]))
                ma = ma * (sd < 0.0).to(torch.float32)
                for c in range(3):
                    sub[c] = torch.where(rb, sub[c] * (1.0 - ma), sub[c])
        for c in range(3):
            if cull is not None:
                sub[c] = torch.where(cull.shape_live[idx, s], sub[c],
                                     before[c])
            acc[c][idx] = sub[c]

    for k in range(MAX_LINES):
        idx = torch.nonzero(lin[:, k, L_VALID] > 0.0).squeeze(1)
        if idx.numel() == 0:
            continue
        n = idx.numel()
        q = lin[idx, k, :, None, None]                   # [n, 16, 1, 1]
        x0, y0 = q[:, L_X0], q[:, L_Y0]
        ex = q[:, L_X1] - x0
        ey = q[:, L_Y1] - y0
        inv = 1.0 / (fma(ex, ex, ey * ey) + 1e-9)
        pxn, pyn = px.expand(n, H, W), py.expand(n, H, W)
        t = torch.clamp(fma(pxn - x0, ex, (pyn - y0) * ey) * inv, 0.0, 1.0)
        dx = pxn - fma(t, ex, x0)
        dy = pyn - fma(t, ey, y0)
        a = _band(q[:, L_LW], q[:, L_ALPHA], sqrt_rn(fma(dx, dx, dy * dy)))
        if cull is not None:
            near = tiles_to_pixels(cull.line_near[idx, k], cull.tile, H, W) \
                & cull.line_live[idx, k]
            a = torch.where(near, a, torch.zeros_like(a))
        for c in range(3):
            acc[c][idx] = fma(acc[c][idx], 1.0 - a, q[:, L_R + c] * a)

    img = torch.stack(acc, dim=-1)
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def render_scene_tensors(scene: Dict, dpi: int) -> torch.Tensor:
    """Render scene tensors (``scene_batch_to_torch``'s output) on their
    device -> u8 ``[N, S, S, 3]``: ``prepare_scene_batch``, then the plain
    version on the CPU or the CUDA kernel on a card.  Nothing is copied
    from or to the host: the mg generator captures this into a CUDA graph
    (utils/graphs.py)."""
    prepared = prepare_scene_batch(scene, dpi)
    if ROUND_INPUTS is not None:
        prepared = [t.to(ROUND_INPUTS).to(t.dtype) if t.is_floating_point()
                    else t for t in prepared]
    S = data_to_pixel_transform(dpi)[3]
    return render_prepared(*prepared, S, S)


def render_scene_batch(batch, dpi: int, device) -> torch.Tensor:
    """Render a scene batch (``scene_batch_to_torch``'s input) on
    `device` -> u8 ``[N, S, S, 3]`` there: the upload, then
    ``render_scene_tensors``, eagerly."""
    return render_scene_tensors(scene_batch_to_torch(batch, device), dpi)
