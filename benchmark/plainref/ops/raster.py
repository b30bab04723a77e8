# raster.py — plain PyTorch version of the RPM frame rasterizer (K1).
"""Renders batches of ElementState frames to u8 ``[N, H, W, 3]``.

This is the plain tensor version of the hand-written CUDA kernel in
``csrc/raster.cu`` (which ``ops/raster_cuda.py`` launches) and computes
what the JAX package's Pallas kernel (``ops/raster_pallas.py``) and its
jnp ``render_frame`` compute in 'fast' antialias mode:

- ``prepare_render_data`` grid-snaps centres, truncates angles, builds each
  element's 64-vertex outline (two parts for 'plus') and packs 20 meta
  fields per element, exactly as the Pallas kernel's prep does;
- ``render_frames`` composites the elements in painter's order over a white
  canvas: polygon edge loops (min distance + crossing parity), analytic
  circle and crescent, hard fill in the element colour, a black AA stroke
  ``clip((ceil(t/2) + 1.28 - d) / 1.28)``, the 3x3 wrap-copy gate, grid
  lines, and round-and-clip to u8.

Beside the kernel's path stand the rest of the JAX package's ``render_frame``
surface (``render_batch`` / ``render_frame`` below):

- ``honor_flip`` mirrors the outlines (two negations in ``element_verts``);
  it changes vertex tables only, so the kernel serves it unchanged;
- 'hq' snaps centres at the target size, scales centres, sizes and strokes
  by `scale`, renders 'fast' with no grid at ``W*scale x H*scale`` through
  ``raster_cuda.render_frames`` (on a card that is a kernel launch at the
  supersampled size), downsamples (scale 2: the two matmuls of
  ``lanczos4_down2_weights``; else lanczos3 without antialias,
  ops/resize.py), then draws the grid lines at the target size;
- 'soft' (the polygon fill alpha ``0.5 * (1 - erf(sd / (sigma*sqrt(2))))``
  of the signed distance), an outline colour other than black and a
  background other than white go through ``composite_element``, plain
  tensor code on the tensors' device.  No hand-written kernel computes
  these: the JAX package has them in jnp outside its Pallas kernel, which
  like the CUDA kernel knows hard fills, black strokes and a white canvas
  only.

``render_prepared`` evaluates every element at every pixel (no culling) and
keeps the kernel's operation order, so the two agree byte for byte.  The kernel's
culls are here as plain tensor code too: ``edge_records`` (what the kernel
computes once per edge), ``seg_near_rect`` (its conservative
segment-to-rectangle test) and ``tile_culls`` (the rows, columns and edges
it keeps per tile).  ``render_prepared(..., cull=tile_culls(...))`` applies
them, so a test can show that they move no byte; without ``cull`` nothing
is culled.

Fused multiply-adds.  XLA's CPU backend contracts ``a*b + c`` patterns
into one fused multiply-add, and the JAX package's renders (jnp and Pallas
interpret mode alike) carry those roundings: a pixel whose exact value is
k + 0.5 lands on one side with the FMA and on the other without it.  The
sites XLA contracts (the edge-projection dot product, the distance
components, the squared distances, the crossing abscissa and the outline
rotation) use ``fma`` here and ``__fmaf_rn`` in the kernel; nothing else
is contracted.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import constant
from ..utils.state import ElementState
from . import geometry as G
from .resize import resize

# the control's precision: None renders from the float32 prepared data;
# a dtype rounds the prepared frames' float tensors through it first
ROUND_INPUTS = None

NMETA = 20
(M_VALID, M_FILL, M_STROKE, M_R, M_G, M_B, M_CIRCLE, M_CRESCENT, M_CX, M_CY,
 M_ROUT, M_ICX, M_ICY, M_RIN, M_HASP1, M_BX0, M_BX1, M_BY0, M_BY1,
 M_SMALL) = range(NMETA)
SMALL_V = 8
PLAIN_CHUNK = 64      # frames per compositing pass: bounds its memory
TILE = (32, 32)       # the kernel's tile, (width, height) in pixels
NEAR_MARGIN = 0.5     # px added to a stroke's reach in the near-edge test
STROKE_FRINGE = float(np.float32(0.28))
DEG2RAD = float(np.float32(math.pi / 180))


def _unit_tables(device):
    """geometry.VERTS_UNIT / NV as tensors on `device` (built once each)."""
    return (constant("verts_unit", device, lambda: G.VERTS_UNIT),
            constant("nv", device, lambda: G.NV.astype(np.int64)))


def fma(a, b, c):
    """float32 a*b + c with one rounding, as a fused multiply-add gives
    (the float32 product is exact in float64)."""
    d = lambda x: x.double() if torch.is_tensor(x) else float(x)
    return (d(a) * d(b) + d(c)).float()


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device: torch's
    float32 ``sqrt`` on a CPU with AVX-512 is off by one ulp for some
    inputs, and a float64 root rounded once to float32 never is."""
    return torch.sqrt(x.double()).float()


def cos_sin(rad: torch.Tensor):
    """float32 cos/sin, correctly rounded from float64 so that every
    device gives the same bits (torch's float32 kernels differ between CPU
    and CUDA in the last place)."""
    r = rad.double()
    return torch.cos(r).float(), torch.sin(r).float()


def grid_snap(states: ElementState, W: int, H: int, use_grid, grid_size: int):
    """Grid-snapped centres and truncated angles (the JAX package's
    render-time snap, reference src/generator.py:93-105)."""
    ug = use_grid.reshape(use_grid.shape + (1,))
    cell_w = W / grid_size
    cell_h = H / grid_size
    col = torch.clamp(torch.floor(states.cx / cell_w), 0, grid_size - 1)
    row = torch.clamp(torch.floor(states.cy / cell_h), 0, grid_size - 1)
    cx = torch.where(ug, torch.trunc((col + 0.5) * cell_w), states.cx)
    cy = torch.where(ug, torch.trunc((row + 0.5) * cell_h), states.cy)
    return cx, cy, torch.trunc(states.angle)


def element_verts(kind, size, angle, cx, cy, flip_h=None, flip_v=None):
    """Absolute integer-rounded outlines ``[..., NPART, V]`` (x and y) and
    the vertex counts ``[..., NPART]``.  `flip_h` / `flip_v` (bool, or None
    for no flip: the pipeline never renders mirror state) negate the
    rotated unit outline's x / y before it is scaled and moved."""
    unit_t, nv_t = _unit_tables(kind.device)
    unit = unit_t[kind]                               # [..., P, V, 2]
    ca, sa = cos_sin(-angle * DEG2RAD)
    ca = ca[..., None, None]
    sa = sa[..., None, None]
    x, y = unit[..., 0], unit[..., 1]
    xr = fma(x, ca, -(y * sa))
    yr = fma(x, sa, y * ca)
    if flip_h is not None:
        xr = torch.where(flip_h[..., None, None], -xr, xr)
    if flip_v is not None:
        yr = torch.where(flip_v[..., None, None], -yr, yr)
    half = (size * 0.5)[..., None, None]
    vx = torch.round(fma(xr, half, cx[..., None, None]))
    vy = torch.round(fma(yr, half, cy[..., None, None]))
    return vx, vy, nv_t[kind]


def prepare_render_data(states: ElementState, W: int, H: int, use_grid,
                        grid_size: int = 3, honor_flip: bool = False):
    """Batched prep: states ``[N, E]``, use_grid bool ``[N]`` ->
    meta f32 ``[N, E, 20]``, vx/vy f32 ``[N, E, 2, 64]``.  With
    `honor_flip` the outlines are mirrored as the states' flip_h / flip_v
    say."""
    cx, cy, angle = grid_snap(states, W, H, use_grid, grid_size)
    return prepare_elements(states, cx, cy, angle, honor_flip)


def prepare_elements(states: ElementState, cx, cy, angle,
                     honor_flip: bool = False):
    """The prep after the grid snap: centres and angles as given."""
    flips = (states.flip_h, states.flip_v) if honor_flip else (None, None)
    vx, vy, nv = element_verts(states.kind, states.size, angle, cx, cy, *flips)
    half = states.size * 0.5
    r_out = torch.clamp(torch.round(half), min=1.0)
    r_in = torch.round(r_out * G.CRESCENT_INNER_R)
    off = torch.round(r_out * G.CRESCENT_OFFSET)
    ca, sa = cos_sin(-angle * DEG2RAD)
    icx = cx + torch.round(off * ca)
    icy = cy + torch.round(off * sa)

    is_circle = states.kind == G.CIRCLE
    is_crescent = states.kind == G.CRESCENT
    analytic = is_circle | is_crescent
    stroke_w = torch.clamp(torch.round(states.stroke), min=1.0)
    stroke_band = torch.where(stroke_w <= 1.0, torch.ones_like(stroke_w),
                              torch.ceil(stroke_w * 0.5) + 1.0)
    margin = stroke_w + 2.0
    fx = vx.flatten(-2)
    fy = vy.flatten(-2)
    bx0 = torch.where(analytic, cx - r_out, fx.amin(-1)) - margin
    bx1 = torch.where(analytic, cx + r_out, fx.amax(-1)) + margin
    by0 = torch.where(analytic, cy - r_out, fy.amin(-1)) - margin
    by1 = torch.where(analytic, cy + r_out, fy.amax(-1)) + margin
    f = lambda b: b.to(torch.float32)
    meta = torch.stack([
        f(states.valid), f(states.fill & states.valid), stroke_band,
        states.color[..., 0], states.color[..., 1], states.color[..., 2],
        f(is_circle), f(is_crescent), cx, cy, r_out, icx, icy, r_in,
        f(nv[..., 1] > 0), bx0, bx1, by0, by1, f(nv[..., 0] <= SMALL_V),
    ], dim=-1)
    return meta.contiguous(), vx.contiguous(), vy.contiguous()


def _circle_dist(px, py, cx, cy, r):
    dx = px - cx
    dy = py - cy
    return sqrt_rn(fma(dx, dx, dy * dy)) - r


def _stroke(band, d):
    """Stroke alpha at distance d from the outline.  `band` is the meta's
    ``ceil(t/2) + 1`` (1 for t = 1); the ramp is the jnp renderer's
    ``clip((r_full + 1.28 - d) / 1.28)`` with r_full = band - 1, which in
    float32 is not ``band + 0.28`` from band 4 (strokes 5 and 6) on."""
    return torch.clamp(((band - 1.0) + 1.28 - d) * (1.0 / 1.28), 0.0, 1.0)


def edge_records(vx, vy, n_edges: int):
    """What the kernel computes once per edge (csrc/poly.cuh, EdgeRec), for
    the closed outline of the first `n_edges` vertices: vx/vy ``[..., V]``
    -> dict of ax, ay, bx, by, ex, ey, inv, slope, each ``[..., n_edges]``."""
    nxt = list(range(1, n_edges)) + [0]
    ax, ay = vx[..., :n_edges], vy[..., :n_edges]
    bx, by = ax[..., nxt], ay[..., nxt]
    ex = bx - ax
    ey = by - ay
    inv = 1.0 / (fma(ex, ex, ey * ey) + 1e-9)
    safe_ey = torch.where(ey == 0.0, torch.ones_like(ey), ey)
    return {"ax": ax, "ay": ay, "bx": bx, "by": by, "ex": ex, "ey": ey,
            "inv": inv, "slope": ex / safe_ey}


def edge_spans_rows(ay, by, ymin, ymax):
    """May an edge's crossing condition ``(ay > py) != (by > py)`` hold at
    some py in [ymin, ymax]?  Exact: no margin."""
    return ~(((ay > ymax) & (by > ymax)) | ((ay <= ymin) & (by <= ymin)))


def seg_near_rect(ax, ay, bx, by, cx, cy, hw, hh, R):
    """Conservative test (csrc/poly.cuh, seg_near_rect): False only where
    the segment a..b is farther than R from the rectangle with centre
    (cx, cy) and half extents (hw, hh).  Separating axes x, y and the
    segment's normal, the rectangle grown by R on each; float32, in the
    kernel's operation order.  All arguments broadcast."""
    off_x = (torch.minimum(ax, bx) > cx + hw + R) | \
        (torch.maximum(ax, bx) < cx - hw - R)
    off_y = (torch.minimum(ay, by) > cy + hh + R) | \
        (torch.maximum(ay, by) < cy - hh - R)
    ex, ey = bx - ax, by - ay
    s = torch.abs(ey * (cx - ax) - ex * (cy - ay)) - \
        (torch.abs(ey) * hw + torch.abs(ex) * hh)
    return ~off_x & ~off_y & \
        ((s <= 0.0) | (s * s <= R * R * (ex * ex + ey * ey)))


class Cull(NamedTuple):
    """What the kernel keeps (``tile_culls``).  ``live`` bool
    ``[N, E, H, W]``: pixels inside the element's bbox and wrap gate, in the
    wrapped coordinates it is evaluated at.  ``near`` bool
    ``[N, E, nty, ntx, 2, V]``: per tile and outline part, the edges within
    the stroke's reach.  ``rows`` bool ``[N, E, nty, 2, V]``: per tile row,
    the edges whose crossing condition can hold there.  ``tile``: (tw, th).
    V is 64, or 8 when every outline has at most 8 edges."""
    live: torch.Tensor
    near: Optional[torch.Tensor]
    rows: Optional[torch.Tensor]
    tile: tuple


def tiles_to_pixels(t: torch.Tensor, tile, H: int, W: int) -> torch.Tensor:
    """A per-tile mask ``[n, nty, ntx]`` or ``[n, nty]`` per pixel,
    ``[n, H, W]`` or ``[n, H, 1]``; `tile` is (tw, th)."""
    tw, th = tile
    t = t.repeat_interleave(th, 1)[:, :H]
    if t.dim() == 2:
        return t[:, :, None]
    return t.repeat_interleave(tw, 2)[:, :, :W]


def _wrapped(p, c, size: int):
    return c + torch.remainder(p - c + size * 0.5, float(size)) - size * 0.5


def _tile_range(v, ok, t: int):
    """Min and max of v ``[..., L]`` over the entries where `ok`, per run of
    t entries -> two ``[..., ceil(L / t)]`` (+inf / -inf for none)."""
    L = v.shape[-1]
    pad = (-L) % t
    inf = torch.full_like(v, math.inf)
    lo = torch.nn.functional.pad(torch.where(ok, v, inf), (0, pad),
                                 value=math.inf)
    hi = torch.nn.functional.pad(torch.where(ok, v, -inf), (0, pad),
                                 value=-math.inf)
    shape = v.shape[:-1] + (-1, t)
    return lo.reshape(shape).amin(-1), hi.reshape(shape).amax(-1)


def tile_culls(meta, vx, vy, W: int, H: int, tile=TILE, edges: bool = True):
    """The kernel's culls on prepared data, as plain tensor code -> Cull.

    Rows and columns: an element is evaluated at the wrapped coordinates
    (pxw, pyw); it is live where these lie inside its bbox and the 3x3 wrap
    gate is open.  Edges, per (tw, th) tile: the rectangle is the extent of
    the tile's live wrapped coordinates; an edge is near if
    ``seg_near_rect`` holds with R = band + 0.28 + NEAR_MARGIN, and counts
    for the crossing test of a tile row if ``edge_spans_rows`` holds on the
    row's live wrapped y.  tile=(1, 1) gives the rule per pixel."""
    tw, th = tile
    dev = meta.device
    m = lambda i: meta[..., i, None]                     # [N, E, 1]
    px = torch.arange(W, dtype=torch.float32, device=dev)
    py = torch.arange(H, dtype=torch.float32, device=dev)
    pxw = _wrapped(px, m(M_CX), W)                       # [N, E, W]
    pyw = _wrapped(py, m(M_CY), H)                       # [N, E, H]
    valid = m(M_VALID) > 0.0
    row_ok = valid & (torch.abs(py - pyw) <= float(H)) & \
        (pyw >= m(M_BY0)) & (pyw <= m(M_BY1))
    col_in = (torch.abs(px - pxw) <= float(W)) & \
        (pxw >= m(M_BX0)) & (pxw <= m(M_BX1))
    live = row_ok[..., :, None] & col_in[..., None, :]
    if not edges:
        return Cull(live, None, None, tile)
    ymin, ymax = _tile_range(pyw, row_ok, th)            # [N, E, nty]
    xmin, xmax = _tile_range(pxw, col_in, tw)            # [N, E, ntx]
    is_poly = ~((meta[..., M_CIRCLE] > 0.0) | (meta[..., M_CRESCENT] > 0.0))
    small = meta[..., M_SMALL] > 0.0
    V = SMALL_V if bool((small | ~is_poly).all()) else G.MAX_VERTS
    k = torch.arange(V, device=dev)
    n0 = torch.where(small, SMALL_V, G.MAX_VERTS) * is_poly
    n1 = (meta[..., M_HASP1] > 0.0) * is_poly * SMALL_V
    nv = torch.stack([n0, n1], -1)[..., None]            # [N, E, 2, 1]
    has = k < nv                                         # [N, E, 2, V]
    nxt = torch.where(k + 1 < nv, k + 1, 0).expand(has.shape)
    ax, ay = vx[..., :V], vy[..., :V]
    bx, by = ax.gather(-1, nxt), ay.gather(-1, nxt)
    t = lambda a: a[:, :, None, None]                    # edges over tiles
    rows = has[:, :, None] & edge_spans_rows(
        ay[:, :, None], by[:, :, None], ymin[..., None, None],
        ymax[..., None, None])                           # [N, E, nty, 2, V]
    e = lambda a: a[..., None, None]                     # tiles over edges
    cx = e((xmin[:, :, None, :] + xmax[:, :, None, :]) * 0.5)
    cy = e((ymin[:, :, :, None] + ymax[:, :, :, None]) * 0.5)
    hw = e((xmax[:, :, None, :] - xmin[:, :, None, :]) * 0.5)
    hh = e((ymax[:, :, :, None] - ymin[:, :, :, None]) * 0.5)
    R = e((meta[..., M_STROKE] + STROKE_FRINGE)[:, :, None, None]) \
        + NEAR_MARGIN
    hit = e(torch.isfinite(xmin)[:, :, None, :] &
            torch.isfinite(ymin)[:, :, :, None])
    near = t(has) & hit & seg_near_rect(t(ax), t(ay), t(bx), t(by), cx, cy,
                                        hw, hh, R)
    return Cull(live, near, rows, tile)


def _poly_field(pxw, pyw, vx, vy, n_edges: int, near=None, rows=None):
    """Edge loop over the first `n_edges` vertices (closing back to vertex
    0): min squared distance and crossing count.  pxw/pyw ``[N, H, W]``,
    vx/vy ``[N, V]``.  `near(k)` and `rows(k)`, where given, return the
    pixels ``[N, H, W]`` at which edge k takes part in the distance and in
    the crossing count (the kernel's culls); without them every edge does
    everywhere."""
    d2 = torch.full_like(pxw, math.inf)
    cross = torch.zeros(pxw.shape, dtype=torch.int32, device=pxw.device)
    for k in range(n_edges):
        kb = 0 if k == n_edges - 1 else k + 1
        ax, ay = vx[:, k, None, None], vy[:, k, None, None]
        bx, by = vx[:, kb, None, None], vy[:, kb, None, None]
        ex = bx - ax
        ey = by - ay
        inv = 1.0 / (fma(ex, ex, ey * ey) + 1e-9)
        pxe = pxw - ax
        pye = pyw - ay
        t = torch.clamp(fma(pxe, ex, pye * ey) * inv, 0.0, 1.0)
        dx = fma(-t, ex, pxe)
        dy = fma(-t, ey, pye)
        dk = fma(dx, dx, dy * dy)
        if near is not None:
            dk = torch.where(near(k), dk, torch.full_like(dk, math.inf))
        d2 = torch.minimum(d2, dk)
        cond = (ay > pyw) != (by > pyw)
        safe_ey = torch.where(ey == 0.0, torch.ones_like(ey), ey)
        xint = fma(pyw - ay, ex / safe_ey, ax)
        hit = cond & (pxw < xint)
        if rows is not None:
            hit = hit & rows(k)
        cross += hit.to(torch.int32)
    return d2, cross


def render_frames(states: ElementState, W: int, H: int, use_grid,
                  grid_size: int = 3, honor_flip: bool = False) -> torch.Tensor:
    """Plain tensor render: states ``[N, E]``, use_grid bool ``[N]`` ->
    u8 ``[N, H, W, 3]``."""
    meta, vx, vy = prepare_render_data(states, W, H, use_grid, grid_size,
                                       honor_flip)
    if ROUND_INPUTS is not None:
        meta, vx, vy = (t.to(ROUND_INPUTS).to(t.dtype) for t in (meta, vx, vy))
    N = meta.shape[0]
    out = torch.empty((N, H, W, 3), dtype=torch.uint8, device=meta.device)
    for s in range(0, N, PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        out[s:e] = render_prepared(meta[s:e], vx[s:e], vy[s:e],
                                   use_grid[s:e], W, H, grid_size)
    return out


def render_prepared(meta, vx, vy, use_grid, W: int, H: int, grid_size: int,
                    cull: Optional[Cull] = None):
    """The compositing pass on prepared data (meta ``[N, E, 20]``, vx/vy
    ``[N, E, 2, 64]``) -> u8 ``[N, H, W, 3]``.  With `cull`
    (``tile_culls`` of the same data) an element is composited only where
    it is live and its edge loops run over the kept edges only, as in the
    kernel; the result is the same."""
    N, E = meta.shape[:2]
    dev = meta.device
    px = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W)
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    acc = [torch.full((N, H, W), 255.0, device=dev) for _ in range(3)]
    for e in range(E):
        # only the frames where slot e is live do any work: an invalid slot
        # composites with zero alpha, which leaves the canvas unchanged
        idx = torch.nonzero(meta[:, e, M_VALID] > 0.0).squeeze(1)
        if idx.numel() == 0:
            continue
        m = meta[idx, e, :, None, None]                # [n, 20, 1, 1]
        cx, cy, band = m[:, M_CX], m[:, M_CY], m[:, M_STROKE]
        pxw = cx + torch.remainder(px - cx + W * 0.5, float(W)) - W * 0.5
        pyw = cy + torch.remainder(py - cy + H * 0.5, float(H)) - H * 0.5
        is_circle = m[:, M_CIRCLE] > 0.0
        is_cres = m[:, M_CRESCENT] > 0.0
        analytic = is_circle | is_cres
        fa = torch.zeros_like(pxw)
        sa = torch.zeros_like(pxw)
        if not bool(analytic.all()):
            small = bool(((m[:, M_SMALL] > 0.0) | analytic).all())
            d2, cross = _poly_field(pxw, pyw, vx[idx, e, 0], vy[idx, e, 0],
                                    SMALL_V if small else G.MAX_VERTS,
                                    *_edge_culls(cull, idx, e, 0, H, W))
            fa = ((cross % 2) == 1).to(torch.float32)
            sa = _stroke(band, sqrt_rn(d2))
        if bool(analytic.any()):
            d_out = _circle_dist(pxw, pyw, cx, cy, m[:, M_ROUT])
            d_in = _circle_dist(pxw, pyw, m[:, M_ICX], m[:, M_ICY],
                                m[:, M_RIN])
            fa = torch.where(is_circle, (d_out < 0.0).to(torch.float32), fa)
            sa = torch.where(is_circle, _stroke(band, torch.abs(d_out)), sa)
            fa = torch.where(is_cres, ((d_out < 0.0) & (d_in >= 0.0)).to(
                torch.float32), fa)
            sa = torch.where(is_cres, torch.maximum(
                _stroke(band, torch.abs(d_out)),
                _stroke(band, torch.abs(d_in))), sa)
        wrap_ok = ((torch.abs(px - pxw) <= float(W)) &
                   (torch.abs(py - pyw) <= float(H))).to(torch.float32)
        sub = [a[idx] for a in acc]
        live = torch.ones_like(is_circle) if cull is None \
            else cull.live[idx, e]
        _composite(sub, fa, sa, m, wrap_ok, live)
        has_p1 = m[:, M_HASP1] > 0.0
        if bool(has_p1.any()):
            d2, cross = _poly_field(pxw, pyw, vx[idx, e, 1], vy[idx, e, 1],
                                    SMALL_V,
                                    *_edge_culls(cull, idx, e, 1, H, W))
            fa = ((cross % 2) == 1).to(torch.float32)
            sa = _stroke(band, sqrt_rn(d2))
            _composite(sub, fa, sa, m, wrap_ok, has_p1 & live)
        for c in range(3):
            acc[c][idx] = sub[c]

    xs = [float(round(i * W / grid_size)) for i in range(1, grid_size)]
    ys = [float(round(i * H / grid_size)) for i in range(1, grid_size)]
    on_line = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for x in xs:
        on_line |= px == x
    for y in ys:
        on_line |= py == y
    keep = 1.0 - (on_line & use_grid[:, None, None]).to(torch.float32)
    chans = [torch.where(use_grid[:, None, None], a * keep, a) for a in acc]
    img = torch.stack(chans, dim=-1)
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def _edge_culls(cull, idx, e: int, part: int, H: int, W: int):
    """The `near` and `rows` arguments of ``_poly_field`` for outline part
    `part` of element slot `e` on the frames `idx`."""
    if cull is None or cull.near is None:
        return None, None
    near = lambda k: tiles_to_pixels(cull.near[idx, e, :, :, part, k],
                                     cull.tile, H, W)
    rows = lambda k: tiles_to_pixels(cull.rows[idx, e, :, part, k],
                                     cull.tile, H, W)
    return near, rows


def _composite(acc, fa, sa, m, wrap_ok, on):
    """Fill in the element colour, then the black stroke, on the frames
    where `on` holds."""
    a = fa * m[:, M_FILL] * wrap_ok
    s = sa * wrap_ok
    for c, mc in enumerate((M_R, M_G, M_B)):
        v = acc[c] * (1.0 - a) + m[:, mc] * a
        v = v * (1.0 - s)
        acc[c] = torch.where(on, v, acc[c])


# ---------------------------------------------------------------------------
# The rest of render_frame's surface: 'soft', 'hq', flips, colours.

AA_MODES = ("fast", "soft", "hq")
WHITE = (255.0, 255.0, 255.0)
BLACK = (0.0, 0.0, 0.0)


def lanczos4_down2_weights(n_in: int) -> np.ndarray:
    """``[n_in // 2, n_in]`` float32 weights of OpenCV's INTER_LANCZOS4 for
    an exact 2x downscale: output o samples input 2o + 0.5 with the 8-tap
    Lanczos4 kernel at fixed offsets, borders replicated (the kernel is not
    stretched)."""
    d = np.arange(-3, 5) - 0.5
    L = np.sinc(d) * np.sinc(d / 4.0)
    L /= L.sum()
    n_out = n_in // 2
    w = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        for k in range(8):
            i = min(max(2 * o - 3 + k, 0), n_in - 1)
            w[o, i] += L[k]
    return w


def soft_fill_scale(soft_blur: float) -> float:
    """1 / (sigma * sqrt(2)) in float32, sigma from the odd Gaussian kernel
    size as OpenCV derives it: 0.3 * ((k - 1) / 2 - 1) + 0.8."""
    k = soft_blur if soft_blur % 2 == 1 else soft_blur + 1
    sigma = 0.3 * ((k - 1) * 0.5 - 1.0) + 0.8
    return float(np.float32(1.0) / (np.float32(sigma) * np.sqrt(np.float32(2.0))))


def _over(canvas, color, alpha):
    """Alpha-composite flat colours ``[N, 3]`` over ``[N, H, W, 3]`` with
    alpha ``[N, H, W]``."""
    a = alpha[..., None]
    return canvas * (1.0 - a) + color[:, None, None, :] * a


def composite_element(canvas, meta_e, vx_e, vy_e, W: int, H: int,
                      soft_blur: float = 0.0, outline_color=None):
    """Draw element slot data onto f32 canvases ``[N, H, W, 3]`` (0-255),
    generalised: `meta_e` ``[N, 20]``, `vx_e` / `vy_e` ``[N, 2, 64]`` from
    ``prepare_elements``.  `soft_blur` > 0 widens a polygon's fill edge into
    the erf ramp of a Gaussian-blurred mask; `outline_color` (3 values, or
    None for black) colours the stroke.  Painter's order inside the element:
    part 0 fill, part 0 stroke, part 1 fill, part 1 stroke."""
    N = meta_e.shape[0]
    dev = meta_e.device
    m = meta_e[:, :, None, None]                          # [N, 20, 1, 1]
    px = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W)
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    cx, cy, band = m[:, M_CX], m[:, M_CY], m[:, M_STROKE]
    pxw = cx + torch.remainder(px - cx + W * 0.5, float(W)) - W * 0.5
    pyw = cy + torch.remainder(py - cy + H * 0.5, float(H)) - H * 0.5
    wrap_ok = ((torch.abs(px - pxw) <= float(W)) &
               (torch.abs(py - pyw) <= float(H))).to(torch.float32)
    is_circle = m[:, M_CIRCLE] > 0.0
    is_cres = m[:, M_CRESCENT] > 0.0
    has_p1 = (m[:, M_HASP1] > 0.0).to(torch.float32)
    small = bool(((meta_e[:, M_SMALL] > 0.0) |
                  (meta_e[:, M_CIRCLE] > 0.0) |
                  (meta_e[:, M_CRESCENT] > 0.0)).all())

    def part(p, n_edges):
        d2, cross = _poly_field(pxw, pyw, vx_e[:, p], vy_e[:, p], n_edges)
        d = sqrt_rn(d2)
        inside = (cross % 2) == 1
        if soft_blur > 0:
            sd = torch.where(inside, -d, d)
            fill = 0.5 * (1.0 - torch.erf(sd * soft_fill_scale(soft_blur)))
        else:
            fill = inside.to(torch.float32)
        return fill, _stroke(band, d)

    fill0, s0 = part(0, SMALL_V if small else G.MAX_VERTS)
    fill1, s1 = part(1, SMALL_V)
    fill1, s1 = fill1 * has_p1, s1 * has_p1
    d_out = _circle_dist(pxw, pyw, cx, cy, m[:, M_ROUT])
    d_in = _circle_dist(pxw, pyw, m[:, M_ICX], m[:, M_ICY], m[:, M_RIN])
    fill0 = torch.where(is_circle, (d_out < 0.0).to(torch.float32),
                        torch.where(is_cres, ((d_out < 0.0) & (d_in >= 0.0))
                                    .to(torch.float32), fill0))
    s0 = torch.where(is_circle, _stroke(band, torch.abs(d_out)),
                     torch.where(is_cres, torch.maximum(
                         _stroke(band, torch.abs(d_out)),
                         _stroke(band, torch.abs(d_in))), s0))

    valid_f = m[:, M_VALID] * wrap_ok
    fill_f = m[:, M_FILL] * wrap_ok           # the meta's fill is fill & valid
    color = meta_e[:, M_R:M_B + 1]
    outline = torch.tensor(BLACK if outline_color is None else
                           [float(c) for c in outline_color],
                           dtype=torch.float32, device=dev).expand(N, 3)
    canvas = _over(canvas, color, fill0 * fill_f)
    canvas = _over(canvas, outline, s0 * valid_f)
    canvas = _over(canvas, color, fill1 * fill_f)
    canvas = _over(canvas, outline, s1 * valid_f)
    return canvas


def grid_line_mask(W: int, H: int, grid_size: int, device) -> torch.Tensor:
    """bool ``[H, W]``: the pixels of the interior 1px grid lines."""
    px = torch.arange(W, dtype=torch.float32, device=device).expand(H, W)
    py = torch.arange(H, dtype=torch.float32,
                      device=device)[:, None].expand(H, W)
    on_line = torch.zeros((H, W), dtype=torch.bool, device=device)
    for i in range(1, grid_size):
        on_line |= px == float(round(i * W / grid_size))
        on_line |= py == float(round(i * H / grid_size))
    return on_line


def _finish(canvas, use_grid, grid_size: int):
    """Black grid lines on the frames in grid mode, round and clip to u8."""
    H, W = canvas.shape[1:3]
    la = (grid_line_mask(W, H, grid_size, canvas.device) &
          use_grid[:, None, None]).to(torch.float32)[..., None]
    canvas = canvas * (1.0 - la)
    return torch.clamp(torch.round(canvas), 0, 255).to(torch.uint8)


def render_general(states: ElementState, W: int, H: int, use_grid,
                   grid_size: int = 3, honor_flip: bool = False,
                   soft_blur: float = 0.0, bg_color=WHITE,
                   outline_color=None) -> torch.Tensor:
    """states ``[N, E]`` -> u8 ``[N, H, W, 3]`` through ``composite_element``:
    what the kernel's path does not know (soft fills, an outline colour, a
    background colour), in plain tensor code on the states' device."""
    meta, vx, vy = prepare_render_data(states, W, H, use_grid, grid_size,
                                       honor_flip)
    N, E = meta.shape[:2]
    out = torch.empty((N, H, W, 3), dtype=torch.uint8, device=meta.device)
    bg = torch.tensor([float(c) for c in bg_color], dtype=torch.float32,
                      device=meta.device)
    for s in range(0, N, PLAIN_CHUNK):
        sl = slice(s, s + PLAIN_CHUNK)
        canvas = bg.expand(meta[sl].shape[0], H, W, 3)
        for e in range(E):
            canvas = composite_element(canvas, meta[sl, e], vx[sl, e],
                                       vy[sl, e], W, H, soft_blur,
                                       outline_color)
        out[sl] = _finish(canvas, use_grid[sl], grid_size)
    return out


def hq_states(states: ElementState, W: int, H: int, use_grid,
              grid_size: int, scale: int) -> ElementState:
    """The elements 'hq' renders at ``W*scale x H*scale`` with no grid:
    centres snapped at the target size, then centres, sizes and strokes
    times `scale`."""
    cx, cy, _ = grid_snap(states, W, H, use_grid, grid_size)
    return states._replace(cx=cx * scale, cy=cy * scale,
                           size=states.size * scale,
                           stroke=states.stroke * scale)


def render_batch(states: ElementState, W: int, H: int, use_grid,
                 grid_size: int = 3, bg_color=WHITE, honor_flip: bool = False,
                 antialias_mode: str = "fast", scale: int = 2,
                 soft_blur: int = 7) -> torch.Tensor:
    """Render frames ``[N, E]`` -> u8 ``[N, H, W, 3]`` on the states' device
    in one of the three antialias modes:
      'fast' — hard fills and antialiased outlines;
      'soft' — polygon fill edges widened as by a Gaussian blur of kernel
               size `soft_blur`;
      'hq'   — rendered 'fast' at `scale` times the size and downsampled,
               grid lines drawn at the target size.
    'fast' frames, and the supersampled frames of 'hq', on a white
    background go through ``raster_cuda.render_frames``: the CUDA kernel
    for CUDA tensors, ``render_frames`` here for CPU tensors."""
    if antialias_mode not in AA_MODES:
        raise ValueError(f"antialias_mode {antialias_mode!r}: one of "
                         f"{AA_MODES}")
    white = tuple(float(c) for c in bg_color) == WHITE
    if antialias_mode == "hq" and scale > 1:
        big = hq_states(states, W, H, use_grid, grid_size, scale)
        no_grid = torch.zeros_like(use_grid)
        if white:
            hi = render_frames(big, W * scale, H * scale, no_grid,
                                           grid_size, honor_flip)
        else:
            hi = render_general(big, W * scale, H * scale, no_grid, grid_size,
                                honor_flip, bg_color=bg_color)
        return _finish(downsample(hi, scale), use_grid, grid_size)
    if antialias_mode == "soft":
        return render_general(states, W, H, use_grid, grid_size, honor_flip,
                              float(soft_blur), bg_color)
    if not white:
        return render_general(states, W, H, use_grid, grid_size, honor_flip,
                              bg_color=bg_color)
    return render_frames(states, W, H, use_grid, grid_size, honor_flip)


def downsample(hi: torch.Tensor, scale: int) -> torch.Tensor:
    """u8 ``[N, H*scale, W*scale, 3]`` -> f32 ``[N, H, W, 3]``: OpenCV's
    Lanczos4 for scale 2 (rows, then columns), else lanczos3 without
    antialias."""
    Hs, Ws = hi.shape[1:3]
    x = hi.to(torch.float32)
    if scale == 2:
        wh = torch.from_numpy(lanczos4_down2_weights(Hs)).to(hi.device)
        ww = torch.from_numpy(lanczos4_down2_weights(Ws)).to(hi.device)
        t = torch.einsum("oh,nhwc->nowc", wh, x)
        return torch.einsum("pw,nowc->nopc", ww, t)
    return resize(x, (Hs // scale, Ws // scale), "lanczos3", antialias=False)


def render_frame(state: ElementState, W: int, H: int, bg_color=WHITE,
                 use_grid=False, grid_size: int = 3, honor_flip: bool = False,
                 antialias_mode: str = "fast", scale: int = 2,
                 soft_blur: int = 7) -> torch.Tensor:
    """One frame (unbatched ElementState ``[E]``) -> u8 ``[H, W, 3]``; see
    ``render_batch``."""
    dev = state.cx.device
    ug = torch.as_tensor(use_grid, dtype=torch.bool, device=dev).reshape(1)
    return render_batch(state.map(lambda a: a[None]), W, H, ug, grid_size,
                        bg_color, honor_flip, antialias_mode, scale,
                        soft_blur)[0]
