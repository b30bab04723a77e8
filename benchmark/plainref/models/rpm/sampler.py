# sampler.py — prototype scene sampler, batched over keys.
"""``sample_prototype`` of the JAX package (models/rpm/sampler.py) with the
batch written out: keys ``[B, 2]`` -> ElementState ``[B, E]``.

Same draws from the same key stream (utils/prng.py), so the prototypes
equal the JAX package's: n in {1,2,3} unless pinned, grid placement in
distinct shuffled cells with jitter, or the 'random' / line / circle
arrangements; kind, fill, stroke, angle and colour per element.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...device import constant
from ...ops.raster import cos_sin
from ...utils import prng
from ...utils.config import KIND_ID, SHAPE_KINDS
from ...utils.state import ElementState, recompute_bbox_from_center

NKINDS = len(SHAPE_KINDS)
CIRCLE = KIND_ID["circle"]
ANGLE_CHOICES = np.asarray([0.0, 45.0, 90.0, 135.0, 180.0], np.float32)


def _col(x):
    """[B] -> [B, 1] for broadcasting over the element axis."""
    return x[:, None]


def sample_prototype(keys: torch.Tensor, W: int, H: int, max_elems: int,
                     n=None, use_grid=False, grid_size: int = 3,
                     cell_jitter_frac: float = 0.2,
                     arrangement: str = "random") -> ElementState:
    """Sample B prototype frames.  `n` is None, an int or an int tensor
    ``[B]``; `use_grid` a bool or bool tensor ``[B]``."""
    dev = keys.device
    B = keys.shape[0]
    (k_n, k_cells, k_kind, k_fill, k_stroke, k_angle, k_color, k_gj, k_size,
     k_pos, k_pj) = prng.split(keys, 11).unbind(-2)

    if n is None:
        n = prng.randint(k_n, (), 1, 4)
    if not torch.is_tensor(n):
        n = torch.full((), n, dtype=torch.int64, device=dev)
    n = torch.clamp(n.expand(B), min=1)
    E = max_elems
    slot = torch.arange(E, device=dev)
    valid = slot[None, :] < _col(n)

    # ---- grid-mode placement ----
    cell_w = W / grid_size
    cell_h = H / grid_size
    cell_short = min(cell_w, cell_h)
    n_cells = grid_size * grid_size
    perm = prng.permutation(k_cells, n_cells)                  # [B, 9]
    cell = perm[:, torch.clamp(slot, max=n_cells - 1)]
    g_col = (cell % grid_size).float()
    g_row = torch.div(cell, grid_size, rounding_mode="floor").float()
    g_cx = torch.round((g_col + 0.5) * cell_w)
    g_cy = torch.round((g_row + 0.5) * cell_h)
    jit = cell_jitter_frac * cell_short
    g_jit = torch.round(prng.uniform(k_gj, (E, 2), minval=-jit, maxval=jit))
    g_cx = torch.clamp(g_cx + g_jit[..., 0], 0, W)
    g_cy = torch.clamp(g_cy + g_jit[..., 1], 0, H)
    g_size = torch.full((B, E), float(max(8, min(round(cell_short * 0.6),
                                                 min(W, H)))), device=dev)

    # ---- non-grid 'random' arrangement ----
    base = min(W, H) // 4
    var = base // 3
    r_size = torch.clamp(base + prng.randint(k_size, (E,), -var, var + 1).float(),
                         min=6.0)
    lo = r_size / 2 + 5
    hi_x = torch.maximum(W - r_size / 2 - 5, lo)
    hi_y = torch.maximum(H - r_size / 2 - 5, lo)
    u = prng.uniform(k_pos, (E, 2))
    r_cx = torch.floor(lo + u[..., 0] * (hi_x - lo + 1))
    r_cy = torch.floor(lo + u[..., 1] * (hi_y - lo + 1))
    pj = torch.clamp(torch.floor_divide(r_size, 4), max=10)
    pj_draw = torch.floor(prng.uniform(k_pj, (E, 2)) * (2 * pj[..., None] + 1)) \
        - pj[..., None]
    if arrangement == "random":
        r_cx = torch.minimum(torch.maximum(r_cx + pj_draw[..., 0], lo), hi_x)
        r_cy = torch.minimum(torch.maximum(r_cy + pj_draw[..., 1], lo), hi_y)
    else:
        margin = torch.floor_divide(
            torch.where(valid, r_size, 0.0).amax(-1, keepdim=True), 2) + 10
        i = slot.float()[None, :]
        nm1 = _col(torch.clamp(n - 1, min=1).float())
        sx = (W - 2 * margin) / nm1
        sy = (H - 2 * margin) / nm1
        full = lambda v: torch.full((B, E), float(v), device=dev)
        if arrangement == "horizontal":
            ax, ay = torch.floor(margin + i * sx), full(H // 2)
        elif arrangement == "vertical":
            ax, ay = full(W // 2), torch.floor(margin + i * sy)
        elif arrangement == "diagonal":
            ax, ay = torch.floor(margin + i * sx), torch.floor(margin + i * sy)
        elif arrangement == "circular":
            rad = min(W, H) // 4
            th = 2.0 * math.pi * i \
                / _col(torch.clamp(n, min=1).float())
            c, s = cos_sin(th)
            ax = torch.floor(W // 2 + rad * c)
            ay = torch.floor(H // 2 + rad * s)
        else:
            raise ValueError(f"unknown arrangement {arrangement!r}")
        if arrangement != "circular":
            one = _col(n == 1)
            ax = torch.where(one, float(W // 2), ax)
            ay = torch.where(one, float(H // 2), ay)
        r_cx = torch.minimum(torch.maximum(ax + pj_draw[..., 0], lo), hi_x)
        r_cy = torch.minimum(torch.maximum(ay + pj_draw[..., 1], lo), hi_y)

    if not torch.is_tensor(use_grid):
        use_grid = torch.full((), use_grid, dtype=torch.bool, device=dev)
    ug = _col(use_grid.expand(B))
    cx = torch.where(ug, g_cx, r_cx)
    cy = torch.where(ug, g_cy, r_cy)
    size = torch.where(ug, g_size, r_size)

    # ---- per-element attributes ----
    kind = prng.randint(k_kind, (E,), 0, NKINDS)
    fill = prng.uniform(k_fill, (E,)) < (2.0 / 3.0)
    stroke = prng.randint(k_stroke, (E,), 1, 4).float()
    angles = constant("angle_choices", dev, lambda: ANGLE_CHOICES)
    angle = angles[prng.randint(k_angle, (E,), 0, 5)]
    angle = torch.where(kind == CIRCLE, 0.0, angle)
    color = torch.floor(prng.uniform(k_color, (E, 3), minval=30.0, maxval=220.0))

    zero = torch.zeros((), device=dev)
    st = ElementState(
        kind=torch.where(valid, kind, 0),
        size=torch.where(valid, size, zero),
        fill=fill & valid,
        stroke=torch.where(valid, stroke, 1.0),
        cx=torch.where(valid, cx, zero),
        cy=torch.where(valid, cy, zero),
        angle=torch.where(valid, angle, zero),
        flip_h=torch.zeros((B, E), dtype=torch.bool, device=dev),
        flip_v=torch.zeros((B, E), dtype=torch.bool, device=dev),
        color=torch.where(valid[..., None], color, zero),
        bbox=torch.zeros((B, E, 4), device=dev),
        valid=valid)
    return recompute_bbox_from_center(st, W, H)
