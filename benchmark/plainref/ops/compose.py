# compose.py — question-grid composition (area resample + static overlay).
"""Composes the puzzle grid (sequence row + query cell + options row), as
the JAX package's ops/compose.py does, for a batch of samples.

The layout geometry is computed here.  Its pixels (the black Hershey-text
labels and 1px borders as a u8 overlay with alpha, and the '?' query
patch) were drawn with OpenCV by the JAX package's ``build_layout`` and
are read from ``layout_assets.npz`` (written by tests/test_torch_layouts.py),
so the port needs no OpenCV.  A layout the file does not hold raises,
naming its key.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List

import numpy as np
import torch

from ..device import constant
from .resize import resize

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "layout_assets.npz")
_assets = None
_assets_lock = threading.Lock()


@dataclass
class GridLayout:
    """Static layout for one (W, H, n_states, num_options) combination."""
    W: int
    H: int
    n_states: int
    num_options: int
    margin: int
    padding_v: int
    cell_size: int
    grid_h: int
    seq_offset_x: int
    opt_offset_x: int
    top_y: int
    bottom_y: int
    show_labels: bool
    show_border: bool
    bg_color: tuple
    query_patch: np.ndarray = field(repr=False)     # u8 [cell, cell, 3]
    cells_meta: List[Dict] = field(repr=False)
    overlay_rgb_u8: np.ndarray = field(repr=False)  # u8 [grid_h, W, 3]
    overlay_a8: np.ndarray = field(repr=False)      # u8 [grid_h, W]

    @property
    def key(self) -> str:
        """The layout's key in layout_assets.npz."""
        return layout_key(self.W, self.H, self.n_states, self.num_options,
                          self.margin, self.padding_v, self.show_labels,
                          self.show_border)


def layout_key(W, H, n_states, num_options, margin, padding_v, show_labels,
               show_border) -> str:
    return (f"{W}x{H}_s{n_states}_o{num_options}_m{margin}_p{padding_v}"
            f"_l{int(bool(show_labels))}_b{int(bool(show_border))}")


def _load_assets():
    global _assets
    with _assets_lock:
        if _assets is None:
            with np.load(ASSETS) as z:
                _assets = {k: z[k] for k in z.files}
    return _assets


def build_layout(W: int, H: int, n_states: int, num_options: int,
                 margin: int = 20, padding_v: int = 20,
                 show_labels: bool = True, show_border: bool = True,
                 bg_color=(255, 255, 255)) -> GridLayout:
    """Layout geometry plus the baked overlay and query patch."""
    cols_seq = n_states + 1
    cols_opt = num_options
    max_cell_w = (W - 2 * margin) // max(1, max(cols_seq, cols_opt))
    max_cell_h = (H - 2 * margin - padding_v) // 2
    cell = max(1, min(max_cell_w, max_cell_h))
    grid_h = 2 * cell + padding_v + 2 * margin
    seq_off = (W - cols_seq * cell) // 2
    opt_off = (W - cols_opt * cell) // 2
    top_y = margin
    bottom_y = top_y + cell + padding_v

    key = layout_key(W, H, n_states, num_options, margin, padding_v,
                     show_labels, show_border)
    assets = _load_assets()
    if f"{key}/overlay_rgb" not in assets:
        raise KeyError(f"layout {key!r} is not in {ASSETS}; add it to "
                       "CANVASES in tests/test_torch_layouts.py and re-bake "
                       "with python -m tests.test_torch_layouts --bake")

    cells_meta: List[Dict] = []
    for i in range(cols_seq):
        x = seq_off + i * cell
        cells_meta.append({
            "r": 0, "c": i, "label": f"S{i}" if show_labels else "",
            "bbox": [int(x), int(top_y), int(cell), int(cell)],
            "is_query": bool(i == n_states)})
    for i in range(cols_opt):
        x = opt_off + i * cell
        cells_meta.append({
            "r": 1, "c": i, "label": chr(65 + i) if show_labels else "",
            "bbox": [int(x), int(bottom_y), int(cell), int(cell)]})

    return GridLayout(W=W, H=H, n_states=n_states, num_options=num_options,
                      margin=margin, padding_v=padding_v, cell_size=cell,
                      grid_h=grid_h, seq_offset_x=seq_off, opt_offset_x=opt_off,
                      top_y=top_y, bottom_y=bottom_y, show_labels=show_labels,
                      show_border=show_border, bg_color=tuple(bg_color),
                      query_patch=assets[f"{key}/query_patch"],
                      cells_meta=cells_meta,
                      overlay_rgb_u8=assets[f"{key}/overlay_rgb"],
                      overlay_a8=assets[f"{key}/overlay_a"])


@lru_cache(maxsize=64)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] pixel-coverage weights (cv2.INTER_AREA's downscale
    model); rows sum to 1."""
    sx = n_in / n_out
    w = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        a, b = o * sx, (o + 1) * sx
        for i in range(int(np.floor(a)), min(int(np.ceil(b)), n_in)):
            w[o, i] = min(b, i + 1.0) - max(a, float(i))
        w[o] /= (b - a)
    return w


def fit_into_cell(imgs: torch.Tensor, cell: int) -> torch.Tensor:
    """Aspect-preserving resize of u8 ``[N, Hs, Ws, 3]`` onto white square
    cells -> f32 ``[N, cell, cell, 3]``.  Downscale is the exact area
    resample as two matmuls; a cell at least as large as the frame takes
    the cubic resize of ops/resize.py (the identity at the same size)."""
    N, Hs, Ws = imgs.shape[:3]
    scale = min(cell / Ws, cell / Hs)
    new_w = max(1, int(round(Ws * scale)))
    new_h = max(1, int(round(Hs * scale)))
    dev = imgs.device
    x = imgs.float()
    if scale < 1.0:
        wh = constant(("area", Hs, new_h), dev,
                      lambda: _area_weights(Hs, new_h))
        ww = constant(("area", Ws, new_w), dev,
                      lambda: _area_weights(Ws, new_w))
        t = torch.einsum("oh,nhwc->nowc", wh, x)
        resized = torch.einsum("pw,nowc->nopc", ww, t)
    else:
        resized = resize(x, (new_h, new_w), "cubic")
    patch = torch.full((N, cell, cell, 3), 255.0, device=dev)
    ox = (cell - new_w) // 2
    oy = (cell - new_h) // 2
    patch[:, oy:oy + new_h, ox:ox + new_w] = resized
    return patch


def apply_overlay_u8(content: torch.Tensor, ov_rgb_u8: torch.Tensor,
                     a8: torch.Tensor) -> torch.Tensor:
    """Exact integer alpha blend: (c*(255-a) + o*a + 127) // 255."""
    c = content.to(torch.int32)
    o = ov_rgb_u8.to(torch.int32)
    a = a8.to(torch.int32)[..., None]
    return torch.div(c * (255 - a) + o * a + 127, 255,
                     rounding_mode="floor").to(torch.uint8)


def compose_grid(layout: GridLayout, state_imgs: torch.Tensor,
                 option_imgs: torch.Tensor, return_pre: bool = False):
    """Grids of a batch: state_imgs u8 ``[B, n_states, H, W, 3]``,
    option_imgs u8 ``[B, num_options, H, W, 3]`` -> u8
    ``[B, grid_h, W, 3]``; with `return_pre` also the canvas before the
    static overlay, which the run codecs ship (the host blends the overlay
    again with the same integer formula)."""
    B = state_imgs.shape[0]
    dev = state_imgs.device
    cell = layout.cell_size
    canvas = torch.empty((B, layout.grid_h, layout.W, 3), device=dev)
    canvas[:] = constant(("bg", layout.bg_color), dev,
                         lambda: np.asarray(layout.bg_color, np.float32))
    rows = ((state_imgs, layout.n_states, layout.top_y, layout.seq_offset_x),
            (option_imgs, layout.num_options, layout.bottom_y,
             layout.opt_offset_x))
    for imgs, count, y, x0 in rows:
        patches = fit_into_cell(imgs[:, :count].flatten(0, 1), cell)
        patches = patches.reshape((B, count) + patches.shape[1:])
        for i in range(count):
            x = x0 + i * cell
            canvas[:, y:y + cell, x:x + cell] = patches[:, i]
    pre = torch.clamp(torch.round(canvas), 0, 255).to(torch.uint8)
    grid = apply_overlay_u8(
        pre, constant(("overlay_rgb", layout.key), dev,
                      lambda: layout.overlay_rgb_u8),
        constant(("overlay_a", layout.key), dev, lambda: layout.overlay_a8))
    return (grid, pre) if return_pre else grid
