# shapes.py — Shape.draw-compatible single-shape drawing API.
"""``Shape(kind, size, fill, stroke_width).draw(image, center, angle, color,
outline, flip_mode, **kw)``, the JAX package's models/rpm/shapes.py on
torch:

- three antialias modes ``fast`` / ``soft`` / ``hq`` (``antialias_mode``,
  ``scale``, ``soft_blur``): 'hq' resizes the whole canvas up (cubic), draws
  on the float canvas and resizes down (lanczos3, antialiased);
- toroidal wrap-around drawing;
- an external raster overlay drawn under the vector shape:
  ``external_image`` / ``overlay_image`` / ``texture`` (path, PIL image or
  ndarray) with ``external_size`` (None: the shape's size; a pair:
  absolute; a number in (0, 4] or a string: a factor of the size; a larger
  number: an absolute square), ``external_rotate``, ``external_flip``,
  ``external_opacity``, ``external_mode='tile'`` and ``external_only``.  An
  external image that fails to load or prepare is skipped silently and the
  vector shape is drawn alone: that is this API's documented behaviour.

Arrays are channel-verbatim RGB.  The drawing is ``ops/raster``'s
``composite_element`` and ``ops/overlay`` on one device: ``device=`` names
it ('cuda' by default, through ``device.resolve_device``, which raises
where there is no card; 'cpu' runs on the CPU).  The result is a new RGB u8
ndarray.  This is the path for single draws; batches go through
``ops/raster.render_batch``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...ops.overlay import blend_overlay, load_external_image, prepare_overlay
from ...ops.raster import composite_element, prepare_elements
from ...ops.resize import resize
from ...utils.config import KIND_ID, SHAPE_KINDS
from ...utils.state import ElementState

__all__ = ["Shape", "draw_shape"]


def _to_array(image) -> np.ndarray:
    """PIL / 2-D / 3-D input -> an RGB u8 ndarray copy."""
    if not isinstance(image, np.ndarray):
        image = np.asarray(image)  # PIL images expose __array__
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=2)
    return np.array(image[..., :3], np.uint8)


def _external_target(external_size, s: float) -> Tuple[int, int]:
    """The external_size rule: None -> (s, s); pair -> absolute; number in
    (0, 4] -> factor of s; number > 4 -> absolute square; str -> factor."""
    if external_size is None:
        return int(round(s)), int(round(s))
    if isinstance(external_size, (list, tuple)) and len(external_size) == 2:
        return int(external_size[0]), int(external_size[1])
    if isinstance(external_size, str):
        f = float(external_size)
        return int(round(s * f)), int(round(s * f))
    v = float(external_size)
    if 0 < v <= 4.0:
        return int(round(s * v)), int(round(s * v))
    return int(round(v)), int(round(v))


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


class Shape:
    """Shape drawing handle: kind, size, fill and stroke width."""

    KINDS = list(SHAPE_KINDS)

    def __init__(self, kind: str = "square", size: int = 60,
                 fill: bool = True, stroke_width: int = 2):
        if kind not in KIND_ID:
            raise ValueError(f"unknown kind {kind!r}; one of {self.KINDS}")
        self.kind = kind
        self.size = size
        self.fill = fill
        self.stroke_width = stroke_width

    def draw(self, image, center: Tuple[int, int], angle: float = 0.0,
             color=None, outline=(0, 0, 0), flip_mode: Optional[str] = None,
             device="cuda", **kwargs) -> np.ndarray:
        """Draw this shape (and/or an external overlay) onto a copy of
        `image` on `device`; clockwise-positive angle, wrap-around, the
        keyword set of the module docstring.  Returns a new RGB u8
        ndarray."""
        dev = device if isinstance(device, torch.device) \
            else resolve_device(device)
        antialias_mode = kwargs.get("antialias_mode", "fast")
        scale = int(kwargs.get("scale", 1))
        soft_blur = int(kwargs.get("soft_blur", 7))
        # first non-None of the three aliases
        external_obj = next(
            (kwargs[k] for k in ("external_image", "overlay_image", "texture")
             if kwargs.get(k) is not None), None)
        external_only = bool(kwargs.get("external_only", False))

        img = _to_array(image)
        H, W = img.shape[:2]
        cx, cy = int(center[0]), int(center[1])
        if color is None:  # a random colour from numpy's global generator
            color = tuple(int(c) for c in np.random.randint(30, 221, 3))
        canvas = torch.from_numpy(img).to(dev).to(torch.float32)

        if antialias_mode == "hq" and scale > 1:
            # supersample the whole canvas, draw at scale, downsample
            hi = resize(canvas, (H * scale, W * scale), "cubic")
            hi = self._draw_inner(hi, W, H, cx, cy, angle, color, outline,
                                  flip_mode, kwargs, external_obj,
                                  external_only, soft_blur=0.0)
            lo = resize(hi, (H, W), "lanczos3", antialias=True)
            return _to_u8(lo).cpu().numpy()

        sb = float(soft_blur) if antialias_mode == "soft" else 0.0
        out = self._draw_inner(canvas, W, H, cx, cy, angle, color, outline,
                               flip_mode, kwargs, external_obj, external_only,
                               soft_blur=sb)
        return _to_u8(out).cpu().numpy()

    def _draw_inner(self, canvas: torch.Tensor, W: int, H: int, cx: int,
                    cy: int, angle: float, color, outline, flip_mode,
                    kwargs: dict, external_obj, external_only: bool,
                    soft_blur: float) -> torch.Tensor:
        """Overlay first, then the vector shape.  `canvas` f32 ``[Hc, Wc, 3]``
        may be supersampled; the ratio is read off its width."""
        Hc, Wc = canvas.shape[:2]
        dev = canvas.device
        ratio = Wc / float(W)
        cx_s, cy_s = int(round(cx * ratio)), int(round(cy * ratio))
        s_s = self.size * ratio

        if external_obj is not None:
            canvas = self._draw_external(canvas, cx_s, cy_s, s_s, kwargs,
                                         external_obj)
        if external_only:
            return canvas

        f = lambda v, dt=torch.float32: torch.tensor([[v]], dtype=dt,
                                                     device=dev)
        state = ElementState(
            kind=f(KIND_ID[self.kind], torch.int64), size=f(s_s),
            fill=f(bool(self.fill), torch.bool),
            stroke=f(max(1, round(self.stroke_width * ratio))),
            cx=f(cx_s), cy=f(cy_s),
            # the float angle is kept (sub-pixel accurate)
            angle=f(angle),
            flip_h=f(flip_mode in ("horizontal", "both"), torch.bool),
            flip_v=f(flip_mode in ("vertical", "both"), torch.bool),
            color=torch.tensor([[[float(c) for c in color]]], device=dev),
            bbox=torch.zeros((1, 1, 4), device=dev),
            valid=f(True, torch.bool))
        meta, vx, vy = prepare_elements(state, state.cx, state.cy,
                                        state.angle, honor_flip=True)
        return composite_element(canvas[None], meta[:, 0], vx[:, 0], vy[:, 0],
                                 Wc, Hc, soft_blur, outline)[0]

    def _draw_external(self, canvas: torch.Tensor, cx_s: int, cy_s: int,
                       s_s: float, kwargs: dict, external_obj) -> torch.Tensor:
        """External overlay: load, resize / rotate / flip, tile, wrapped
        alpha blend.  Any failure leaves the canvas as it was: the vector
        shape is then drawn alone.  Rotation keeps the image's extent."""
        try:
            tw, th = _external_target(kwargs.get("external_size"), s_s)
            rgba = load_external_image(external_obj)
            ov = prepare_overlay(
                torch.from_numpy(np.ascontiguousarray(rgba)).to(canvas.device),
                target_size=(tw, th),
                rotate=float(kwargs.get("external_rotate", 0.0)),
                flip=kwargs.get("external_flip"),
                tile_to=(tw, th) if kwargs.get("external_mode") == "tile"
                else None)
            # a cubic-resized 'hq' canvas may overshoot the u8 range
            return blend_overlay(
                _to_u8(canvas), ov, (float(cx_s), float(cy_s)),
                opacity=float(kwargs.get("external_opacity", 1.0)),
                wrap=True).to(torch.float32)
        except Exception:
            return canvas


def draw_shape(image, kind: str, center: Tuple[int, int], size: int = 60,
               fill: bool = True, stroke_width: int = 2, **draw_kwargs
               ) -> np.ndarray:
    """Functional one-call form of ``Shape(...).draw(...)``."""
    return Shape(kind, size, fill, stroke_width).draw(image, center,
                                                      **draw_kwargs)
