# overlay.py — external raster overlays on rendered frames.
"""The JAX package's ops/overlay.py on torch tensors: an external image
(file path, PIL image or ndarray) is normalised to RGBA on the host,
resized, rotated, flipped and tiled on the device it is put on, and
alpha-blended onto a canvas centred on an element, with toroidal wrap.

- ``load_external_image``: host side.  PIL, OpenCV and cairosvg are
  imported inside the function and only for a path; an ndarray needs none
  of them.
- ``prepare_overlay``: antialiased linear resize (ops/resize.py), rotation
  by nearest sample about the image centre with the pixels that fall
  outside zeroed, flips, tile-and-crop.
- ``blend_overlay``: the overlay sampled (nearest) at the canvas
  coordinates wrapped to the copy nearest the centre, alpha times opacity,
  round and clip to u8.

Everything runs where its tensors lie.  float32 throughout, in the JAX
package's operation order and with the roundings XLA gives its jitted
blend; ``torch.remainder`` is ``jnp.mod`` (the sign of
the divisor), the index casts truncate after the clip as ``astype(int32)``
does, and ``wo // 2`` is the integer half.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .raster import DEG2RAD, cos_sin, fma
from .resize import resize


INV_255 = float(np.float32(1.0) / np.float32(255.0))


def load_external_image(obj) -> np.ndarray:
    """Path, PIL image or ndarray -> RGBA u8 ``[h, w, 4]`` (host).  An SVG
    path is rasterised through cairosvg where that is installed."""
    if isinstance(obj, str):
        if obj.lower().endswith(".svg"):
            try:
                import cairosvg
                from io import BytesIO
                from PIL import Image
                png = cairosvg.svg2png(url=obj)
                return np.asarray(Image.open(BytesIO(png)).convert("RGBA"))
            except ImportError as e:
                raise RuntimeError(
                    "cairosvg (and PIL) are required to rasterize SVG "
                    "files; provide PNG/JPG instead") from e
        try:
            from PIL import Image
            return np.asarray(Image.open(obj).convert("RGBA"))
        except ImportError:
            import cv2
            bgr = cv2.imread(obj, cv2.IMREAD_UNCHANGED)
            if bgr is None:
                raise FileNotFoundError(obj)
            if bgr.ndim == 2:
                bgr = cv2.cvtColor(bgr, cv2.COLOR_GRAY2BGR)
            if bgr.shape[2] == 3:
                a = np.full(bgr.shape[:2] + (1,), 255, np.uint8)
                bgr = np.concatenate([bgr, a], 2)
            return bgr[..., [2, 1, 0, 3]]
    arr = np.asarray(obj)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, 2)
    if arr.shape[2] == 3:
        arr = np.concatenate(
            [arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)], 2)
    return arr.astype(np.uint8)


def prepare_overlay(rgba: torch.Tensor, target_size: Optional[Sequence] = None,
                    rotate: float = 0.0, flip: Optional[str] = None,
                    tile_to: Optional[Sequence] = None) -> torch.Tensor:
    """Resize / rotate / flip / tile an RGBA overlay ``[h, w, 4]`` -> f32
    ``[h', w', 4]`` on its device.  `target_size` and `tile_to` are
    (width, height); rotation is clockwise-positive; flip is 'horizontal',
    'vertical' or 'both'; tiling repeats, then crops."""
    img = rgba.to(torch.float32)
    dev = img.device
    if target_size is not None:
        tw, th = int(target_size[0]), int(target_size[1])
        img = resize(img, (th, tw), "linear", antialias=True)
    if rotate:
        h, w = img.shape[:2]
        a = torch.tensor(-float(rotate), dtype=torch.float32) * DEG2RAD
        ca, sa = cos_sin(a.to(dev))
        yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
        xc, yc = xx - w / 2.0, yy - h / 2.0
        # sample where the inverse rotation lands
        sx = xc * ca + yc * sa + w / 2.0
        sy = -xc * sa + yc * ca + h / 2.0
        sxi = torch.clamp(torch.round(sx), 0, w - 1).to(torch.int64)
        syi = torch.clamp(torch.round(sy), 0, h - 1).to(torch.int64)
        valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
        img = img[syi, sxi] * valid[..., None]
    if flip in ("horizontal", "both"):
        img = torch.flip(img, (1,))
    if flip in ("vertical", "both"):
        img = torch.flip(img, (0,))
    if tile_to is not None:
        tw, th = int(tile_to[0]), int(tile_to[1])
        h, w = img.shape[:2]
        img = img.repeat(-(-th // h), -(-tw // w), 1)[:th, :tw]
    return img


def blend_overlay(canvas: torch.Tensor, overlay_rgba: torch.Tensor, center,
                  opacity: float = 1.0, wrap: bool = True) -> torch.Tensor:
    """Alpha-composite an RGBA overlay f32 ``[ho, wo, 4]`` centred at
    `center` (x, y) onto an RGB u8 canvas ``[H, W, 3]`` -> u8, on the
    canvas's device."""
    H, W = canvas.shape[:2]
    ho, wo = overlay_rgba.shape[:2]
    dev = canvas.device
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)
    cx, cy = f32(center[0]), f32(center[1])
    px = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W)
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    if wrap:
        px = cx + torch.remainder(px - cx + W / 2.0, float(W)) - W / 2.0
        py = cy + torch.remainder(py - cy + H / 2.0, float(H)) - H / 2.0
    u = px - (cx - wo // 2)
    v = py - (cy - ho // 2)
    ui = torch.clamp(u, 0, wo - 1).to(torch.int64)
    vi = torch.clamp(v, 0, ho - 1).to(torch.int64)
    inside = (u >= 0) & (u < wo) & (v >= 0) & (v < ho)
    sample = overlay_rgba.to(dev)[vi, ui]
    # XLA's roundings: the division by 255 is a product with the float32
    # reciprocal, and canvas * (1 - a) + sample * a is one fused multiply-add
    a = (sample[..., 3] * INV_255) * torch.clamp(f32(opacity), 0.0, 1.0) \
        * inside
    a = a[..., None]
    out = fma(canvas.to(torch.float32), 1.0 - a, sample[..., :3] * a)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
