# resize.py — separable image resize with the weights of jax.image.resize.
"""The port's counterpart of ``jax.image.resize`` for the three kernels the
JAX package uses: 'linear' with antialias (pHash, overlays), 'cubic' (the
grid composer's upscale, Shape.draw's 'hq' upsample) and 'lanczos3' with and
without antialias ('hq' downsamples).

``weight_matrix`` builds the ``[n_out, n_in]`` float32 matrix of one axis as
jax's ``compute_weight_mat`` does: half-pixel centres, the kernel stretched
by the ratio only when `antialias` and the axis shrinks, taps outside the
input dropped and each row renormalised, rows whose sample point lies
outside the input zeroed.  ``resize`` applies one matrix per axis as a
float32 matmul; an axis whose size does not change is left alone, as jax
leaves it (a same-size resize is the identity).

This is not ``torch.nn.functional.interpolate``: that bicubic is Keys with
a = -0.75 and replicated borders (jax: a = -0.5, taps dropped and
renormalised), and it has no Lanczos kernel.

Bits.  The matrices are computed in float32 with the roundings XLA's CPU
backend gives the same expressions inside ``jax.image.resize``'s program,
so that they are equal bit for bit: the sample position is one fused
multiply-add; a division by the constant kernel scale is a multiplication
by its float32 reciprocal, folded into the constants that follow it; the
Keys polynomial is a Horner chain of fused multiply-adds; the sines are
float64 results rounded once; and a column sum runs over windows of 32
taps (the axis padded evenly to a multiple of 32), each in order, then over
the windows in order.  tests/test_torch_resize.py holds them to the matrices
jax applies.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from ..device import configure_numerics, constant

METHODS = ("linear", "cubic", "lanczos3")
_WINDOW = 32          # XLA's CPU backend sums long axes in windows of 32
_VECTOR_MIN = 96      # output rows from which its loops are vectorised

f32 = np.float32


def _fma(a, b, c):
    """float32 a*b + c with one rounding."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def _sin(x):
    """float32 sine as the float64 result rounded once."""
    return np.sin(np.asarray(x, np.float64)).astype(f32)


def _triangle(d, r):
    return np.maximum(f32(0), _fma(-d, r, f32(1)))


def _keys_cubic(d, r):
    x = np.abs(d * r)
    ma = _fma
    near = ma(ma(f32(1.5), x, f32(-2.5)) * x, x, f32(1))
    far = ma(ma(ma(f32(-0.5), x, f32(2.5)), x, f32(-4)), x, f32(2))
    out = np.where(x >= f32(1), far, near)
    return np.where(x >= f32(2), f32(0), out)


def _lanczos3(d, r):
    radius = f32(3)
    x = d * r
    # pi * (d * r) and pi * (d * r) / radius, with the constants folded
    c1 = f32(np.pi) * r
    c2 = c1 * (f32(1) / radius)
    y = (_sin(d * c1) * radius) * _sin(d * c2)
    den = np.where(x != 0, (x * x) * f32(np.pi ** 2), f32(1))
    out = np.where(x > f32(1e-3), y / den, f32(1))
    return np.where(x > radius, f32(0), out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic, "lanczos3": _lanczos3}


def _windowed_sum(w: np.ndarray) -> np.ndarray:
    """Sum over axis 1 of ``[n_out, n_in]`` in the order of XLA's CPU
    backend: up to 32 taps in order; a longer axis is padded evenly to a
    multiple of 32 and summed window by window, then over the windows."""
    n = w.shape[1]
    if n <= _WINDOW:
        total = np.zeros(w.shape[0], f32)
        for i in range(n):
            total = total + w[:, i]
        return total
    pad = -n % _WINDOW
    w = np.pad(w, ((0, 0), (pad // 2, pad - pad // 2)))
    parts = w.reshape(w.shape[0], -1, _WINDOW)
    total = np.zeros(parts.shape[:2], f32)
    for i in range(_WINDOW):
        total = total + parts[:, :, i]
    return _windowed_sum(total)


@lru_cache(maxsize=64)
def weight_matrix(n_in: int, n_out: int, method: str,
                  antialias: bool) -> np.ndarray:
    """``[n_out, n_in]`` float32 resize weights of one axis, read-only."""
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}; one of {METHODS}")
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1)) if antialias else f32(1)
    recip = f32(1) / kernel_scale
    centre = np.arange(n_out, dtype=f32) + f32(0.5)
    sample = (_fma(centre, inv_scale, f32(-0.5)) if n_out >= _VECTOR_MIN
              else (centre * inv_scale + f32(-0.5)).astype(f32))
    d = np.abs(sample[:, None] - np.arange(n_in, dtype=f32)[None, :])
    w = _KERNELS[method](d, recip).astype(f32)
    total = _windowed_sum(w)[:, None]
    w = np.where(np.abs(total) > f32(1000.0 * float(np.finfo(f32).eps)),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(n_in - 0.5))
    w = np.where(inside[:, None], w, f32(0)).astype(f32)
    w.setflags(write=False)
    return w


def weight_tensor(n_in: int, n_out: int, method: str, antialias: bool,
                  device) -> torch.Tensor:
    """``weight_matrix`` as a float32 tensor on `device` (built once per
    device; callers only read it)."""
    return constant(("resize", n_in, n_out, method, antialias), device,
                    lambda: np.array(weight_matrix(n_in, n_out, method,
                                                   antialias)))


def resize(img: torch.Tensor, size: Sequence[int], method: str,
           antialias: bool = True) -> torch.Tensor:
    """Resize float32 ``[..., H, W, C]`` to ``[..., size[0], size[1], C]``
    on the tensor's device: one matmul per axis that changes.  The cheaper
    axis goes first (the height on a tie), which is the order jax's einsum
    is seen to pick: the last bit of a float32 sum depends on it."""
    configure_numerics()      # true float32 products on a card, no TF32
    H, W = img.shape[-3:-1]
    new_h, new_w = int(size[0]), int(size[1])
    out = img.to(torch.float32)

    def rows(x):
        if new_h == H:
            return x
        wh = weight_tensor(H, new_h, method, antialias, img.device)
        return torch.einsum("oh,...hwc->...owc", wh, x)

    def cols(x):
        if new_w == W:
            return x
        ww = weight_tensor(W, new_w, method, antialias, img.device)
        return torch.einsum("pw,...hwc->...hpc", ww, x)

    cost_cols = H * W * new_w + H * new_w * new_h
    cost_rows = H * W * new_h + new_h * W * new_w
    cols_first = cost_cols < cost_rows
    return rows(cols(out)) if cols_first else cols(rows(out))
