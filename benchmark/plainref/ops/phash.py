# phash.py — batched 64-bit pHash and streaming corpus dedup.
"""The JAX package's ops/phash.py for a batch of images on one device:
grayscale -> 32x32 antialiased linear resize (the weight matrices of
``ops/resize.py``) -> 2-D DCT-II as two matmuls -> bits of the 8x8
low-frequency block against its median -> 8 bytes.  Dedup is greedy
first-wins by Hamming distance, against a corpus of kept hashes that
stays on the device; the keep mask is computed there too, so a generator
can ship it inside its batch's blob.  One batch's dedup is the pure step
``dedup_append_step``, which a card replays as a CUDA graph.  On a device
mesh the keep mask of the per-device hash shards comes from
``parallel/mesh.py``'s ``sharded_dedup_mask``, which gathers them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import constant
from .resize import weight_tensor

HASH_SIDE = 32
LOW = 8


def _dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2.0 * n))
    m[0] /= np.sqrt(2.0)
    return m.astype(np.float32)


_DCT = _dct_matrix(HASH_SIDE)
_GRAY = np.asarray([0.299, 0.587, 0.114], np.float32)


def phash(imgs: torch.Tensor) -> torch.Tensor:
    """u8 ``[N, H, W, 3]`` -> u8 ``[N, 8]`` (row-packed bits, LSB first)."""
    dev = imgs.device
    H, W = imgs.shape[1:3]
    gray = imgs.float() @ constant("gray", dev, lambda: _GRAY)     # [N, H, W]
    wh = weight_tensor(H, HASH_SIDE, "linear", True, dev)          # [32, H]
    ww = weight_tensor(W, HASH_SIDE, "linear", True, dev)          # [32, W]
    small = wh @ gray @ ww.T                                       # [N, 32, 32]
    dct = constant("dct", dev, lambda: _DCT)
    freq = dct @ small @ dct.T
    block = freq[:, :LOW, :LOW].reshape(-1, LOW * LOW)
    srt = torch.sort(block, dim=-1).values
    med = srt[:, 31:32] * 0.5 + srt[:, 32:33] * 0.5   # numpy-style median
    bits = (block > med).reshape(-1, LOW, LOW).to(torch.int32)
    weights = 2 ** torch.arange(LOW, dtype=torch.int32, device=dev)
    return (bits * weights).sum(-1).to(torch.uint8)


# the JAX package's name for the batched hash (its ``phash`` takes one image)
phash_batch = phash


_POPCOUNT = np.asarray([bin(i).count("1") for i in range(256)], np.int32)


def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distances between hash rows: a ``[N, 8]``, b ``[M, 8]`` ->
    i32 ``[N, M]``."""
    x = (a[:, None, :] ^ b[None, :, :]).long()
    return constant("popcount", a.device, lambda: _POPCOUNT)[x].sum(-1)
