# sparse.py — lossless 8x8 block-sparse codec for the device-to-host copy.
"""The JAX package's ops/sparse.py on torch tensors, batched over frames.

Each frame packs on the device into a 1-bit mask of its non-background
8x8 blocks (MSB first, as ``np.unpackbits`` reads it), its first `budget`
blocks in the order non-background first, raster order within each kind
(a stable argsort), and its count of non-background blocks.  The host
rebuilds the frame exactly; a frame with more blocks than the budget
raises OverflowError and is fetched raw.
"""
from __future__ import annotations

import numpy as np
import torch

BS = 8  # block side


def n_blocks(H: int, W: int) -> int:
    assert H % BS == 0 and W % BS == 0, (H, W)
    return (H // BS) * (W // BS)


def _to_blocks(fr: torch.Tensor) -> torch.Tensor:
    """u8 ``[F, H, W, 3]`` -> ``[F, NB, 192]`` in raster order of blocks."""
    F, H, W = fr.shape[:3]
    b = fr.reshape(F, H // BS, BS, W // BS, BS, 3).permute(0, 1, 3, 2, 4, 5)
    return b.reshape(F, (H // BS) * (W // BS), BS * BS * 3)


def pack_batch(imgs: torch.Tensor, budget: int, bg: int = 255):
    """u8 ``[..., H, W, 3]`` -> (mask u8 ``[..., NB/8]``, blocks u8
    ``[..., budget, 192]``, count int32 ``[...]``); `budget` counts blocks."""
    lead = tuple(imgs.shape[:-3])
    fr = imgs.reshape((-1,) + tuple(imgs.shape[-3:]))
    blocks = _to_blocks(fr)
    F = blocks.shape[0]
    nonbg = (blocks != bg).any(-1)                          # [F, NB]
    count = nonbg.sum(1, dtype=torch.int32)
    w = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=imgs.device)
    mask = (nonbg.reshape(F, -1, 8).to(torch.int32) * w).sum(-1)
    order = torch.argsort((~nonbg).to(torch.uint8), dim=1, stable=True)
    vals = torch.gather(blocks, 1, order[:, :budget, None].expand(
        F, budget, blocks.shape[2]))
    return (mask.to(torch.uint8).reshape(lead + (mask.shape[1],)),
            vals.reshape(lead + tuple(vals.shape[1:])), count.reshape(lead))


# one frame u8 [H, W, 3]: pack_batch takes any leading shape, none included
pack_frame = pack_batch


def unpack_frame(mask: np.ndarray, vals: np.ndarray, count: int,
                 shape, bg: int = 255) -> np.ndarray:
    """Exact reconstruction on the host; OverflowError when the frame had
    more blocks than the budget."""
    H, W = shape[:2]
    nb0, nb1 = H // BS, W // BS
    nb = nb0 * nb1
    if count > vals.shape[0]:
        raise OverflowError(f"sparse frame overflow: {count} > {vals.shape[0]}")
    bits = np.unpackbits(np.asarray(mask))[:nb].astype(bool)
    blocks = np.full((nb, BS * BS * 3), bg, np.uint8)
    blocks[bits] = np.asarray(vals)[:count]
    img = blocks.reshape(nb0, nb1, BS, BS, 3).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(H, W, 3))
