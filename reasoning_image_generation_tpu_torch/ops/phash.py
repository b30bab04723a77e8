# phash.py — batched 64-bit pHash and streaming corpus dedup.
"""The JAX package's ops/phash.py for a batch of images on one device:
grayscale -> 32x32 antialiased linear resize (the weight matrices of
``ops/resize.py``) -> 2-D DCT-II as two matmuls -> bits of the 8x8
low-frequency block against its median -> 8 bytes.  Dedup is greedy
first-wins by Hamming distance, against a corpus of kept hashes that
stays on the device.
"""
from __future__ import annotations

import numpy as np
import torch

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
    gray = imgs.float() @ torch.from_numpy(_GRAY).to(dev)          # [N, H, W]
    wh = weight_tensor(H, HASH_SIDE, "linear", True, dev)          # [32, H]
    ww = weight_tensor(W, HASH_SIDE, "linear", True, dev)          # [32, W]
    small = wh @ gray @ ww.T                                       # [N, 32, 32]
    dct = torch.from_numpy(_DCT).to(dev)
    freq = dct @ small @ dct.T
    block = freq[:, :LOW, :LOW].reshape(-1, LOW * LOW)
    srt = torch.sort(block, dim=-1).values
    med = srt[:, 31:32] * 0.5 + srt[:, 32:33] * 0.5   # numpy-style median
    bits = (block > med).reshape(-1, LOW, LOW).to(torch.int32)
    weights = 2 ** torch.arange(LOW, dtype=torch.int32, device=dev)
    return (bits * weights).sum(-1).to(torch.uint8)


_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int32)


def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distances between hash rows: a ``[N, 8]``, b ``[M, 8]`` ->
    i32 ``[N, M]``."""
    x = (a[:, None, :] ^ b[None, :, :]).long()
    return _POPCOUNT.to(a.device)[x].sum(-1)


def hamming_matrix(hashes: torch.Tensor) -> torch.Tensor:
    return _hamming(hashes, hashes)


def dedup_keep_mask_vs_corpus(corpus: torch.Tensor, corpus_count: int,
                              hashes: torch.Tensor,
                              threshold: int = 4) -> torch.Tensor:
    """Greedy first-wins dedup of `hashes` against the first
    `corpus_count` rows of `corpus` and against earlier kept batch rows."""
    n = hashes.shape[0]
    live = corpus[:corpus_count]
    dup_corpus = (_hamming(hashes, live) <= threshold).any(1) \
        if corpus_count else torch.zeros(n, dtype=torch.bool,
                                         device=hashes.device)
    near = (hamming_matrix(hashes) <= threshold).cpu().numpy()
    dup = dup_corpus.cpu().numpy()
    keep = np.zeros(n, bool)
    for i in range(n):
        keep[i] = not (dup[i] or (near[i, :i] & keep[:i]).any())
    return torch.from_numpy(keep).to(hashes.device)


def dedup_append_step(corpus: torch.Tensor, count: int, hashes: torch.Tensor,
                      n_valid: int, threshold: int = 4):
    """One batch of corpus dedup: the keep mask for the batch, and the
    corpus with the kept hashes appended (in place) -> (keep, count)."""
    keep = dedup_keep_mask_vs_corpus(corpus, count, hashes, threshold)
    keep[n_valid:] = False
    kept = hashes[keep]
    corpus[count:count + kept.shape[0]] = kept
    return keep, count + int(kept.shape[0])


class CorpusDedup:
    """Streaming corpus dedup for one run: hashes of kept samples in a
    device buffer sized to the run.  ``submit`` is called per batch in
    generation order; it returns the batch's bool keep mask (on the host)."""

    def __init__(self, capacity_hint: int, device, threshold: int = 4):
        cap = 4096
        while cap < capacity_hint:
            cap *= 2
        self.threshold = int(threshold)
        self._corpus = torch.zeros((cap, 8), dtype=torch.uint8, device=device)
        self._count = 0

    def submit(self, hashes: torch.Tensor, n_real: int) -> np.ndarray:
        keep, self._count = dedup_append_step(
            self._corpus, self._count, hashes, n_real, self.threshold)
        return keep[:n_real].cpu().numpy()
