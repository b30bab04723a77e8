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

from ..device import constant, upload
from ..utils import graphs
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


def hamming_matrix(hashes: torch.Tensor) -> torch.Tensor:
    return _hamming(hashes, hashes)


def dedup_keep_mask_vs_corpus(corpus: torch.Tensor, corpus_count,
                              hashes: torch.Tensor,
                              threshold: int = 4) -> torch.Tensor:
    """Greedy first-wins dedup of `hashes` against the first
    `corpus_count` rows of `corpus` (an int, or a 0-d tensor on the
    device) and against earlier kept batch rows -> bool keep mask on the
    device.  Nothing here waits for the device."""
    n = hashes.shape[0]
    dev = hashes.device
    live = torch.arange(corpus.shape[0], device=dev) < corpus_count
    dup = ((_hamming(hashes, corpus) <= threshold) & live).any(1)
    near = hamming_matrix(hashes) <= threshold
    keep = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(n):
        keep[i] = ~(dup[i] | (near[i, :i] & keep[:i]).any())
    return keep


def dedup_keep_mask(hashes: torch.Tensor, threshold: int = 4) -> torch.Tensor:
    """Greedy first-wins dedup within one batch: keep[i] unless a kept j < i
    is within `threshold` bits -> bool keep mask on the device."""
    return dedup_keep_mask_vs_corpus(hashes[:0], 0, hashes, threshold)


def _append_kept(corpus: torch.Tensor, count, hashes: torch.Tensor,
                 keep: torch.Tensor, n_valid):
    """The kept rows of `hashes` appended to `corpus` at rows count..;
    rows at n_valid and after are padding and never kept, and kept rows
    past the corpus's capacity are dropped (the JAX ``mode="drop"``: they
    go to a dump row that is cut off).  Writes none of its inputs.  ->
    (keep, new corpus, new count as a 0-d tensor)."""
    cap = corpus.shape[0]
    keep = keep & (torch.arange(hashes.shape[0], device=hashes.device)
                   < n_valid)
    pos = count + torch.cumsum(keep, 0) - 1
    out = torch.cat([corpus, corpus.new_zeros((1,) + corpus.shape[1:])])
    out[torch.where(keep & (pos < cap), pos, cap)] = hashes
    return keep, out[:cap], count + keep.sum()


def dedup_append_step(corpus: torch.Tensor, count, hashes: torch.Tensor,
                      n_valid, threshold: int = 4):
    """One batch of corpus dedup on the device, as a pure step: the
    batch's keep mask against the first `count` rows of `corpus` and its
    own earlier kept rows, and the corpus with the kept hashes appended
    (``_append_kept``).  `count` and `n_valid` are 0-d tensors (or ints);
    `threshold` is static.  -> (keep, new corpus, new count); on a card
    ``CorpusDedup`` replays it as a CUDA graph."""
    keep = dedup_keep_mask_vs_corpus(corpus, count, hashes, threshold)
    return _append_kept(corpus, count, hashes, keep, n_valid)


def dedup_images(imgs, threshold: int = 4, device="cuda"):
    """Hashes and keep mask of a u8 image batch ``[N, H, W, 3]`` -> (u8
    ``[N, 8]``, bool ``[N]``).  A tensor is hashed on its own device; an
    array goes to `device`, which must be named for the CPU."""
    if not isinstance(imgs, torch.Tensor):
        imgs = torch.from_numpy(np.ascontiguousarray(imgs, np.uint8)).to(
            device)
    h = phash(imgs)
    return h, dedup_keep_mask(h, threshold)


class CorpusDedup:
    """Streaming corpus dedup for one run: the hashes of kept samples in a
    device buffer sized to the run, advanced once a batch.  ``submit`` is
    called per batch in generation order and returns a handle ("dev", keep
    mask on the device, n_real): the mask can ride in the batch's blob;
    ``resolve`` copies it to the host.

    `hashes` is one tensor or, on a device mesh (``parallel/mesh.Mesh``),
    a list of per-device shards.  One tensor goes through
    ``dedup_append_step``, replayed on a card as a CUDA graph per (batch,
    capacity, threshold, device) (utils/graphs.py): the corpus and its
    count are the step's inputs and come back as its cloned outputs, so
    the state lives outside the graphs' pool and the warm runs of a
    capture append nothing.  The shards' keep mask against the corpus
    comes from ``sharded_dedup_mask``, eagerly; the decisions are those
    of one device, batch for batch."""

    def __init__(self, capacity_hint: int, device, threshold: int = 4,
                 mesh=None):
        cap = 4096
        while cap < capacity_hint:
            cap *= 2
        self.threshold = int(threshold)
        self.mesh = mesh
        self._corpus = torch.zeros((cap, 8), dtype=torch.uint8, device=device)
        self._count = torch.zeros((), dtype=torch.int64, device=device)
        self._step = graphs.StepGraphs(dedup_append_step)

    def submit(self, hashes, n_real: int):
        home = self._corpus.device
        if isinstance(hashes, torch.Tensor):
            keep, self._corpus, self._count = self._step(
                self._corpus, self._count, hashes,
                upload(n_real, torch.int64, home), threshold=self.threshold)
            return ("dev", keep, n_real)
        from ..parallel.mesh import sharded_dedup_mask
        keep = torch.cat([k.to(home) for k in sharded_dedup_mask(
            self.mesh, hashes, self.threshold, corpus=self._corpus,
            corpus_count=self._count)])
        keep, self._corpus, self._count = _append_kept(
            self._corpus, self._count, torch.cat([h.to(home) for h in hashes]),
            keep, n_real)
        return ("dev", keep, n_real)

    def resolve(self, handle) -> np.ndarray:
        """The bool keep mask ``[n_real]`` of a submitted batch."""
        _kind, keep, n_real = handle
        return keep[:n_real].cpu().numpy()
