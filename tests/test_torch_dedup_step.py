# test_torch_dedup_step.py — the pure corpus dedup step against JAX.
"""ops/phash.py ``dedup_append_step``, the step a card replays as a CUDA
graph inside ``CorpusDedup``, against the JAX package's jitted
``dedup_append_step`` run on the CPU as its own tests run it.  The same
numpy-seeded hash batches (near-duplicates of a few bases, so the keep
masks vary) go through both, batch after batch, each side carrying its
own corpus and count.  Tolerance: exact (keep mask, every corpus row,
count).  Corpus 64 rows, batches of 8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.ops import phash as jax_phash
from reasoning_image_generation_tpu_torch.ops import phash

torch.set_num_threads(1)

CAP, B = 64, 8


def _batches(seed: int, n: int):
    """n batches of B hashes: copies of 6 random bases with a few bits
    flipped, so some rows fall within a threshold of others."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (6, 8), np.uint8)
    out = []
    for _ in range(n):
        h = base[rng.integers(0, 6, B)]
        flip = (rng.random((B, 8, 8)) < 0.03).astype(np.uint8)
        out.append(h ^ np.packbits(flip, axis=-1, bitorder="little")[..., 0])
    return out


def _start(count: int, seed: int):
    """A corpus of CAP rows whose first `count` are random hashes."""
    corpus = np.zeros((CAP, 8), np.uint8)
    corpus[:count] = np.random.default_rng(seed).integers(0, 256, (count, 8))
    return corpus


@pytest.mark.parametrize("threshold", [4, 12])
@pytest.mark.parametrize("count0,n_valid", [
    (0, (8, 8, 8)),             # an empty corpus, three full batches
    (0, (8, 5, 3)),             # padded batches: rows past n_valid
    (CAP - 3, (8, 6, 8)),       # less than a batch from capacity: kept
                                # rows past it drop
], ids=["three-batches", "padded", "near-capacity"])
def test_dedup_append_step_matches_jax(threshold, count0, n_valid):
    corpus = _start(count0, threshold)
    jc, jn = jnp.asarray(corpus), jnp.int32(count0)
    tc = torch.from_numpy(corpus.copy())
    tn = torch.tensor(count0, dtype=torch.int64)
    for h, nv in zip(_batches(threshold + count0, len(n_valid)), n_valid):
        jk, jc, jn = jax_phash.dedup_append_step(
            jc, jn, jnp.asarray(h), np.int32(nv), threshold=threshold)
        tk, tc, tn = phash.dedup_append_step(
            tc, tn, torch.from_numpy(h), torch.tensor(nv), threshold)
        assert np.array_equal(np.asarray(jk), tk.numpy())
        assert not tk[nv:].any()
        assert np.array_equal(np.asarray(jc), tc.numpy())
        assert int(jn) == int(tn)
    if count0 == CAP - 3:
        # more was kept than the corpus holds: the count runs past it
        assert int(tn) > CAP
    else:
        assert 0 < int(tn) < sum(n_valid)


def test_dedup_append_step_is_pure():
    """Twice on the same inputs: equal outputs, and the input corpus and
    count unchanged (a capture's warm runs append nothing)."""
    corpus = _start(10, 1)
    h = torch.from_numpy(_batches(2, 1)[0])
    tc, tn = torch.from_numpy(corpus.copy()), torch.tensor(10)
    a = phash.dedup_append_step(tc, tn, h, torch.tensor(7), 4)
    b = phash.dedup_append_step(tc, tn, h, torch.tensor(7), 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(tc.numpy(), corpus) and int(tn) == 10
    assert int(a[2]) > 10 and not torch.equal(a[1], tc)
