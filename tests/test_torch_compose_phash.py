# test_torch_compose_phash.py — grid composition, pHash and dedup against JAX.
"""ops/compose.py and ops/phash.py of the port against the JAX package's,
on the same numpy-seeded inputs.  Tolerance: exact (grid bytes, hash bytes,
Hamming distances and keep masks); both sides run the area resample and
the pHash products in true float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.ops import compose as jax_compose
from reasoning_image_generation_tpu.ops import phash as jax_phash
from reasoning_image_generation_tpu_torch.ops import compose, phash

torch.set_num_threads(1)

# (canvas side, shown states, labels, border): both sequence lengths, and
# each labels/border combination once
LAYOUTS = [(128, 3, True, True), (512, 3, True, True), (512, 5, False, True),
           (512, 3, True, False), (512, 5, False, False)]


def _frames(rng, shape):
    """White frames with random coloured blocks and a band of noise."""
    imgs = np.full(shape, 255, np.uint8)
    H, W = shape[-3:-1]
    for idx in np.ndindex(shape[:-3]):
        for _ in range(3):
            y, x = rng.integers(0, H - 8), rng.integers(0, W - 8)
            h, w = rng.integers(4, H - y), rng.integers(4, W - x)
            imgs[idx][y:y + h, x:x + w] = rng.integers(0, 256, 3)
        y = rng.integers(0, H - 4)
        imgs[idx][y:y + 4] = rng.integers(0, 256, (4, W, 3))
    return imgs


@pytest.mark.parametrize("S,n_states,labels,border", LAYOUTS)
def test_compose_grid_matches_jax(S, n_states, labels, border):
    rng = np.random.default_rng(S + n_states)
    B, O = 2, 4
    states = _frames(rng, (B, n_states, S, S, 3))
    options = _frames(rng, (B, O, S, S, 3))
    jl = jax_compose.build_layout(S, S, n_states=n_states, num_options=O,
                                  show_labels=labels, show_border=border)
    tl = compose.build_layout(S, S, n_states=n_states, num_options=O,
                              show_labels=labels, show_border=border)
    want = jax.jit(jax.vmap(lambda s, o: jax_compose.compose_grid(
        jl, s, o)))(states, options)
    got = compose.compose_grid(tl, torch.from_numpy(states),
                               torch.from_numpy(options))
    assert got.shape == (B, jl.grid_h, S, 3)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_fit_into_cell_upscale_is_not_ported():
    """The name is from when the cubic branch raised; it is ported now and
    must give the JAX package's cell (exact after rounding to u8); the
    other sizes are in tests/test_torch_compose_upscale.py."""
    img = _frames(np.random.default_rng(5), (1, 32, 32, 3))
    got = compose.fit_into_cell(torch.from_numpy(img), 64)
    want = jax.jit(lambda x: jax_compose.fit_into_cell(x, 64))(img[0])
    assert got.shape == (1, 64, 64, 3)
    assert np.array_equal(np.round(np.asarray(want)),
                          torch.round(got[0]).numpy())


def test_apply_overlay_u8_matches_jax():
    rng = np.random.default_rng(1)
    c, o = rng.integers(0, 256, (2, 3, 40, 50, 3), dtype=np.uint8)
    a = rng.integers(0, 256, (40, 50), dtype=np.uint8)
    want = jax_compose.apply_overlay_u8(c, o, a)
    got = compose.apply_overlay_u8(*map(torch.from_numpy, (c, o, a)))
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("shape", [(64, 64), (104, 128), (216, 512),
                                   (296, 512), (512, 512)])
def test_phash_matches_jax(shape):
    """The grid shapes of both canvases and sequence lengths, and square
    frames (the antialiased linear resize weights of jax.image.resize)."""
    rng = np.random.default_rng(shape[0])
    imgs = _frames(rng, (6,) + shape + (3,))
    imgs[0] = rng.integers(0, 256, shape + (3,))       # pure noise
    want = np.asarray(jax.jit(jax.vmap(jax_phash.phash))(imgs))
    got = phash.phash(torch.from_numpy(imgs)).numpy()
    assert np.array_equal(want, got)


def _hash_stream(rng, n):
    """Random 64-bit hashes, about half of them a few bits from an earlier
    one, so that a threshold of 4 drops some and keeps others."""
    h = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    for i in range(1, n):
        if rng.random() < 0.5:
            src = h[rng.integers(0, i)].copy()
            bits = np.unpackbits(src)
            flip = rng.choice(64, rng.integers(0, 8), replace=False)
            bits[flip] ^= 1
            h[i] = np.packbits(bits)
    return h


def test_hamming_matrix_matches_jax():
    h = _hash_stream(np.random.default_rng(2), 24)
    want = np.asarray(jax_phash.hamming_matrix(jnp.asarray(h)))
    assert np.array_equal(want, phash.hamming_matrix(torch.from_numpy(h)).numpy())


@pytest.mark.parametrize("threshold", [0, 4, 10])
def test_corpus_dedup_matches_jax(threshold):
    """Batches of 8, the last one padded, through both CorpusDedups: the
    keep masks agree batch by batch."""
    h = _hash_stream(np.random.default_rng(3 + threshold), 45)
    jd = jax_phash.CorpusDedup(len(h), threshold=threshold)
    td = phash.CorpusDedup(len(h), torch.device("cpu"), threshold=threshold)
    n_kept = 0
    for s in range(0, len(h), 8):
        batch = h[s:s + 8]
        n_real = len(batch)
        padded = np.concatenate([batch, np.repeat(batch[-1:], 8 - n_real, 0)])
        want = jd.resolve(jd.submit(jnp.asarray(padded), n_real))
        got = td.resolve(td.submit(torch.from_numpy(padded), n_real))
        assert np.array_equal(want, got), s
        n_kept += int(got.sum())
    assert 0 < n_kept < len(h)


def test_dedup_keep_mask_vs_corpus_matches_jax():
    rng = np.random.default_rng(5)
    corpus = np.zeros((64, 8), np.uint8)
    corpus[:20] = _hash_stream(rng, 20)
    h = _hash_stream(rng, 16)
    h[3] = corpus[7]                                    # a corpus duplicate
    want = np.asarray(jax_phash.dedup_keep_mask_vs_corpus(
        jnp.asarray(corpus), jnp.int32(20), jnp.asarray(h), threshold=4))
    got = phash.dedup_keep_mask_vs_corpus(torch.from_numpy(corpus), 20,
                                          torch.from_numpy(h), threshold=4)
    assert not want[3]
    assert np.array_equal(want, got.numpy())
