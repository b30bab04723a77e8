# test_torch_sparse.py — the port's block-sparse codec against the JAX one.
"""ops/sparse.py of the port against the JAX package's, on the CPU: the
same u8 frames (the port's rendered 128x128 frames and grids, and the
hand-built frames of test_torch_rle.py) through both ``pack_batch``, at a
budget that holds every frame and at one that some frames overflow.  The
mask, the blocks and the counts must be equal element for element, and
``unpack_frame`` must give back every frame within its budget."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.ops import sparse as jax_sparse
from reasoning_image_generation_tpu_torch.ops import sparse

from .test_torch_rle import SET_NAMES, assert_same, frame_set

torch.set_num_threads(1)


@pytest.mark.parametrize("frac", [0.35, 1.0])
@pytest.mark.parametrize("name", SET_NAMES)
def test_pack_batch_matches_jax(name, frac):
    frames = frame_set(name)[0]
    H, W = frames.shape[-3:-1]
    budget = max(1, int(sparse.n_blocks(H, W) * frac))
    got = sparse.pack_batch(torch.from_numpy(frames), budget)
    assert_same(jax_sparse.pack_batch(jnp.asarray(frames), budget), got, name)
    mask, vals, count = (a.numpy() for a in got)
    flat = frames.reshape((-1,) + frames.shape[-3:])
    m2, v2 = mask.reshape(len(flat), -1), vals.reshape(len(flat), budget, -1)
    for i, want in enumerate(flat):
        c = int(count.reshape(-1)[i])
        if c > budget:
            with pytest.raises(OverflowError):
                sparse.unpack_frame(m2[i], v2[i], c, (H, W))
        else:
            assert np.array_equal(sparse.unpack_frame(m2[i], v2[i], c,
                                                      (H, W)), want)


def test_n_blocks_and_background():
    assert sparse.n_blocks(128, 64) == 128
    with pytest.raises(AssertionError):
        sparse.n_blocks(100, 64)
    # a white frame has no block; a frame with one dark pixel has one
    frames = np.full((2, 64, 64, 3), 255, np.uint8)
    frames[1, 17, 40] = (0, 10, 20)
    mask, vals, count = sparse.pack_batch(torch.from_numpy(frames), 3)
    assert count.tolist() == [0, 1]
    assert mask[0].sum() == 0 and int(mask[1].bool().sum()) == 1
    # block (2, 5) in raster order of 8 x 8 blocks: bit 21, MSB first
    assert np.unpackbits(mask[1].numpy()).nonzero()[0].tolist() == [21]
    assert (vals[1, 0].reshape(8, 8, 3)[1, 0] == torch.tensor([0, 10, 20],
                                                              dtype=torch.uint8)).all()


def test_pack_frame_matches_jax():
    """The per-frame entry point on each hand-built frame, at a budget some
    of them overflow."""
    frames = frame_set("hand")[0]
    for i, f in enumerate(frames):
        assert_same(jax_sparse.pack_frame(jnp.asarray(f), 20),
                    sparse.pack_frame(torch.from_numpy(f), 20), f"frame {i}")
