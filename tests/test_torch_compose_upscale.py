# test_torch_compose_upscale.py — the grid composer where a cell is at least
# as large as its frame.
"""``fit_into_cell`` and ``compose_grid`` of the port against the JAX
package's, with frames that are smaller than the layout's cell (the cubic
upscale of ops/resize.py), exactly its size (``scale == 1.0``: the frame
unchanged) and not square (one axis fits, the other is centred on white).

Tolerance: exact on the rounded u8 cell and grid, but for the last test,
which says why.  The frames are flat
blocks, lines and a band of noise on white, as rendered frames are, and
at least 32 pixels a side where they are resized: under 32 input taps the
cubic weights can differ from jax's in the last bit
(tests/test_torch_resize.py, NEAR).
"""
import jax
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.ops import compose as jax_compose
from reasoning_image_generation_tpu_torch.ops import compose

from .test_torch_compose_phash import _frames

torch.set_num_threads(1)


def _u8(x):
    return np.clip(np.round(np.asarray(x)), 0, 255).astype(np.uint8)


# (frame height, frame width, cell)
FIT_CASES = [(32, 32, 64), (64, 64, 118), (40, 40, 40), (118, 118, 118),
             (36, 72, 108), (72, 36, 108), (22, 22, 23), (100, 118, 118),
             (41, 37, 123)]


@pytest.mark.parametrize("Hs,Ws,cell", FIT_CASES)
def test_fit_into_cell_matches_jax(Hs, Ws, cell):
    imgs = _frames(np.random.default_rng(Hs * 7 + Ws), (3, Hs, Ws, 3))
    got = compose.fit_into_cell(torch.from_numpy(imgs), cell)
    assert got.shape == (3, cell, cell, 3) and got.dtype == torch.float32
    fit = jax.jit(lambda x: jax_compose.fit_into_cell(x, cell))
    for i in range(3):
        want = _u8(fit(imgs[i]))
        assert np.array_equal(_u8(got[i].numpy()), want), \
            f"frame {i}: {int((_u8(got[i].numpy()) != want).sum())} bytes"
    if (Hs, Ws) == (cell, cell):            # scale == 1.0: the frame itself
        assert np.array_equal(_u8(got.numpy()), imgs)


# (canvas side of a baked layout, shown states, frame side): the cell is
# 118 (78 with 5 shown states) on the 512 canvas and 22 on the 128 one
GRID_CASES = [(512, 3, 64), (512, 5, 50), (512, 5, 78), (512, 3, 118),
              (128, 3, 22)]


@pytest.mark.parametrize("S,n_states,frame", GRID_CASES)
def test_compose_grid_with_small_frames_matches_jax(S, n_states, frame):
    rng = np.random.default_rng(S + frame)
    B, O = 2, 4
    states = _frames(rng, (B, n_states, frame, frame, 3))
    options = _frames(rng, (B, O, frame, frame, 3))
    jl = jax_compose.build_layout(S, S, n_states=n_states, num_options=O)
    tl = compose.build_layout(S, S, n_states=n_states, num_options=O)
    assert tl.cell_size >= frame
    want = jax.jit(jax.vmap(lambda s, o: jax_compose.compose_grid(
        jl, s, o)))(states, options)
    got = compose.compose_grid(tl, torch.from_numpy(states),
                               torch.from_numpy(options))
    assert got.shape == (B, jl.grid_h, S, 3)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_compose_grid_where_the_summation_order_shows():
    """72 -> 78: the weights are jax's bit for bit, but XLA's matrix product
    and torch's add the same float32 products in different orders, and a
    byte on k + 0.5 may fall the other way.  Bound: 1, on at most 0.1% of
    the grid's bytes; the count is printed."""
    rng = np.random.default_rng(5)
    states = _frames(rng, (2, 5, 72, 72, 3))
    options = _frames(rng, (2, 4, 72, 72, 3))
    jl = jax_compose.build_layout(512, 512, n_states=5, num_options=4)
    tl = compose.build_layout(512, 512, n_states=5, num_options=4)
    want = np.asarray(jax.jit(jax.vmap(lambda s, o: jax_compose.compose_grid(
        jl, s, o)))(states, options)).astype(int)
    got = compose.compose_grid(tl, torch.from_numpy(states),
                               torch.from_numpy(options)).numpy().astype(int)
    diff = np.abs(got - want)
    print(f"{int((diff > 0).sum())} of {diff.size} bytes differ, max "
          f"{int(diff.max())}")
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
