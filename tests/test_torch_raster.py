# test_torch_raster.py — the port's plain rasterizer against the JAX package.
"""ops/raster.py (the plain PyTorch version of the CUDA kernel K1) against
the JAX package's Pallas kernel in interpret mode and its jitted jnp
render_frame.

Tolerance: maxdiff 0 everywhere.  From identical prepared inputs (the
JAX prep's meta and outlines handed over as numpy) the compositing pass
must match byte for byte; through each side's own prepare_render_data the
measured bound is also 0, because the port reproduces the fused
multiply-adds XLA's CPU backend forms (ops/raster.py docstring)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.ops.raster import render_frame
from reasoning_image_generation_tpu.ops.raster_pallas import (
    prepare_render_data as jax_prep, render_batch_pallas)
from reasoning_image_generation_tpu.utils.config import SHAPE_KINDS
from reasoning_image_generation_tpu.utils.state import (
    dicts_to_state as jax_dicts_to_state)
from reasoning_image_generation_tpu_torch.ops import raster, raster_cuda
from reasoning_image_generation_tpu_torch.utils.state import from_numpy

torch.set_num_threads(1)

# one compiled program per (canvas, grid mode), shared by every case
_render_frame = jax.jit(render_frame, static_argnames=("W", "H", "use_grid"))


def _elem(kind, size=140, center=(256, 256), angle=45.0, color=(40, 80, 200)):
    return {"kind": kind, "size": size, "fill": True, "stroke_width": 2,
            "center": center, "angle": angle, "bbox": (0, 0, size, size),
            "flip": {"h": False, "v": False}, "color": color}


# the element sets of tests/test_raster_pallas.py
WRAP_GATE = ([_elem("hexagon", 40, (60, 32), angle=30.0),
              _elem("circle", 30, (140, 30), color=(200, 30, 30)),
              _elem("plus", 40, (200, 32 + 2 * 64), angle=0.0),  # 2 canvases off
              _elem("star", 36, (250, 40), color=(30, 160, 60))], 256, 64)
MULTITILE = ([_elem("hexagon", 90, (580, 100), angle=30.0),
              _elem("heart", 70, (40, 190), color=(30, 160, 60)),
              _elem("star", 80, (510, 60), color=(200, 30, 30)),
              _elem("circle", 60, (300, 64))], 600, 200)


def _batch(els):
    st = jax_dicts_to_state(els, 8)
    return st, jax.tree.map(lambda a: np.asarray(a)[None], st)


@pytest.mark.parametrize("case", [WRAP_GATE, MULTITILE],
                         ids=["wrap_gate_256x64", "multitile_600x200"])
@pytest.mark.parametrize("use_grid", [False, True])
def test_plain_vs_pallas_interpret(case, use_grid):
    els, W, H = case
    st, batch = _batch(els)
    ug = np.array([use_grid])
    want = np.asarray(render_batch_pallas(
        jax.tree.map(jnp.asarray, batch), W, H, ug, interpret=True))[0]
    got = raster.render_frames(from_numpy(batch), W, H, torch.tensor(ug))[0]
    assert got.shape == (H, W, 3)
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("case", [WRAP_GATE, MULTITILE],
                         ids=["wrap_gate_256x64", "multitile_600x200"])
def test_compositing_from_jax_prepared_inputs(case):
    """The compositing pass alone, fed the JAX prep's meta/outlines."""
    els, W, H = case
    st, batch = _batch(els)
    for use_grid in (False, True):
        meta, vx, vy = jax.jit(lambda s: jax_prep(s, W, H, use_grid))(st)
        got = raster.render_prepared(
            torch.from_numpy(np.array(meta))[None],
            torch.from_numpy(np.array(vx))[None],
            torch.from_numpy(np.array(vy))[None],
            torch.tensor([use_grid]), W, H, 3)[0].numpy()
        want = np.asarray(_render_frame(st, W=W, H=H, use_grid=use_grid))
        assert (got == want).all()


@pytest.mark.parametrize("kind", SHAPE_KINDS)
def test_all_kinds_vs_render_frame_128(kind):
    S = 128
    els = [_elem(kind, size=36, center=(64, 64), angle=45.0),
           _elem("circle", 20, (105, 25), color=(200, 30, 30)),
           _elem(kind, size=30, center=(120, 120), angle=135.0,
                 color=(30, 160, 60))]                    # wraps both edges
    st, batch = _batch(els)
    for use_grid in (False, True):
        want = np.asarray(_render_frame(st, W=S, H=S, use_grid=use_grid))
        got = raster.render_frames(from_numpy(batch), S, S,
                                   torch.tensor([use_grid]))[0].numpy()
        assert (got == want).all(), (kind, use_grid)


def test_prepare_render_data_matches_jitted_jax():
    rng = np.random.default_rng(0)
    N, E, W, H = 64, 8, 512, 512
    els = [[{"kind": SHAPE_KINDS[int(rng.integers(11))],
             "size": int(rng.integers(8, 200)), "fill": bool(rng.random() < .6),
             "stroke_width": int(rng.integers(1, 4)),
             "center": (float(rng.integers(-100, 600)),
                        float(rng.integers(-100, 600))),
             "angle": float(rng.integers(0, 360)),
             "color": tuple(int(c) for c in rng.integers(30, 220, 3))}
            for _ in range(int(rng.integers(1, E + 1)))] for _ in range(N)]
    sts = [jax_dicts_to_state(e, E) for e in els]
    batch = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *sts)
    ug = rng.random(N) < 0.5
    want = jax.jit(jax.vmap(lambda s, g: jax_prep(s, W, H, g)))(
        jax.tree.map(jnp.asarray, batch), jnp.asarray(ug))
    got = raster.prepare_render_data(from_numpy(batch), W, H, torch.tensor(ug))
    for w, g in zip(want, got):
        assert (np.asarray(w) == g.numpy()).all()


def test_dispatch_cpu_uses_plain_version():
    els, W, H = WRAP_GATE
    _, batch = _batch(els)
    before = raster_cuda.LAUNCHES
    st = from_numpy(batch)
    got = raster_cuda.render_frames(st, W, H, torch.tensor([True]))
    want = raster.render_frames(st, W, H, torch.tensor([True]))
    assert torch.equal(got, want)
    assert raster_cuda.LAUNCHES == before


def test_cuda_wrapper_refuses_cpu_tensors():
    meta = torch.zeros(1, 8, raster.NMETA)
    v = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError):
        raster_cuda.render_prepared_cuda(meta, v, v, torch.zeros(1, dtype=bool),
                                         64, 64)
