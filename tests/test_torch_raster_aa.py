# test_torch_raster_aa.py — render_frame's antialias modes, flips and colours.
"""ops/raster.py ``render_batch`` / ``render_frame`` of the port against the
JAX package's jitted jnp ``render_frame`` on the same element states (numpy,
from a seed): 'fast', 'soft', 'hq' at scale 2 and 3, ``honor_flip`` on and
off, strokes 1 to 6 (2 to 18 after supersampling), every kind, grid on and
off, a background colour.

Tolerance.  'fast', 'hq' and the flips: exact, byte for byte.  'soft': the
fill alpha is ``0.5 * (1 - erf(sd * c))``, and XLA's float32 ``erf`` (a
rational approximation) and torch's differ in the last places; the test
counts the differing bytes, prints their share, and holds them to a
difference of 1 on at most 0.1% of the bytes of the frames.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.ops import raster as jax_raster
from reasoning_image_generation_tpu.utils.config import SHAPE_KINDS
from reasoning_image_generation_tpu.utils.state import (
    dicts_to_state as jax_dicts_to_state)
from reasoning_image_generation_tpu_torch.ops import raster, raster_cuda
from reasoning_image_generation_tpu_torch.utils.state import from_numpy

torch.set_num_threads(1)

S = 96            # canvas side
E = 4             # element slots
SOFT_SHARE = 1e-3


def _frames():
    """One frame per kind and stroke: the kind at strokes 1..6 over the
    frames, flipped in every way, a second element that wraps across an
    edge, a third that is two canvases off (the wrap gate), fills on and
    off."""
    rng = np.random.default_rng(11)
    frames = []
    for i, kind in enumerate(list(SHAPE_KINDS) + ["plus", "star", "heart"]):
        stroke = 1 + i % 6
        els = [{"kind": kind, "size": int(rng.integers(20, 40)),
                "fill": bool(i % 3), "stroke_width": stroke,
                "center": (float(rng.integers(25, 70)),
                           float(rng.integers(25, 70))),
                "angle": float(rng.integers(0, 360)) + 0.5,
                "flip": {"h": bool(i & 1), "v": bool(i & 2)},
                "color": tuple(int(c) for c in rng.integers(30, 221, 3))},
               {"kind": SHAPE_KINDS[int(rng.integers(len(SHAPE_KINDS)))],
                "size": 24, "fill": True, "stroke_width": 1 + (i + 3) % 6,
                "center": (float(rng.integers(-8, 8)), float(S - 5)),
                "angle": float(rng.integers(0, 360)),
                "flip": {"h": True, "v": False},
                "color": tuple(int(c) for c in rng.integers(30, 221, 3))},
               {"kind": "hexagon", "size": 20, "fill": True,
                "stroke_width": 2, "center": (30.0 + 2 * S, 40.0),
                "angle": 0.0, "flip": {"h": False, "v": False},
                "color": (10, 200, 10)}]
        frames.append(jax_dicts_to_state(els, E))
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *frames)


FRAMES = _frames()
N = FRAMES.kind.shape[0]
USE_GRID = np.arange(N) % 2 == 1
_programs = {}


def _jax_render(mode, scale, flip, bg=(255.0, 255.0, 255.0)):
    key = (mode, scale, flip, bg)
    if key not in _programs:
        _programs[key] = jax.jit(jax.vmap(
            lambda s, g: jax_raster.render_frame(
                s, S, S, bg_color=bg, use_grid=g, honor_flip=flip,
                antialias_mode=mode, scale=scale)))
    return np.asarray(_programs[key](jax.tree.map(jnp.asarray, FRAMES),
                                     jnp.asarray(USE_GRID)))


def _port_render(mode, scale, flip, bg=(255.0, 255.0, 255.0)):
    return raster.render_batch(from_numpy(FRAMES), S, S,
                               torch.from_numpy(USE_GRID), bg_color=bg,
                               honor_flip=flip, antialias_mode=mode,
                               scale=scale).numpy()


def test_the_frames_cover_what_they_claim():
    assert set(np.round(FRAMES.stroke[FRAMES.valid]).astype(int)) == \
        {1, 2, 3, 4, 5, 6}
    assert set(FRAMES.kind[FRAMES.valid]) == set(range(len(SHAPE_KINDS)))
    assert FRAMES.flip_h.any() and FRAMES.flip_v.any()
    assert USE_GRID.any() and not USE_GRID.all()


@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize("mode,scale", [("fast", 1), ("hq", 2), ("hq", 3)],
                         ids=["fast", "hq2", "hq3"])
def test_fast_and_hq_are_exact(mode, scale, flip):
    want = _jax_render(mode, scale, flip)
    got = _port_render(mode, scale, flip)
    assert got.shape == want.shape == (N, S, S, 3)
    bad = [i for i in range(N) if not np.array_equal(got[i], want[i])]
    assert not bad, f"frames {bad} differ, by up to " \
        f"{np.abs(got.astype(int) - want).max()}"


def test_flips_change_the_frames():
    """honor_flip is not a no-op on these frames: a test that passes with
    flips ignored on both sides would show nothing."""
    off = _port_render("fast", 1, False)
    on = _port_render("fast", 1, True)
    assert (off != on).any()


@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
def test_soft_is_within_one_on_a_counted_share(flip):
    want = _jax_render("soft", 1, flip).astype(int)
    got = _port_render("soft", 1, flip).astype(int)
    diff = np.abs(got - want)
    share = float((diff > 0).mean())
    print(f"soft, flip={flip}: {int((diff > 0).sum())} of {diff.size} bytes "
          f"differ (share {share:.2e}), max {int(diff.max())}")
    assert diff.max() <= 1
    assert share <= SOFT_SHARE
    # and soft is not fast: the fill edges are widened
    assert (got != _port_render("fast", 1, flip)).mean() > 1e-3


def test_background_colour_fast_and_hq():
    bg = (200.0, 220.0, 90.0)
    for mode, scale in (("fast", 1), ("hq", 2)):
        assert np.array_equal(_port_render(mode, scale, False, bg),
                              _jax_render(mode, scale, False, bg)), mode


def test_render_frame_is_one_frame_of_render_batch():
    st = from_numpy(FRAMES)
    for i, mode in ((0, "fast"), (3, "hq"), (5, "soft")):
        one = raster.render_frame(st.map(lambda a: a[i]), S, S,
                                  use_grid=bool(USE_GRID[i]),
                                  antialias_mode=mode, honor_flip=True)
        batch = raster.render_batch(st.map(lambda a: a[i:i + 1]), S, S,
                                    torch.from_numpy(USE_GRID[i:i + 1]),
                                    antialias_mode=mode, honor_flip=True)
        assert one.shape == (S, S, 3) and torch.equal(one, batch[0])
    with pytest.raises(ValueError, match="antialias_mode"):
        raster.render_frame(st.map(lambda a: a[0]), S, S,
                            antialias_mode="best")


@pytest.mark.parametrize("stroke", [4, 6, 8, 12])
def test_wide_strokes_follow_the_jnp_band(stroke):
    """The supersampled 'hq' render sees strokes of 4 and more, where the
    jnp renderer's band is ``ceil(t/2) + 1.28`` (in float32 not the same
    number as ``ceil(t/2) + 1 + 0.28`` at strokes 5 and 6): the plain
    version of the kernel must give the jnp renderer's bytes there."""
    els = [{"kind": k, "size": 50, "fill": bool(j), "stroke_width": stroke,
            "center": (40.0 + 30 * j, 60.0 - 20 * j), "angle": 20.0 + 35 * j,
            "color": (40, 80, 200)}
           for j, k in enumerate(("pentagon", "circle", "crescent"))]
    st = jax_dicts_to_state(els, E)
    want = np.asarray(jax.jit(lambda s: jax_raster.render_frame(s, 128, 128))(
        st))
    batch = jax.tree.map(lambda a: np.asarray(a)[None], st)
    got = raster.render_frames(from_numpy(batch), 128, 128,
                               torch.zeros(1, dtype=torch.bool))[0].numpy()
    assert np.array_equal(got, want)


def test_hq_inner_render_goes_through_the_dispatching_wrapper(monkeypatch):
    """'hq' renders its supersampled frames through
    raster_cuda.render_frames (on a card: the kernel) at scale times the
    size, with no grid and strokes scaled."""
    seen = {}
    real = raster_cuda.render_frames

    def spy(states, W, H, use_grid, grid_size=3, honor_flip=False):
        seen.update(W=W, H=H, grid=bool(use_grid.any()),
                    stroke=float(states.stroke.max()), flip=honor_flip)
        return real(states, W, H, use_grid, grid_size, honor_flip)

    monkeypatch.setattr(raster_cuda, "render_frames", spy)
    raster.render_batch(from_numpy(FRAMES), S, S, torch.from_numpy(USE_GRID),
                        antialias_mode="hq", scale=2, honor_flip=True)
    assert seen == {"W": 2 * S, "H": 2 * S, "grid": False, "stroke": 12.0,
                    "flip": True}
