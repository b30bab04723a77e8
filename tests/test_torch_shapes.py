# test_torch_shapes.py — the port's Shape.draw against the JAX package's.
"""``Shape.draw`` / ``draw_shape`` of both packages on the same images,
centres, angles and keywords, on the CPU (``device="cpu"``): every kind,
each keyword of ``draw`` once, and the cases of tests/test_shape_api.py that
need no reference checkout, run through both packages.

Tolerance.  Exact for 'fast' draws, flips, outlines, wrap-around, the
external overlay in every mode at full opacity, and 'hq' on a flat
canvas ('hq' over noise: within 1 on at most 0.01% of the bytes, see
HQ_CASES).  A fractional
``external_opacity``: within 1 on at most 0.1% of the bytes (the reason is
in that test).  'soft': the fill alpha goes
through ``erf``, whose float32 values differ in the last places between
XLA and torch, so the test allows a difference of 1 on at most 0.1% of the
bytes, and prints the count.  The textures are 40x48: ops/resize.py's weights
are jax's bit for bit from 32 input taps on (tests/test_torch_resize.py
says where they are not, and by how little).
"""
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.models.rpm import shapes as jax_shapes
from reasoning_image_generation_tpu.utils.config import SHAPE_KINDS
from reasoning_image_generation_tpu_torch.models.rpm import shapes

torch.set_num_threads(1)

SOFT_SHARE = 1e-3


def _white(n=128):
    return np.full((n, n, 3), 255, np.uint8)


def _busy(n=96):
    rng = np.random.default_rng(n)
    img = rng.integers(0, 256, (n, n, 3), dtype=np.uint8)
    img[n // 4: n // 2] = 255
    return img


def _texture(h=40, w=48):
    rng = np.random.default_rng(7)
    t = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    t[: h // 3, :, 3] = 255
    t[h // 3: h // 2, :, 3] = 0
    return t


def _both(kind, size, fill, stroke, image, center, **kw):
    want = jax_shapes.Shape(kind, size, fill, stroke).draw(image, center, **kw)
    got = shapes.Shape(kind, size, fill, stroke).draw(image, center,
                                                      device="cpu", **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    return got, want


@pytest.mark.parametrize("kind", SHAPE_KINDS)
def test_every_kind_fast_is_exact(kind):
    for fill, stroke, angle, center in ((True, 2, 30.0, (64, 64)),
                                        (False, 3, 211.5, (5, 120))):
        got, want = _both(kind, 60, fill, stroke, _white(), center,
                          angle=angle, color=(200, 60, 60))
        assert np.array_equal(got, want), (kind, fill)


DRAW_CASES = {
    "outline colour": dict(color=(255, 255, 255), outline=(200, 0, 0)),
    "flip horizontal": dict(color=(0, 0, 0), flip_mode="horizontal"),
    "flip vertical": dict(color=(0, 0, 0), flip_mode="vertical"),
    "flip both": dict(color=(10, 90, 10), flip_mode="both", angle=17.0),
    "hq 2": dict(color=(200, 40, 40), antialias_mode="hq", scale=2),
    "hq 3": dict(color=(200, 40, 40), antialias_mode="hq", scale=3,
                 angle=33.0),
    "hq scale 1 is fast": dict(color=(200, 40, 40), antialias_mode="hq"),
    "external": dict(color=(1, 2, 3), external_image=_texture()),
    "overlay_image alias": dict(color=(1, 2, 3), overlay_image=_texture()),
    "texture alias, rgb": dict(color=(1, 2, 3),
                               texture=_texture()[..., :3].copy()),
    "external size pair": dict(color=(1, 2, 3), external_image=_texture(),
                               external_size=(24, 30), external_only=True),
    "external size factor": dict(color=(1, 2, 3), external_image=_texture(),
                                 external_size=0.5, external_only=True),
    "external size string": dict(color=(1, 2, 3), external_image=_texture(),
                                 external_size="1.5"),
    "external size absolute": dict(color=(1, 2, 3), external_image=_texture(),
                                   external_size=20),
    "external rotate": dict(color=(1, 2, 3), external_image=_texture(),
                            external_size=(24, 30), external_rotate=90.0,
                            external_only=True),
    "external flip": dict(color=(1, 2, 3), external_image=_texture(),
                          external_size=(30, 24), external_flip="both"),
    "external tile": dict(color=(1, 2, 3), external_image=_texture(8, 8),
                          external_size=(8, 8), external_mode="tile",
                          external_only=True),
    "external under hq": dict(color=(9, 9, 200), external_image=_texture(),
                              external_size=(30, 24), antialias_mode="hq",
                              scale=2),
    "external fails": dict(color=(10, 10, 200),
                           external_image="/nonexistent/texture.png"),
}


# 'hq' resizes the whole canvas up and down.  On the white canvas that is
# exact; on the noise canvas the float32 sums of up to 288 products come out
# of XLA's and torch's matrix products in different orders, the resized
# floats differ in the last bit, and a byte that lands on k + 0.5 may fall
# the other way: at most 1, on at most 0.01% of the bytes.
HQ_CASES = ("hq 2", "hq 3", "external under hq")
HQ_SHARE = 1e-4


@pytest.mark.parametrize("name", sorted(DRAW_CASES))
def test_each_keyword_is_exact(name):
    for kind, image, center in (("triangle", _white(96), (48, 40)),
                                ("plus", _busy(), (3, 90))):
        got, want = _both(kind, 40, True, 2, image, center,
                          **DRAW_CASES[name])
        if name in HQ_CASES and kind == "plus":
            diff = np.abs(got.astype(int) - want)
            print(f"{name} on the busy canvas: {int((diff > 0).sum())} of "
                  f"{diff.size} bytes differ, max {int(diff.max())}")
            assert diff.max() <= 1 and (diff > 0).mean() <= HQ_SHARE
            continue
        assert np.array_equal(got, want), \
            f"{name}/{kind}: {int((got != want).sum())} bytes differ, by up " \
            f"to {np.abs(got.astype(int) - want).max()}"


@pytest.mark.parametrize("opacity", [0.8, 0.5, 0.3])
def test_external_opacity_is_within_one_on_a_counted_share(opacity):
    """alpha * opacity lands many pixels exactly on k + 0.5 (an opaque
    texel at opacity 0.8 over white: 51 + 0.8 s).  Which way such a tie
    falls hangs on the last bit of a * (1/255) * opacity and of the blend's
    multiply-add, and XLA rounds those per compiled shape (its vectorised
    loop body fuses them, other parts of the same loop do not).  ops/
    overlay.py has the body's roundings, which is exact on the canvases of
    tests/test_torch_overlay.py; here a difference of 1 is allowed on at
    most 0.1% of the bytes."""
    for kind, image, center in (("triangle", _white(96), (48, 40)),
                                ("plus", _busy(), (3, 90))):
        got, want = _both(kind, 40, True, 2, image, center, color=(1, 2, 3),
                          external_image=_texture(), external_size=(24, 30),
                          external_opacity=opacity, external_only=True)
        diff = np.abs(got.astype(int) - want)
        print(f"opacity {opacity} {kind}: {int((diff > 0).sum())} of "
              f"{diff.size} bytes differ, max {int(diff.max())}")
        assert diff.max() <= 1 and (diff > 0).mean() <= SOFT_SHARE


@pytest.mark.parametrize("soft_blur", [7, 4, 11])
def test_soft_is_within_one_on_a_counted_share(soft_blur):
    for kind in ("heart", "star", "circle"):
        got, want = _both(kind, 60, True, 2, _white(), (64, 64),
                          color=(200, 40, 40), angle=12.0,
                          antialias_mode="soft", soft_blur=soft_blur)
        diff = np.abs(got.astype(int) - want)
        share = float((diff > 0).mean())
        print(f"soft {soft_blur} {kind}: {int((diff > 0).sum())} of "
              f"{diff.size} bytes differ, max {int(diff.max())}")
        assert diff.max() <= 1 and share <= SOFT_SHARE
    fast = shapes.Shape("heart", 60).draw(_white(), (64, 64), device="cpu",
                                          color=(200, 40, 40), angle=12.0)
    assert (got != fast).any() or kind == "circle"


def test_inputs_pil_gray_and_rgba_and_no_mutation():
    from PIL import Image
    rgb = _busy(64)
    for image in (Image.fromarray(rgb), rgb[..., 0].copy(),
                  np.dstack([rgb, rgb[..., :1]])):
        before = np.array(image).copy()
        got, want = _both("square", 30, True, 2, image, (32, 32),
                          color=(5, 6, 7))
        assert np.array_equal(got, want) and got.shape == (64, 64, 3)
        assert np.array_equal(np.array(image), before)


def test_color_none_draws_from_numpys_global_generator():
    np.random.seed(5)
    want = jax_shapes.Shape("square", 40).draw(_white(96), (48, 48))
    np.random.seed(5)
    got = shapes.Shape("square", 40).draw(_white(96), (48, 48), device="cpu")
    assert np.array_equal(got, want)
    assert tuple(got[48, 48]) != (255, 255, 255)


def test_draw_shape_is_shape_draw():
    got = shapes.draw_shape(_white(96), "hexagon", (40, 50), size=44,
                            fill=False, stroke_width=3, angle=10.0,
                            color=(0, 0, 0), device="cpu")
    want = jax_shapes.draw_shape(_white(96), "hexagon", (40, 50), size=44,
                                 fill=False, stroke_width=3, angle=10.0,
                                 color=(0, 0, 0))
    assert np.array_equal(got, want)


# ---- the cases of tests/test_shape_api.py that need no reference checkout

def test_external_size_factor_and_absolute():
    tex = np.zeros((16, 16, 3), np.uint8)
    tex[:] = [0, 200, 0]
    out = shapes.Shape("square", size=80).draw(
        _white(128), (64, 64), external_image=tex, external_size=0.5,
        external_only=True, device="cpu")
    ys, xs = np.nonzero(out[..., 1] == 200)
    assert xs.max() - xs.min() + 1 == 40 and ys.max() - ys.min() + 1 == 40
    out2 = shapes.Shape("square", size=80).draw(
        _white(128), (64, 64), external_image=tex, external_size=48,
        external_only=True, device="cpu")
    ys2, xs2 = np.nonzero(out2[..., 1] == 200)
    assert xs2.max() - xs2.min() + 1 == 48


def test_external_failure_falls_back_to_vector():
    out = shapes.Shape("circle", size=60, fill=True).draw(
        _white(128), (64, 64), color=(10, 10, 200),
        external_image="/nonexistent/texture.png", device="cpu")
    plain = shapes.Shape("circle", size=60, fill=True).draw(
        _white(128), (64, 64), color=(10, 10, 200), device="cpu")
    assert (out == plain).all()
    assert (out[64, 64] == [10, 10, 200]).all()


def test_flip_outline_wrap_and_tile():
    draw = lambda sh, *a, **k: sh.draw(*a, device="cpu", **k)
    a = draw(shapes.Shape("triangle", size=100), _white(256), (128, 128),
             color=(0, 0, 0))
    b = draw(shapes.Shape("triangle", size=100), _white(256), (128, 128),
             color=(0, 0, 0), flip_mode="vertical")
    assert not (a == b).all()
    o = draw(shapes.Shape("square", size=100, fill=True, stroke_width=4),
             _white(256), (128, 128), color=(255, 255, 255),
             outline=(200, 0, 0))
    assert (o[128 - 50, 128, 0] > 150) and (o[128 - 50, 128, 1] < 100)
    w = draw(shapes.Shape("square", size=60, fill=True), _white(128), (0, 0),
             color=(0, 0, 255))
    for y, x in [(2, 2), (2, 125), (125, 2), (125, 125)]:
        assert (w[y, x] == [0, 0, 255]).all(), (y, x)
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:] = [200, 0, 0]
    t = shapes.draw_shape(_white(128), "square", (64, 64), size=64,
                          external_image=tex, external_mode="tile",
                          external_only=True, device="cpu")
    assert (t[..., 0] == 200).sum() >= 64 * 64


def test_hq_and_soft_modes_run():
    for mode in ("soft", "hq"):
        out = shapes.Shape("heart", size=120).draw(
            _white(256), (128, 128), color=(200, 40, 40),
            antialias_mode=mode, scale=2, device="cpu")
        assert out.shape == (256, 256, 3) and out.dtype == np.uint8
        assert (out != 255).any()


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        shapes.Shape("blob")


def test_device_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        shapes.Shape("square").draw(_white(32), (16, 16), color=(0, 0, 0))
    with pytest.raises(RuntimeError, match="cuda"):
        shapes.draw_shape(_white(32), "square", (16, 16), color=(0, 0, 0))
