# test_torch_overlay.py — ops/overlay.py of the port against the JAX package.
"""``load_external_image``, ``prepare_overlay`` and ``blend_overlay`` on the
same numpy-seeded textures and canvases, every keyword of each, and the
cases of tests/test_overlay_aa.py run through both packages.

Tolerance: exact.  Flips, tiling, the rotation's nearest sampling and its
validity mask, and the blend's wrapped nearest sampling are selections; the
antialiased resize is held to ops/resize's matrices (tests/
test_torch_resize.py), at sizes where they are jax's bit for bit, and
compared here after rounding to u8; the blend's float32 arithmetic
(alpha / 255 * opacity, one multiply-add per channel) is compared on the
rounded u8 canvas.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.ops import overlay as jax_overlay
from reasoning_image_generation_tpu_torch.ops import overlay

torch.set_num_threads(1)


def _texture(seed, h, w):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    t[h // 3:, : w // 2, :3] = (200, 30, 60)        # a flat block
    t[: h // 4, :, 3] = 0                           # a transparent band
    t[h // 4: h // 2, :, 3] = 255                   # an opaque one
    return t


def _canvas(seed, H, W):
    rng = np.random.default_rng(seed)
    c = np.full((H, W, 3), 255, np.uint8)
    c[H // 5: H // 2, W // 4:] = rng.integers(0, 256, 3)
    c[:, : W // 6] = rng.integers(0, 256, (H, W // 6, 3))
    return c


def _u8(x):
    return np.clip(np.round(np.asarray(x)), 0, 255).astype(np.uint8)


def test_load_external_image_shapes_and_files(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (10, 12, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (5, 6), dtype=np.uint8)
    rgba = rng.integers(0, 256, (7, 9, 4), dtype=np.uint8)
    for arr in (rgb, gray, rgba):
        want = jax_overlay.load_external_image(arr)
        got = overlay.load_external_image(arr)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert overlay.load_external_image(rgb).shape == (10, 12, 4)
    assert (overlay.load_external_image(gray)[..., 3] == 255).all()
    # a path: written with the port's PNG writer, read by both loaders
    from reasoning_image_generation_tpu_torch.io.png import write_png
    path = str(tmp_path / "tex.png")
    write_png(path, rgb)
    want = jax_overlay.load_external_image(path)
    got = overlay.load_external_image(path)
    assert np.array_equal(got, want) and np.array_equal(got[..., :3], rgb)
    with pytest.raises(Exception):
        overlay.load_external_image(str(tmp_path / "missing.png"))


PREPARE_CASES = {
    "as is": {},
    "resize down": {"target_size": (20, 33)},
    "resize up": {"target_size": (53, 57)},
    "resize one axis": {"target_size": (37, 57)},
    "rotate 90": {"rotate": 90.0},
    "rotate 180": {"rotate": 180.0},
    "rotate 37.5": {"rotate": 37.5},
    "rotate -112": {"rotate": -112.0},
    "flip horizontal": {"flip": "horizontal"},
    "flip vertical": {"flip": "vertical"},
    "flip both": {"flip": "both"},
    "tile": {"tile_to": (90, 70)},
    "tile smaller": {"tile_to": (10, 7)},
    "all": {"target_size": (20, 33), "rotate": 30.0, "flip": "both",
            "tile_to": (64, 50)},
}


@pytest.mark.parametrize("name", sorted(PREPARE_CASES))
def test_prepare_overlay_matches_jax(name):
    kw = PREPARE_CASES[name]
    for seed, (h, w) in enumerate(((57, 37), (20, 20))):
        if "resize" in name and (h, w) == (20, 20) and name != "resize up":
            continue              # sizes outside test_torch_resize's lists
        tex = _texture(seed, h, w)
        want = np.asarray(jax_overlay.prepare_overlay(jnp.asarray(tex), **kw))
        got = overlay.prepare_overlay(torch.from_numpy(tex), **kw)
        assert got.dtype == torch.float32 and got.shape == want.shape
        if "target_size" in kw:
            assert np.array_equal(_u8(got.numpy()), _u8(want)), (name, h, w)
        else:
            assert np.array_equal(got.numpy(), want), (name, h, w)


BLEND_CASES = {
    "centre": dict(center=(40, 30)),
    "corner wraps": dict(center=(0, 0)),
    "far corner wraps": dict(center=(79, 63)),
    "off canvas": dict(center=(-13, 70)),
    "half pixel centre": dict(center=(40.5, 29.5)),
    "no wrap": dict(center=(2, 3), wrap=False),
    "opacity 0.5": dict(center=(40, 30), opacity=0.5),
    "opacity 0.8": dict(center=(17, 50), opacity=0.8),
    "opacity clipped": dict(center=(40, 30), opacity=1.7),
    "opacity 0": dict(center=(40, 30), opacity=0.0),
}


@pytest.mark.parametrize("name", sorted(BLEND_CASES))
def test_blend_overlay_matches_jax(name):
    kw = BLEND_CASES[name]
    canvas = _canvas(3, 64, 80)
    for seed, (ho, wo) in enumerate(((16, 16), (21, 33), (70, 90))):
        ov = _texture(seed, ho, wo).astype(np.float32)
        want = np.asarray(jax_overlay.blend_overlay(
            jnp.asarray(canvas), jnp.asarray(ov), **kw))
        got = overlay.blend_overlay(torch.from_numpy(canvas),
                                    torch.from_numpy(ov), **kw)
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), want), (name, ho, wo)


def test_blend_overlay_center_and_wrap():
    """tests/test_overlay_aa.py::test_blend_overlay_center_and_wrap on the
    port."""
    canvas = torch.full((64, 64, 3), 255, dtype=torch.uint8)
    ov = np.zeros((16, 16, 4), np.float32)
    ov[..., 1] = 200
    ov[..., 3] = 255
    ov = torch.from_numpy(ov)
    out = overlay.blend_overlay(canvas, ov, (32, 32)).numpy()
    assert (out[32, 32] == [0, 200, 0]).all()
    assert (out[5, 5] == 255).all()
    out2 = overlay.blend_overlay(canvas, ov, (0, 0)).numpy()
    for y, x in [(0, 0), (0, 62), (62, 0), (62, 62)]:
        assert (out2[y, x] == [0, 200, 0]).all(), (y, x)
    out3 = overlay.blend_overlay(canvas, ov, (32, 32), opacity=0.5).numpy()
    assert 120 < out3[32, 32, 0] < 135


def test_prepare_overlay_resize_flip_tile():
    """tests/test_overlay_aa.py::test_prepare_overlay_resize_flip_tile on
    the port."""
    rgba = np.zeros((8, 8, 4), np.uint8)
    rgba[:, :4] = [255, 0, 0, 255]
    rgba[:, 4:] = [0, 0, 255, 255]
    t = torch.from_numpy(rgba)
    assert overlay.prepare_overlay(t, target_size=(16, 16)).shape == (16, 16, 4)
    flipped = overlay.prepare_overlay(t, flip="horizontal")
    assert flipped[0, 0, 2] == 255
    assert overlay.prepare_overlay(t, tile_to=(20, 12)).shape == (12, 20, 4)
