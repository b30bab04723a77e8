# test_torch_resize.py — ops/resize.py against jax.image.resize.
"""The port's resize weights and resized images against ``jax.image.resize``
on the CPU, at the (kernel, antialias) pairs the JAX package uses.

Weights: the matrix jax applies is read off by resizing an identity matrix
along one axis (a product with 0 and 1 is exact), and must equal
``resize.weight_matrix`` bit for bit.  Sizes: what the package's callers
give it, odd and even: the pHash's 32 from canvases and grids, the grid
composer's upscales, overlays shrunk to an element's size, and the 'hq'
modes' whole-number ratios up and down.

Where the bar is lower, and why.  XLA compiles the weight computation
into the resize's own program, and its CPU code generator rounds the same
expression differently from shape to shape: it vectorises a loop of 96
output rows or more and fuses the sample position there, leaves the last
few elements of the flattened loop unfused, sums an axis of under 32 taps
in an order of its own, and calls libm's ``sinf``, which is not always the
correctly rounded sine.  ``weight_matrix`` follows
the rules that hold over whole families of sizes.  NEAR lists pairs outside
them; there the test bounds the difference: at most 4e-6 on any weight
(one part in 1e5 of a u8 step after the product with 255).

Images: u8 inputs from a seed, resized on both sides and rounded to u8,
must be equal: exact, including the float32 products' summation order on
these inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu_torch.ops import resize

torch.set_num_threads(1)

# (method, antialias, n_in, n_out)
EXACT = [
    # pHash: canvases and grid heights to 32
    ("linear", True, 512, 32), ("linear", True, 128, 32),
    ("linear", True, 100, 32), ("linear", True, 356, 32),
    ("linear", True, 37, 32), ("linear", True, 31, 32),
    # overlays: a texture shrunk or grown to an element's size
    ("linear", True, 100, 33), ("linear", True, 57, 20),
    ("linear", True, 200, 66), ("linear", True, 150, 47),
    ("linear", True, 20, 57), ("linear", True, 37, 53),
    ("linear", True, 47, 150), ("linear", True, 120, 360),
    ("linear", True, 64, 64),
    # the grid composer's cubic upscale, and Shape.draw's 'hq' upsample
    ("cubic", True, 32, 64), ("cubic", True, 37, 53), ("cubic", True, 64, 128),
    ("cubic", True, 128, 256), ("cubic", True, 47, 150),
    ("cubic", True, 120, 360), ("cubic", True, 128, 384),
    ("cubic", True, 41, 123), ("cubic", True, 64, 82), ("cubic", True, 40, 40),
    # 'hq' downsamples: whole-number ratios
    ("lanczos3", True, 256, 128), ("lanczos3", True, 384, 128),
    ("lanczos3", True, 128, 64), ("lanczos3", True, 123, 41),
    ("lanczos3", True, 96, 32), ("lanczos3", False, 384, 128),
    ("lanczos3", False, 96, 32), ("lanczos3", False, 123, 41),
    ("lanczos3", False, 192, 64),
]
NEAR = [
    ("linear", True, 206, 111),     # vectorised, antialiased, inexact ratio
    ("linear", True, 33, 100),      # the flattened loop's unfused tail
    ("cubic", True, 24, 38),        # a short loop's Keys polynomial
    ("linear", True, 30, 20),       # a downscale from under 32 taps
    ("lanczos3", True, 100, 33),    # libm's sinf
    ("lanczos3", False, 37, 53),
]
NEAR_TOL = 4e-6


def _jax_weights(method, antialias, n_in, n_out):
    eye = jnp.eye(n_in, dtype=jnp.float32)
    return np.asarray(jax.image.resize(eye, (n_out, n_in), method,
                                       antialias=antialias))


def _id(case):
    method, aa, n_in, n_out = case
    return f"{method}-{'aa' if aa else 'noaa'}-{n_in}to{n_out}"


@pytest.mark.parametrize("case", EXACT, ids=_id)
def test_weights_equal_jax(case):
    method, aa, n_in, n_out = case
    got = resize.weight_matrix(n_in, n_out, method, aa)
    want = _jax_weights(method, aa, n_in, n_out)
    assert got.dtype == np.float32 and got.shape == (n_out, n_in)
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
        f"{int((got != want).sum())} weights differ, by up to " \
        f"{np.abs(got - want).max()}"


@pytest.mark.parametrize("case", NEAR, ids=_id)
def test_weights_near_jax_where_xla_rounds_otherwise(case):
    method, aa, n_in, n_out = case
    got = resize.weight_matrix(n_in, n_out, method, aa)
    want = _jax_weights(method, aa, n_in, n_out)
    diff = np.abs(got.astype(np.float64) - want)
    print(f"{_id(case)}: {int((got != want).sum())} of {got.size} weights "
          f"differ, max {diff.max():.3g}")
    assert diff.max() <= NEAR_TOL


def _image(rng, H, W, C=3):
    img = rng.integers(0, 256, (H, W, C)).astype(np.uint8)
    img[H // 4:H // 2, W // 3:] = rng.integers(0, 256, C)   # a flat block
    img[:, :W // 5] = 255
    return img


# (method, antialias, (H, W), (new_h, new_w))
IMAGES = [
    ("linear", True, (96, 128), (32, 32)),
    ("linear", True, (57, 100), (20, 33)),
    ("linear", True, (20, 37), (57, 53)),
    ("cubic", True, (32, 32), (64, 64)),
    ("cubic", True, (37, 64), (53, 128)),
    ("cubic", True, (40, 41), (40, 123)),      # one axis unchanged
    ("cubic", True, (64, 64), (64, 64)),       # the identity
    ("lanczos3", True, (256, 128), (128, 64)),
    ("lanczos3", True, (123, 96), (41, 32)),
    ("lanczos3", False, (96, 123), (32, 41)),
]


@pytest.mark.parametrize("case", IMAGES, ids=lambda c: f"{c[0]}-{c[2]}-{c[3]}")
def test_resized_u8_images_equal_jax(case):
    method, aa, (H, W), size = case
    img = _image(np.random.default_rng(H * 1000 + W), H, W)
    want = jax.image.resize(jnp.asarray(img, jnp.float32), (*size, 3), method,
                            antialias=aa)
    want = np.asarray(jnp.clip(jnp.round(want), 0, 255).astype(jnp.uint8))
    got = resize.resize(torch.from_numpy(img).float(), size, method, aa)
    got = torch.clamp(torch.round(got), 0, 255).to(torch.uint8).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want), \
        f"{int((got != want).sum())} of {got.size} values differ"
    if tuple(size) == (H, W):
        assert np.array_equal(got, img)


def test_batched_and_rgba_inputs():
    """Leading axes and the channel count are free; float32 in, float32
    out, on the tensor's device."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (2, 3, 24, 30, 4))
                         .astype(np.float32))
    out = resize.resize(x, (48, 15), "linear")
    assert out.shape == (2, 3, 48, 15, 4) and out.dtype == torch.float32
    one = resize.resize(x[1, 2], (48, 15), "linear")
    assert torch.equal(out[1, 2], one)


def test_matrix_is_cached_read_only_and_rows_sum_to_one():
    w = resize.weight_matrix(50, 20, "cubic", True)
    assert resize.weight_matrix(50, 20, "cubic", True) is w
    with pytest.raises(ValueError):
        w[0, 0] = 1.0
    assert np.allclose(w.sum(1), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="method"):
        resize.weight_matrix(8, 4, "nearest", True)
