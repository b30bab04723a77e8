# test_torch_mg_transform.py — the data-to-pixel transform without matplotlib.
"""The port's ``data_to_pixel_transform`` reproduces matplotlib's float64
arithmetic for the reference figure; the JAX package's version queries
matplotlib itself.  Equal as float64 (``==``), at every dpi listed."""
import pytest
import torch

from reasoning_image_generation_tpu.models.multigraph import renderer as jax_renderer
from reasoning_image_generation_tpu_torch.models.multigraph import renderer

torch.set_num_threads(1)


@pytest.mark.parametrize("dpi", [10, 25, 34, 50, 72, 100, 150, 200, 300])
def test_transform_matches_matplotlib(dpi):
    pytest.importorskip("matplotlib")
    want = jax_renderer.data_to_pixel_transform(dpi)
    got = renderer.data_to_pixel_transform(dpi)
    assert [type(v) for v in got] == [float, float, float, int]
    assert got == want
