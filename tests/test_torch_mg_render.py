# test_torch_mg_render.py — the plain mg renderer against the Pallas kernel.
"""The port's plain version of K2 (``renderer.render_scene_batch`` on CPU
tensors) against the JAX package's ``render_scene_batch_pallas`` in Pallas
interpret mode, on the scene sets chip_smoke.py holds the CUDA kernel to:
16 generated scenes (modes cycling) and the hand-built scenes (mask cut,
replace_boundary, gradients on all 3 shapes, 24 lines).  At dpi 25 (one
256-lane tile wide) and dpi 34 (272x272, several partial tiles).

Tolerance: byte equality with the Pallas kernel; and maxdiff <= 1 against
the JAX package's data-space jnp renderer, the bar the JAX package holds
its own two renderers to (tests/test_multigraph.py)."""
import numpy as np
import pytest
import torch

import chip_smoke
from reasoning_image_generation_tpu.models.multigraph.renderer import (
    render_scene_batch as jnp_render_scene_batch)
from reasoning_image_generation_tpu.models.multigraph.renderer_pallas import (
    render_scene_batch_pallas)
from reasoning_image_generation_tpu_torch.models.multigraph import (
    renderer, renderer_cuda)

torch.set_num_threads(1)

SETS = {"generated": lambda: chip_smoke.mg_generated_batch(16),
        "hand": chip_smoke.mg_hand_batch}


@pytest.mark.parametrize("dpi", [25, 34])
@pytest.mark.parametrize("scene_set", sorted(SETS))
def test_plain_renderer_matches_pallas_kernel(scene_set, dpi):
    batch = SETS[scene_set]()
    want = np.asarray(render_scene_batch_pallas(batch, dpi=dpi,
                                                interpret=True))
    got = renderer.render_scene_batch(batch, dpi, torch.device("cpu"))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    jnp_img = np.asarray(jnp_render_scene_batch(batch, dpi=dpi))
    assert np.abs(got.numpy().astype(int) - jnp_img.astype(int)).max() <= 1


def test_prep_packs_every_gradient_and_mask_field():
    """The hand-built set reaches every meta row the kernel reads."""
    scene = renderer.scene_batch_to_torch(chip_smoke.mg_hand_batch(), "cpu")
    meta, svx, svy, mvx, mvy, lin = renderer.prepare_scene_batch(scene, 25)
    assert meta.shape[1:] == (20, 8) and lin.shape[1:] == (24, 16)
    assert set(meta[:, renderer.R_MODE, 0].tolist()) == {0.0, 1.0, 2.0}
    assert (meta[:, renderer.R_GRAD, :3] > 0).all(1).any()
    assert (lin[..., renderer.L_VALID] > 0).all(1).any()


def test_kernel_wrapper_takes_only_cuda_tensors():
    scene = renderer.scene_batch_to_torch(chip_smoke.mg_hand_batch(), "cpu")
    args = renderer.prepare_scene_batch(scene, 25)
    with pytest.raises(ValueError, match="CUDA"):
        renderer_cuda.render_prepared_cuda(*args, 200, 200)
    assert renderer_cuda.LAUNCHES == 0
