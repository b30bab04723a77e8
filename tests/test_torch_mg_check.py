# test_torch_mg_check.py — mg QC and pair features against the JAX package.
"""``check_scene_inside`` (whose out-of-bounds ``bbox_data`` goes through the
data-to-pixel scale in float64) and ``compute_scene_features`` of both
packages on generated scenes of every mode and on the hand-built scenes
of chip_smoke.py (whose decoration lines leave the axes).  Exact."""
import pytest
import torch

import chip_smoke
from reasoning_image_generation_tpu.models.multigraph import check as jax_check
from reasoning_image_generation_tpu_torch.models.multigraph import check
from reasoning_image_generation_tpu_torch.models.multigraph.scene import (
    build_scene_batch)

torch.set_num_threads(1)


def _scenes(kind):
    if kind == "hand":
        batch = chip_smoke.mg_hand_batch()
    else:
        batch = build_scene_batch(list(range(6)), [kind] * 6)[0]
    n = batch["shape_valid"].shape[0]
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]


@pytest.mark.parametrize("kind", ["random", "nested", "adjacent",
                                  "intersecting", "hand"])
def test_qc_and_features_match_jax(kind):
    scenes = _scenes(kind)
    n_out = 0
    for sc in scenes:
        for dpi in (25, 200):
            want = jax_check.check_scene_inside(sc, dpi=dpi)
            assert check.check_scene_inside(sc, dpi=dpi) == want
            n_out += len(want["out_of_bounds"])
        assert check.compute_scene_features(sc) == \
            jax_check.compute_scene_features(sc)
    if kind == "hand":
        assert n_out > 0          # the bbox_data path was exercised
