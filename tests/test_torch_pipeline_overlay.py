# test_torch_pipeline_overlay.py — the overlay triplet against JAX.
"""直接叠加, 去同存异 and 去异存同 (6-frame sequences that merge, diff or
intersect the last two frames, with random-subset distractors) through the
port's LeafPipeline and the JAX package's, with the checks and the
tolerance of test_torch_pipeline.py (exact for every output)."""
import pytest
import torch

from .test_torch_pipeline import leaf_mismatches

torch.set_num_threads(1)


@pytest.mark.parametrize("leaf", ["直接叠加", "去同存异", "去异存同"])
def test_leaf_pipeline_matches_jax(leaf):
    assert leaf_mismatches(leaf) == []
