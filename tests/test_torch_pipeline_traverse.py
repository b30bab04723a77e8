# test_torch_pipeline_traverse.py — the two traversal leaves against JAX.
"""单一遍历 (kind traversal) and 位置遍历 (position traversal) through the
port's LeafPipeline and the JAX package's, with the checks and the
tolerance of test_torch_pipeline.py (exact for every output)."""
import pytest
import torch

from .test_torch_pipeline import leaf_mismatches

torch.set_num_threads(1)


@pytest.mark.parametrize("leaf", ["单一遍历", "位置遍历"])
def test_leaf_pipeline_matches_jax(leaf):
    assert leaf_mismatches(leaf) == []
