# test_torch_generator_leaves_b.py — the same dataset from both generators,
# rule leaves 3-5 of 9.
"""Both generators on the CPU at 128x128 write the same tree for ids of each
of these rule leaves in both grid modes, with full export and grid-only,
dedup on.  Exact: the same files, JSON equal apart from the wall-clock
fields, PNGs equal in decoded pixels (tests/test_torch_generator.py has the
comparison)."""
import pytest
import torch

from reasoning_image_generation_tpu_torch.utils.config import RULE_LEAVES

from .test_torch_generator import check_leaf_tree

torch.set_num_threads(1)

LEAVES = RULE_LEAVES[3:6]


@pytest.mark.parametrize("grid_only", [False, True],
                         ids=["full_export", "grid_only"])
@pytest.mark.parametrize("leaf", LEAVES)
def test_both_generators_write_the_same_tree(tmp_path, leaf, grid_only):
    check_leaf_tree(tmp_path, leaf, grid_only)
