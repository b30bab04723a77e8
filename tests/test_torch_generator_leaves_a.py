# test_torch_generator_leaves_a.py — the same dataset from both generators,
# rule leaves 0-2 of 9.
"""Both generators on the CPU at 128x128 write the same tree for ids of each
of these rule leaves in both grid modes, with full export and grid-only,
dedup on.  Exact: the same files, JSON equal apart from the wall-clock
fields, PNGs equal in decoded pixels (tests/test_torch_generator.py has the
comparison)."""
import pytest
import torch

from reasoning_image_generation_tpu_torch.utils.config import RULE_LEAVES

from .test_torch_generator import (
    check_leaf_tree, leaf_ids, write_both_trees)

torch.set_num_threads(1)

LEAVES = RULE_LEAVES[0:3]


@pytest.mark.parametrize("grid_only", [False, True],
                         ids=["full_export", "grid_only"])
@pytest.mark.parametrize("leaf", LEAVES)
def test_both_generators_write_the_same_tree(tmp_path, leaf, grid_only):
    check_leaf_tree(tmp_path, leaf, grid_only)


def test_one_leaf_at_512_grid_only(tmp_path):
    """The default 512x512 canvas, one leaf (旋转: ids 1 and 18 of seed 0,
    without and with the grid), grid-only: the same tree from both
    generators, exact.  The other leaves are held at 512x512 by the chain
    port on the CPU = JAX at 128x128 (this file and its siblings) and card
    = port on the CPU at 512x512 (chip_smoke.py)."""
    ids = leaf_ids("旋转")
    metas, files = write_both_trees(tmp_path, ids, 4, grid_only=True,
                                    canvas_size=(512, 512))
    assert [m["id"] for m in metas] == ids
    assert {m["rule"] for m in metas} == {"旋转"}
    assert [f for f in files if f.endswith(".png")] == \
        [f"grids/grid_{i:06d}.png" for i in ids]
