# test_torch_pipeline.py — the RPM slice, JAX package against the port.
"""The port's LeafPipeline against the JAX package's, on the CPU at
128x128.

Per leaf (batch 2, one non-grid and one grid sample): every ElementState
field of the sequence and the options, the rule params, perm,
correct_index, the rendered frames, the grid and its pHash.  Tolerance:
exact for all of them, float fields included (the port draws from the
same threefry streams and keeps XLA's float32 operation order).

This file holds the single-element leaves.  The others are in
test_torch_pipeline_{composite,overlay,traverse}.py, and the generator
test in test_torch_generator.py: each file's JAX compiles stay short.
"""
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.models.rpm.pipeline import (
    LeafPipeline as JaxLeafPipeline, sample_keys as jax_sample_keys)
from reasoning_image_generation_tpu.utils.config import GenConfig
from reasoning_image_generation_tpu_torch.models.rpm.pipeline import (
    LeafPipeline, sample_keys)
from reasoning_image_generation_tpu_torch.utils.state import to_numpy

torch.set_num_threads(1)

S = 128
IDS = np.array([3, 10])
USE_GRID = np.array([False, True])


def small_cfg(**kw) -> GenConfig:
    kw.setdefault("canvas_size", (S, S))
    return GenConfig(batch_size=2, aot=False, use_mesh=False, **kw)


def leaf_mismatches(leaf: str) -> list:
    """Run one batch of `leaf` through both pipelines; names of the outputs
    that differ (empty when everything is equal)."""
    cfg = small_cfg()
    want = JaxLeafPipeline(leaf, cfg)(jax_sample_keys(5, IDS), USE_GRID)
    got = LeafPipeline(leaf, cfg)(sample_keys(5, IDS),
                                  torch.tensor(USE_GRID))
    bad = []

    def cmp(name, a, b):
        a = np.asarray(a)
        if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(a, b):
            bad.append(name)

    for part in ("states", "options"):
        st = to_numpy(got[part])
        for f in st._fields:
            cmp(f"{part}.{f}", getattr(want[part], f), getattr(st, f))
    for f, a in zip(want["params"]._fields, want["params"]):
        b = getattr(got["params"], f).numpy()
        cmp(f"params.{f}", a, b.astype(np.asarray(a).dtype))
    for k in ("perm", "correct_index"):
        cmp(k, want[k], got[k].numpy().astype(np.int32))
    for k in ("state_imgs", "option_imgs", "grid_img", "grid_phash"):
        cmp(k, want[k], got[k].numpy())
    return bad


@pytest.mark.parametrize("leaf", ["平移", "旋转", "翻转(镜像)"])
def test_leaf_pipeline_matches_jax(leaf):
    assert leaf_mismatches(leaf) == []
