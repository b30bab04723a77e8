# test_torch_generator_api.py — RPMGenerator's single-sample and measuring API.
"""``generate_sample`` (with and without a pinned rule leaf), ``warmup``,
``measure_device_rate`` and ``transfer_bytes`` of the port's RPMGenerator,
on the CPU at 128x128, against the JAX package's RPMGeneratorTPU where it
has the same entry.

Tolerance: exact.  Metas are compared as parsed JSON with the out_dir
replaced and the wall-clock fields dropped, PNGs in decoded pixels.  The
rate is a wall-clock reading on the CPU: only its sign is checked.
"""
import json
import os

import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.models.rpm.generator import RPMGeneratorTPU
from reasoning_image_generation_tpu_torch.io.png_read import read_png
from reasoning_image_generation_tpu_torch.models.rpm.generator import (
    RPMGenerator)

from .test_torch_generator import _json, _no_timestamps, _tree
from .test_torch_pipeline import small_cfg

torch.set_num_threads(1)

CPU = torch.device("cpu")
# a leaf that seed 0 does not give id 5 by itself, so that pinning shows
PINNED = ["图形相似", "位置变换", "旋转"]


def _both_samples(tmp_path, sample_id, category_path):
    """generate_sample from both generators -> (metas, roots) by name."""
    metas, roots = {}, {}
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        cfg = small_cfg(out_dir=root, seed=0)
        gen = (RPMGeneratorTPU(cfg) if name == "jax"
               else RPMGenerator(cfg, CPU))
        meta = gen.generate_sample(sample_id, category_path)
        gen.close()
        metas[name] = _no_timestamps(
            json.loads(json.dumps(meta).replace(root, "<out>")))
        roots[name] = root
    return metas, roots


@pytest.mark.parametrize("category_path", [None, PINNED],
                         ids=["drawn_leaf", "pinned_leaf"])
def test_generate_sample_matches_jax(tmp_path, category_path):
    metas, roots = _both_samples(tmp_path, 5, category_path)
    assert metas["port"] is not None and metas["port"] == metas["jax"]
    assert metas["port"]["id"] == 5
    if category_path is not None:
        assert metas["port"]["rule"] == category_path[-1]
        assert metas["port"]["category_path"] == category_path
    files = _tree(roots["jax"])
    assert _tree(roots["port"]) == files
    # one sample only: the batch's padding is never exported
    assert sum(f.endswith("meta.json") for f in files) == 1
    for rel in files:
        a, b = (os.path.join(roots[n], rel) for n in ("jax", "port"))
        if rel.endswith(".png"):
            assert np.array_equal(read_png(a), read_png(b)), rel
        else:
            assert _json(a, roots["jax"]) == _json(b, roots["port"]), rel


def test_pinning_overrules_the_drawn_leaf_and_keeps_the_grid_coin(tmp_path):
    """Seed 0 gives id 5 the leaf 去同存异 with the grid: pinned to another
    leaf it keeps that toss, because the leaf draw is consumed first."""
    gen = RPMGenerator(small_cfg(out_dir=str(tmp_path / "a"), seed=0), CPU)
    drawn = gen.generate_sample(5)
    seen = []
    real = gen._dispatch
    gen._dispatch = lambda leaf, pipe, chunk, *a: (
        seen.append((leaf, chunk)), real(leaf, pipe, chunk, *a))[1]
    pinned = gen.generate_sample(5, PINNED)
    gen.close()
    assert drawn["rule"] == "去同存异" and pinned["rule"] == PINNED[-1]
    assert seen == [(PINNED[-1], [(5, PINNED, True)])]


def test_warmup_writes_nothing_and_moves_no_bytes(tmp_path):
    root = str(tmp_path / "out")
    gen = RPMGenerator(small_cfg(out_dir=root, seed=0), CPU)
    before = _tree(root)
    gen.warmup([3, 4, 9])
    assert _tree(root) == before
    assert not any(f.endswith((".png", ".json")) for f in before)
    assert gen.transfer_bytes == 0
    assert len(gen._pipelines) == 2          # ids 3, 4: one leaf; 9: another
    gen.close()


@pytest.mark.parametrize("blocking", [False, True],
                         ids=["amortized", "blocking"])
def test_measure_device_rate_is_positive(tmp_path, blocking):
    gen = RPMGenerator(small_cfg(out_dir=str(tmp_path / "out"), seed=0), CPU)
    rate = gen.measure_device_rate([3, 4, 9], iters=1, blocking=blocking)
    assert rate > 0.0 and np.isfinite(rate)
    assert gen.transfer_bytes == 0           # nothing was copied or exported
    assert _tree(str(tmp_path / "out")) == []
    gen.close()


def test_measure_device_rate_prefers_full_batches(tmp_path):
    """Ids 3, 4, 8 share a leaf: at batch 2 they make a full batch and a
    padded one, and only the full one is timed, through the leaf's blob
    step that ``_dispatch`` replays."""
    gen = RPMGenerator(small_cfg(out_dir=str(tmp_path / "out"), seed=0), CPU)
    calls = []
    pipe = gen._pipeline("翻转(镜像)")
    real = pipe.__class__.blob

    def counting(self, keys, use_grid, **kw):
        calls.append(int(keys.shape[0]))
        return real(self, keys, use_grid, **kw)

    pipe.__class__.blob = counting
    try:
        gen.measure_device_rate([3, 4, 8], iters=2)
    finally:
        pipe.__class__.blob = real
        gen.close()
    assert calls == [2, 2, 2]                # one warm call and 2 iterations


def test_transfer_bytes_counts_what_the_batches_copied(tmp_path):
    """Grid-only export copies the grid, its hash and the small tables, not
    the frames: the full export of the same ids moves more, by at least the
    frames' bytes."""
    moved = {}
    for tag, grid_only in (("grid", True), ("full", False)):
        gen = RPMGenerator(small_cfg(out_dir=str(tmp_path / tag), seed=0,
                                     grid_only=grid_only), CPU)
        metas = gen.generate_ids([3, 4])
        gen.close()
        assert len(metas) == 2 and gen.transfer_bytes > 0
        moved[tag] = gen.transfer_bytes
    frames = 2 * 128 * 128 * 3               # at least one frame a sample
    assert moved["full"] >= moved["grid"] + frames
