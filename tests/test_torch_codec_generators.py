# test_torch_codec_generators.py — both generators with transfer codecs.
"""The transfer codecs through the port's generators, on the CPU.

- RPM: with each of the 9 codecs (``sparse_transfer=True``) the port writes
  the tree its raw transfer writes, at 128x128, for one 4-frame and one
  6-frame leaf, each with and without the grid, full export and grid-only
  (PNGs equal in decoded pixels, JSON equal but for wall-clock fields).
- A second run reads the persisted statistics and ships fewer bytes; a
  tier that is too small makes frames fall back to raw fetches, leaves the
  tree unchanged and is raised after TIER_REFREEZE_AFTER batches.

Every test points both packages' statistics at its own empty directory.
The comparisons with the JAX package's generators are in
test_torch_codec_generators_jax.py.
"""
import json
import os

import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.utils import cache as jax_cache
from reasoning_image_generation_tpu_torch.io.png_read import read_png
from reasoning_image_generation_tpu_torch.models.multigraph.generator import (
    GeometryGenerator)
from reasoning_image_generation_tpu_torch.models.rpm import generator
from reasoning_image_generation_tpu_torch.models.rpm.generator import (
    RPMGenerator)

from .test_torch_generator import _json, _no_timestamps, _tree, leaf_ids
from .test_torch_mg_generator import BATCH, DPI, MODES, SEEDS, _stable
from .test_torch_pipeline import small_cfg

torch.set_num_threads(1)

CPU = torch.device("cpu")
CODECS = ("rle", "rle2", "rle3", "rle3d", "rle4", "rle4d", "rle5", "rle5d",
          "sparse")
# one no-grid and one grid sample of a 6-frame and of a 4-frame leaf
IDS = sorted(leaf_ids("直接叠加") + leaf_ids("翻转(镜像)"))


@pytest.fixture(autouse=True)
def own_stats(tmp_path, monkeypatch):
    """Both packages' run statistics in this test's own directories."""
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "stats_port"))
    monkeypatch.setattr(jax_cache, "cache_dir",
                        lambda: str(tmp_path / "stats_jax"))


def run_port(root, ids, batch_size=2, **cfg_kw):
    cfg = small_cfg(out_dir=root, seed=0, **cfg_kw)
    cfg.batch_size = batch_size
    gen = RPMGenerator(cfg, CPU)
    metas = gen.generate_ids(ids, dedup=True)
    gen.close()
    return gen, _no_timestamps(json.loads(json.dumps(metas).replace(
        root, "<out>")))


def assert_same_tree(root_a, root_b):
    """The same files; PNGs equal in decoded pixels, JSON but for the
    wall-clock fields and mg's generation_id."""
    files = _tree(root_a)
    assert _tree(root_b) == files
    for rel in files:
        a, b = os.path.join(root_a, rel), os.path.join(root_b, rel)
        if rel.endswith(".png"):
            assert np.array_equal(read_png(a), read_png(b)), rel
        else:
            want, got = _json(a, root_a), _json(b, root_b)
            if isinstance(want, dict):
                want, got = _stable(want), _stable(got)
            assert want == got, rel
    return files


_RAW = {}


def raw_tree(tmp_path_factory, grid_only):
    """The raw transfer's tree and metas of IDS, made once per process."""
    if grid_only not in _RAW:
        root = str(tmp_path_factory.mktemp(f"raw_{grid_only}"))
        _RAW[grid_only] = (root, run_port(root, IDS, grid_only=grid_only)[1])
    return _RAW[grid_only]


@pytest.mark.parametrize("grid_only", [False, True],
                         ids=["full", "grid_only"])
@pytest.mark.parametrize("codec", CODECS)
def test_codec_tree_equals_raw_tree(tmp_path, tmp_path_factory, codec,
                                    grid_only):
    raw_root, raw_metas = raw_tree(tmp_path_factory, grid_only)
    root = str(tmp_path / "out")
    gen, metas = run_port(root, IDS, grid_only=grid_only,
                          sparse_transfer=True, transfer_codec=codec)
    assert metas == raw_metas
    files = assert_same_tree(raw_root, root)
    assert sum(f.endswith(".png") for f in files) == (
        4 if grid_only else 2 * 12 + 2 * 10)
    assert gen.transfer_bytes > 0


@pytest.mark.parametrize("pipeline", ["rpm", "mg"])
def test_second_run_ships_shrunk_streams(tmp_path, pipeline):
    """A fresh generator reads the statistics the first one saved: its
    streams travel shrunk, and it writes the same files."""
    moved = []
    for run in ("a", "b"):
        root = str(tmp_path / run)
        if pipeline == "rpm":
            gen = run_port(root, IDS, sparse_transfer=True,
                           transfer_codec="rle5d")[0]
        else:
            gen = GeometryGenerator(CPU)
            gen.generate_batches(
                SEEDS, MODES, [f"{root}/{i}.png" for i in range(6)],
                [f"{root}/{i}.json" for i in range(6)], dpi=DPI,
                batch_size=BATCH)
            gen.close()
        moved.append(gen.transfer_bytes)
    assert os.listdir(tmp_path / "stats_port") == [
        "runstats_rpm_128x128_g3_rle5d.json" if pipeline == "rpm"
        else "runstats_mg.json"]
    assert moved[1] < moved[0]
    assert_same_tree(str(tmp_path / "a"), str(tmp_path / "b"))


def test_small_tier_falls_back_and_refreezes(tmp_path, tmp_path_factory):
    """Frozen tiers of a few runs a frame: the grids and states overflow
    them, come raw and give the raw tree; after TIER_REFREEZE_AFTER
    overflowing batches in a row the tiers are raised."""
    leaf = "翻转(镜像)"
    ids = leaf_ids(leaf, per_mode=2)
    raw_root = str(tmp_path / "raw")
    _g, raw_metas = run_port(raw_root, ids, batch_size=1)
    root = str(tmp_path / "out")
    cfg = small_cfg(out_dir=root, seed=0, sparse_transfer=True,
                    transfer_codec="rle4d")
    cfg.batch_size = 1
    gen = RPMGenerator(cfg, CPU)
    small = {f"{leaf}:grid_img_packed:T": 1.0,
             f"{leaf}:state_imgs_packed:T": 1.0}
    gen._run_stats.update(small)
    metas = gen.generate_ids(ids, dedup=True)
    gen.close()
    metas = _no_timestamps(json.loads(json.dumps(metas).replace(root,
                                                                "<out>")))
    assert metas == raw_metas
    assert_same_tree(raw_root, root)
    assert gen.overflow_frames > 0
    assert [e[0] for e in gen.overflow_events][:2] == [1, 2]
    assert gen.tiers_refrozen >= 1
    assert generator.TIER_REFREEZE_AFTER == 2
    for k in small:
        assert gen._tier_stats[k] > 1.0
