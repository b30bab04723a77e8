# test_torch_generator.py — both generators write the same dataset.
"""The JAX package's RPMGeneratorTPU and the port's RPMGenerator on the same
ids, seed and dedup threshold, on the CPU at 128x128.  The written trees
must hold the same files; JSON equal apart from the wall-clock fields;
PNGs equal byte for byte where both packages write with the C encoder
(``both_fastpng``: the port's csrc/fastpng.c and the JAX package's
io/native, the same encoder), else equal in decoded pixels (zlib or
OpenCV write other bytes).  Exact.

The JAX generator renders with jnp on the CPU and with its Pallas kernel on
a TPU, and the two part by 1 at rare pixels: circles and crescents on
non-integer centres, where jnp takes ``jnp.hypot`` and the kernel the square
root of the sum of squares.  The port's renderer is the port of the kernel.
So a frame PNG that differs from the jnp one must equal, exactly, the Pallas
kernel's frame in interpret mode for the same sample (``pallas_frames``);
the test prints each such frame.  Grids and JSON get no such second
reference.

This file holds the comparison and one two-leaf case with a duplicate.
All 9 rule leaves, full export and grid-only, are in
tests/test_torch_generator_leaves_{a,b,c}.py, three leaves a file, so that
no worker of a file-sharded run takes them all."""
import dataclasses
import functools
import json
import os
import random
import subprocess
from unittest import mock

import numpy as np
import torch

from reasoning_image_generation_tpu.models.rpm.generator import RPMGeneratorTPU
from reasoning_image_generation_tpu.models.rpm.pipeline import (
    LeafPipeline as JaxLeafPipeline, sample_keys as jax_sample_keys)
from reasoning_image_generation_tpu.ops import raster_pallas
from reasoning_image_generation_tpu_torch.io.png_read import read_png
from reasoning_image_generation_tpu_torch.models.rpm.generator import (
    RPMGenerator)

from .test_torch_pipeline import small_cfg

torch.set_num_threads(1)

# seed 0 gives these ids the leaves 直接叠加 (9, 34, 35) and 翻转(镜像)
# (3, 4, 8), in both grid modes; each leaf takes a full and a padded batch
GEN_IDS = [9, 3, 34, 4, 35, 8]
# pHash distances of these grids run 14..28: at 16 the greedy pass drops
# id 4 (14 bits from id 9, which the leaf grouping visits first)
DEDUP_THRESHOLD = 16


def _tree(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# wall-clock fields, the only entries the two trees may differ in
TIME_KEYS = ("timestamp", "generation_time")


def _no_timestamps(x):
    """`x` with every wall-clock entry dropped, at any depth."""
    if isinstance(x, dict):
        return {k: _no_timestamps(v) for k, v in x.items()
                if k not in TIME_KEYS}
    if isinstance(x, list):
        return [_no_timestamps(v) for v in x]
    return x


def _json(path: str, root: str):
    with open(path, encoding="utf-8") as f:
        return _no_timestamps(json.loads(f.read().replace(root, "<out>")))


def both_fastpng() -> bool:
    """Both packages write PNGs with their C encoder (the same fastpng.c),
    so equal pixels must give equal bytes."""
    from reasoning_image_generation_tpu.io import native
    from reasoning_image_generation_tpu_torch.io import png
    try:
        native._load()
    except (OSError, subprocess.CalledProcessError):
        return False
    return png.encoder() == "fastpng"


def pallas_frames(cfg, meta: dict) -> dict:
    """The frame PNGs of one sample, by file name, as the JAX package's
    Pallas kernel renders them (interpret mode, the whole leaf pipeline
    with ``renderer='pallas'``)."""
    sid, leaf = meta["id"], meta["rule"]
    rng = random.Random((cfg.seed or 0) + sid)
    rng.choices(range(9), k=1)                # the leaf draw, consumed
    use_grid = rng.choice([False, True])
    B = cfg.batch_size
    with mock.patch.object(
            raster_pallas, "render_batch_pallas",
            functools.partial(raster_pallas.render_batch_pallas,
                              interpret=True)):
        out = JaxLeafPipeline(leaf, dataclasses.replace(
            cfg, renderer="pallas"))(jax_sample_keys(cfg.seed or 0, [sid] * B),
                                     np.array([use_grid] * B))
    frames = {f"state_{t}.png": np.asarray(img)
              for t, img in enumerate(out["state_imgs"][0])}
    for pos, src in enumerate(np.asarray(out["perm"][0])):
        name = "proto_true_next.png" if src == 0 else f"option_{int(src)}.png"
        frames[name] = np.asarray(out["option_imgs"][0, pos])
    return frames


def write_both_trees(tmp_path, ids, dedup_threshold, **cfg_kw):
    """Run both generators on `ids` (seed 0, 128x128, dedup on) and hold the
    written trees against each other: the same files, the returned metas
    and every JSON equal apart from the wall-clock fields, every PNG equal
    in bytes (``both_fastpng``) or decoded pixels.  -> (the port's metas,
    the relative file names)."""
    roots, index = {}, {}
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        cfg = small_cfg(out_dir=root, seed=0, **cfg_kw)
        gen = (RPMGeneratorTPU(cfg) if name == "jax"
               else RPMGenerator(cfg, torch.device("cpu")))
        metas = gen.generate_ids(ids, dedup=True,
                                 dedup_threshold=dedup_threshold)
        gen.close()
        roots[name] = root
        index[name] = _no_timestamps(
            json.loads(json.dumps(metas).replace(root, "<out>")))
    assert index["port"] == index["jax"]
    files = _tree(roots["jax"])
    assert _tree(roots["port"]) == files
    by_dir = {os.path.relpath(m["sample_dir"], "<out>"): m
              for m in index["port"] if "sample_dir" in m}
    kernel_frames = {}
    same_encoder = both_fastpng()
    for rel in files:
        a, b = (os.path.join(roots[n], rel) for n in ("jax", "port"))
        if rel.endswith(".png"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if fa.read() == fb.read():
                    continue
            want, got = read_png(a), read_png(b)
            if np.array_equal(want, got):
                # one encoder writes equal pixels in equal bytes
                assert not same_encoder, f"{rel}: same pixels, other bytes"
                continue
            # not the jnp renderer's frame: then the Pallas kernel's
            sdir, name = os.path.split(rel)
            assert sdir in by_dir, rel
            if sdir not in kernel_frames:
                kernel_frames[sdir] = pallas_frames(cfg, by_dir[sdir])
            print(f"{rel}: {int((want != got).any(-1).sum())} pixels differ "
                  f"from the jnp frame by up to "
                  f"{int(np.abs(want.astype(int) - got).max())}; held to the "
                  f"Pallas kernel's")
            assert np.array_equal(kernel_frames[sdir][name], got), rel
        else:
            assert _json(a, roots["jax"]) == _json(b, roots["port"]), rel
    return index["port"], files


def leaf_ids(leaf: str, per_mode: int = 1, search: int = 400) -> list:
    """The first `per_mode` sample ids below `search` that seed 0 assigns
    to `leaf` without the grid, and the first with it (the generators'
    own host-side draw: Python's Random seeded seed + id)."""
    import random
    from reasoning_image_generation_tpu_torch.utils.config import (
        GenConfig, category_leaves)
    cfg = GenConfig()
    leaves = category_leaves(cfg.categories)
    weights = [cfg.category_weights.get(l[-1], 1.0) for l in leaves]
    found = {False: [], True: []}
    for sid in range(search):
        rng = random.Random(sid)
        path = rng.choices(leaves, weights=weights, k=1)[0]
        use_grid = rng.choice([False, True])
        if path[-1] == leaf and len(found[use_grid]) < per_mode:
            found[use_grid].append(sid)
    assert all(len(v) == per_mode for v in found.values()), (leaf, found)
    return sorted(found[False] + found[True])


def check_leaf_tree(tmp_path, leaf: str, grid_only: bool):
    """One rule leaf of the main path's definition of done: the same tree
    from both generators for ids of `leaf` in both grid modes, dedup on (at
    the CLI's default threshold, which keeps them all)."""
    ids = leaf_ids(leaf)
    metas, files = write_both_trees(tmp_path, ids, 4, grid_only=grid_only)
    assert [m["id"] for m in metas] == ids
    assert {m["rule"] for m in metas} == {leaf}
    assert not any(m.get("duplicate") or m.get("error") for m in metas)
    pngs = [f for f in files if f.endswith(".png")]
    assert pngs and all(f.startswith("grids") for f in pngs) == grid_only


def test_generators_write_the_same_tree(tmp_path):
    metas, files = write_both_trees(tmp_path, GEN_IDS, DEDUP_THRESHOLD)
    assert [m["id"] if "id" in m else m["index"] for m in metas] \
        == sorted(GEN_IDS)
    assert [m["id"] for m in metas if m.get("duplicate")] == [4]
    # kept: three 6-frame samples (6 states, 4 options, query, grid) and two
    # 4-frame ones
    assert sum(f.endswith(".png") for f in files) == 3 * 12 + 2 * 10
