# test_torch_generator.py — both generators write the same dataset.
"""The JAX package's RPMGeneratorTPU and the port's RPMGenerator on the same
ids, seed and dedup threshold, on the CPU at 128x128.  The written trees
must hold the same files; JSON equal apart from the wall-clock fields,
PNGs equal in decoded pixels (the encoders may differ in bytes)."""
import json
import os

import numpy as np
import torch

from reasoning_image_generation_tpu.models.rpm.generator import RPMGeneratorTPU
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


def test_generators_write_the_same_tree(tmp_path):
    roots, index = {}, {}
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        cfg = small_cfg(out_dir=root, seed=0)
        gen = (RPMGeneratorTPU(cfg) if name == "jax"
               else RPMGenerator(cfg, torch.device("cpu")))
        metas = gen.generate_ids(GEN_IDS, dedup=True,
                                 dedup_threshold=DEDUP_THRESHOLD)
        gen.close()
        roots[name] = root
        index[name] = _no_timestamps(
            json.loads(json.dumps(metas).replace(root, "<out>")))

    assert [m["id"] if "id" in m else m["index"] for m in index["port"]] \
        == sorted(GEN_IDS)
    assert [m["id"] for m in index["port"] if m.get("duplicate")] == [4]
    assert index["port"] == index["jax"]
    files = _tree(roots["jax"])
    assert _tree(roots["port"]) == files
    # kept: three 6-frame samples (6 states, 4 options, query, grid) and two
    # 4-frame ones
    assert sum(f.endswith(".png") for f in files) == 3 * 12 + 2 * 10
    for rel in files:
        a, b = (os.path.join(roots[n], rel) for n in ("jax", "port"))
        if rel.endswith(".png"):
            assert np.array_equal(read_png(a), read_png(b)), rel
        else:
            assert _json(a, roots["jax"]) == _json(b, roots["port"]), rel
