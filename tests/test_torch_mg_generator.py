# test_torch_mg_generator.py — both mg generators write the same dataset.
"""The JAX package's GeometryGeneratorTPU and the port's GeometryGenerator
on the same seeds and modes at dpi 25, with corpus dedup off and on.  The
JAX side renders with its Pallas kernel in interpret mode (its TPU
renderer, run on the CPU) and a batch size of 3, which the 8-device test
mesh does not divide, so it renders unsharded.  The trees must hold the
same files, params JSON equal apart from generation_id and timestamp, and
PNGs equal byte for byte where both packages write with the C encoder
(both write each scene from its run stream with the same fastpng.c), else
equal in decoded pixels."""
import functools
import json
import os

import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.models.multigraph import renderer_pallas
from reasoning_image_generation_tpu.models.multigraph.generator import (
    GeometryGeneratorTPU)
from reasoning_image_generation_tpu.utils import cache
from reasoning_image_generation_tpu_torch.io.png_read import read_png
from reasoning_image_generation_tpu_torch.models.multigraph.generator import (
    GeometryGenerator)

from .test_torch_generator import both_fastpng

torch.set_num_threads(1)

DPI = 25
BATCH = 3
# seeds 1 and 2 come back in the same modes: with dedup on, those two
# scenes are pixel-identical to earlier ones and are dropped
SEEDS = [1, 2, 3, 1, 2, 5]
MODES = ["adjacent", "nested", "random", "adjacent", "nested", "intersecting"]
VOLATILE = ("generation_id", "timestamp")


def _tree(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _stable(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in VOLATILE}


@pytest.mark.parametrize("dedup", [False, True])
def test_generators_write_the_same_tree(tmp_path, monkeypatch, dedup):
    monkeypatch.setattr(cache, "cache_dir", lambda: str(tmp_path / "cache"))
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "cache_port"))
    monkeypatch.setattr(renderer_pallas, "render_scene_batch_pallas",
                        functools.partial(
                            renderer_pallas.render_scene_batch_pallas,
                            interpret=True))
    roots, records = {}, {}
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        gen = (GeometryGeneratorTPU(renderer="pallas", aot=False)
               if name == "jax" else GeometryGenerator(torch.device("cpu")))
        recs = gen.generate_batches(
            SEEDS, MODES,
            [f"{root}/images/{i}_{m}.png" for i, m in enumerate(MODES)],
            [f"{root}/params/{i}_{m}.json" for i, m in enumerate(MODES)],
            dpi=DPI, batch_size=BATCH, dedup=dedup)
        gen.close()
        roots[name] = root
        records[name] = [_stable(r) for r in recs]

    assert records["port"] == records["jax"]
    dups = [bool(r.get("duplicate")) for r in records["port"]]
    assert dups == ([False, False, False, True, True, False] if dedup
                    else [False] * 6)
    files = _tree(roots["jax"])
    assert _tree(roots["port"]) == files
    assert len(files) == 2 * dups.count(False)
    same_encoder = both_fastpng()
    for rel in files:
        a, b = (os.path.join(roots[n], rel) for n in ("jax", "port"))
        if rel.endswith(".png"):
            img = read_png(b)
            assert img.shape == (8 * DPI, 8 * DPI, 3)
            assert np.array_equal(read_png(a), img), rel
            if same_encoder:
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read(), rel
        else:
            with open(a, encoding="utf-8") as fa, \
                    open(b, encoding="utf-8") as fb:
                want, got = json.load(fa), json.load(fb)
            assert "qc" in got
            assert _stable(got) == _stable(want), rel
