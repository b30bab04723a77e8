# test_torch_codec_generators_jax.py — codec generators, port against JAX.
"""The transfer codecs through both packages' generators, on the CPU.

- RPM: the port and the JAX package's RPMGeneratorTPU, both from empty run
  statistics, with rle4d (a 6-frame leaf) and with rle2 (a 4-frame leaf),
  one no-grid and one grid sample each, dedup on: the packed streams of
  every batch (read on the host after the shrink) and ``transfer_bytes``
  are equal, over a first call (streams whole) and a second (streams
  shrunk to the tiers the first call's statistics give), and so are the
  trees.  The ids are ones on which the JAX package's two renderers agree
  (test_torch_generator.py).
- mg: the port and the JAX package's GeometryGeneratorTPU (its Pallas
  kernel in interpret mode, on one device so that its keep mask rides in
  the blob as the port's does) with rle4 and with rle5 at dpi 25, dedup
  on: equal ``transfer_bytes``, records and trees.

Exact.  Each test points both packages' statistics at its own empty
directory (test_torch_codec_generators.own_stats).
"""
import functools

import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.models.multigraph import renderer_pallas
from reasoning_image_generation_tpu.models.multigraph.generator import (
    GeometryGeneratorTPU)
from reasoning_image_generation_tpu.models.rpm.generator import RPMGeneratorTPU
from reasoning_image_generation_tpu_torch.models.multigraph.generator import (
    GeometryGenerator)
from reasoning_image_generation_tpu_torch.models.rpm.generator import (
    RPMGenerator)

from .test_torch_codec_generators import CPU, assert_same_tree, own_stats  # noqa: F401
from .test_torch_generator import leaf_ids
from .test_torch_mg_generator import BATCH, DPI, MODES, SEEDS, _stable
from .test_torch_pipeline import small_cfg

torch.set_num_threads(1)


def _capture(gen, seen: list):
    """Record the packed streams each batch's export reads on the host."""
    orig = gen._update_run_stats

    def update(leaf, out, pipe):
        seen.append({k: tuple(np.array(a) for a in v)
                     for k, v in sorted(out.items()) if k.endswith("_packed")})
        return orig(leaf, out, pipe)
    gen._update_run_stats = update


@pytest.mark.parametrize("codec,leaf", [("rle4d", "直接叠加"),
                                        ("rle2", "翻转(镜像)")])
def test_rpm_streams_and_bytes_match_jax(tmp_path, codec, leaf):
    ids = leaf_ids(leaf)
    seen, bytes_ = {}, {}
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        cfg = small_cfg(out_dir=root, seed=0, sparse_transfer=True,
                        transfer_codec=codec)
        gen = RPMGeneratorTPU(cfg) if name == "jax" else RPMGenerator(cfg,
                                                                      CPU)
        seen[name], bytes_[name] = [], []
        _capture(gen, seen[name])
        for _call in range(2):           # whole streams, then shrunk ones
            gen.generate_ids(ids, dedup=True)
            bytes_[name].append(gen.transfer_bytes)
        gen.close()
    assert bytes_["port"] == bytes_["jax"]
    assert bytes_["port"][1] < 2 * bytes_["port"][0]    # the tiers shrank
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for want, got in zip(seen["jax"], seen["port"]):
        assert list(got) == list(want)
        for key in want:
            for i, (w, g) in enumerate(zip(want[key], got[key])):
                assert w.dtype == g.dtype and w.shape == g.shape, (key, i)
                assert np.array_equal(w, g), (key, i)
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("codec", ["rle4", "rle5"])
def test_mg_bytes_and_tree_match_jax(tmp_path, monkeypatch, codec):
    monkeypatch.setattr(renderer_pallas, "render_scene_batch_pallas",
                        functools.partial(
                            renderer_pallas.render_scene_batch_pallas,
                            interpret=True))
    # one device: the keep mask rides in the blob as in the port
    monkeypatch.setattr(GeometryGeneratorTPU, "_maybe_make_mesh",
                        staticmethod(lambda: None))
    recs, bytes_ = {}, {}
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        gen = (GeometryGeneratorTPU(renderer="pallas", aot=False,
                                    transfer_codec=codec) if name == "jax"
               else GeometryGenerator(CPU, transfer_codec=codec))
        out = gen.generate_batches(
            SEEDS, MODES,
            [f"{root}/images/{i}_{m}.png" for i, m in enumerate(MODES)],
            [f"{root}/params/{i}_{m}.json" for i, m in enumerate(MODES)],
            dpi=DPI, batch_size=BATCH, dedup=True)
        gen.close()
        recs[name] = [_stable(r) for r in out]
        bytes_[name] = gen.transfer_bytes
    assert recs["port"] == recs["jax"]
    assert bytes_["port"] == bytes_["jax"]
    assert len(assert_same_tree(str(tmp_path / "jax"),
                                str(tmp_path / "port"))) == 8


