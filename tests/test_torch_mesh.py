# test_torch_mesh.py — the port's device mesh against the JAX package's.
"""parallel/mesh.py of the port, on the CPU, over meshes of repeated
``cpu`` devices (the port's stand-in for the 8 host devices conftest.py
gives JAX):

- ``make_mesh``, ``shard_batch``/``gather_batch`` and the single-process
  ``make_hybrid_mesh`` over 8 handles to the CPU; ``make_mesh()`` without
  devices raises where no card is visible;
- ``dedup_keep_mask``, ``dedup_images`` and ``sharded_dedup_mask`` (with
  and without a corpus, a duplicate split across shards) against the JAX
  functions on conftest's 8-device mesh, on the same numpy hashes and
  images.  Exact;
- ``RPMGenerator`` on a mesh of 4 handles against the port's own
  single-device run (64x64, batch 8, ids 0-9: one full batch and a ragged
  tail), with dedup on and off: the same metas and the same file tree
  byte for byte, as tests/test_mesh.py holds the JAX generator (the
  single-device tree is tied to the JAX package by
  test_torch_generator*.py); its warmup, measure_device_rate and
  generate_sample on a mesh of 2; the rules for building a mesh;
- ``GeometryGenerator`` on the same mesh at dpi 25, a batch of 8 and a
  ragged 3 with dedup, against unsharded, as tests/test_mg_mesh.py does.

The two-process world is in test_torch_mesh_multiprocess.py."""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.ops import phash as jax_phash
from reasoning_image_generation_tpu.parallel import mesh as jax_mesh
from reasoning_image_generation_tpu_torch.models.multigraph import (
    generator as mg_generator)
from reasoning_image_generation_tpu_torch.models.rpm import (
    pipeline as rpm_pipeline)
from reasoning_image_generation_tpu_torch.models.rpm.generator import (
    RPMGenerator)
from reasoning_image_generation_tpu_torch.ops import phash
from reasoning_image_generation_tpu_torch.parallel import mesh
from reasoning_image_generation_tpu_torch.utils.config import GenConfig

from .test_torch_compose_phash import _frames

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _cpu_mesh(n: int):
    return mesh.make_mesh(devices=["cpu"] * n)


def test_make_mesh_and_shard_batch():
    m = _cpu_mesh(8)
    assert m.devices == (CPU,) * 8 and m.axis_names == ("data",)
    assert m.shape == {"data": 8} and m.size == 8
    assert mesh.make_mesh(4, devices=[CPU] * 8).size == 4
    arr = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    parts = mesh.shard_batch(m, {"a": arr, "b": (torch.arange(16),)})
    assert len(parts) == 8
    for i, p in enumerate(parts):
        assert np.array_equal(p["a"].numpy(), arr[2 * i:2 * i + 2])
        assert p["b"][0].tolist() == [2 * i, 2 * i + 1]
    back = mesh.gather_batch(m, parts)
    assert np.array_equal(back["a"].numpy(), arr)
    assert back["b"][0].tolist() == list(range(16))
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(m, arr[:12])


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_hybrid_mesh()


def test_single_process_hybrid_mesh():
    mesh.distributed_init()                    # a single process: nothing
    assert not torch.distributed.is_initialized()
    m = mesh.make_hybrid_mesh(devices=["cpu"] * 8)
    assert m.axis_names == ("host", "data")
    assert m.shape == {"host": 1, "data": 8} and m.process_index == 0
    assert mesh.host_shard_ids(range(10), 0, 3) == [0, 3, 6, 9]


# dropped without a corpus: a duplicate within a shard of 4 (1 of 0), two
# across shards (9 of 2, 27 of 5) and a near one (20, a bit from 13); the
# corpus adds 6 and 30 (a bit off)
DUPS = [1, 9, 20, 27]
CORPUS_DUPS = [6, 30]


def _hashes():
    """32 random hashes (any two about 32 bits apart) with DUPS set."""
    h = np.random.default_rng(7).integers(0, 256, (32, 8), dtype=np.uint8)
    h[1], h[9], h[27] = h[0], h[2], h[5]
    h[20] = h[13]
    h[20, 3] ^= 4
    return h


def _expected_keep(with_corpus: bool) -> list:
    drop = DUPS + (CORPUS_DUPS if with_corpus else [])
    return [i not in drop for i in range(32)]


def _corpus(h):
    corpus = np.zeros((16, 8), np.uint8)
    corpus[0], corpus[1] = h[6], h[30]
    corpus[1, 0] ^= 1
    return corpus


def test_dedup_keep_mask_and_images_match_jax():
    h = _hashes()
    want = np.asarray(jax_phash.dedup_keep_mask(jnp.asarray(h), threshold=4))
    got = phash.dedup_keep_mask(torch.from_numpy(h), 4).numpy()
    assert np.array_equal(want, got)
    assert got.tolist() == _expected_keep(False)
    imgs = _frames(np.random.default_rng(3), (6, 48, 40, 3))
    imgs[4] = imgs[1]
    jh, jk = (np.asarray(a) for a in jax_phash.dedup_images(imgs))
    th, tk = phash.dedup_images(imgs, device="cpu")
    assert np.array_equal(jh, th.numpy()) and np.array_equal(jk, tk.numpy())
    assert not jk[4]
    th2, tk2 = phash.dedup_images(torch.from_numpy(imgs))
    assert torch.equal(th2, th) and torch.equal(tk2, tk)
    assert np.array_equal(jh, phash.phash_batch(torch.from_numpy(imgs)))


@pytest.mark.parametrize("with_corpus", [False, True])
@pytest.mark.parametrize("axis", ["data", ("host", "data")])
def test_sharded_dedup_mask_matches_jax(with_corpus, axis):
    h = _hashes()
    kw = (dict(corpus=_corpus(h), corpus_count=2) if with_corpus else {})
    if axis == "data":
        jm, tm = jax_mesh.make_mesh(8), _cpu_mesh(8)
    else:
        jm, tm = (jax_mesh.make_hybrid_mesh(),
                  mesh.make_hybrid_mesh(devices=["cpu"] * 8))
    sharded = jax.device_put(h, jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(axis)))
    want = np.asarray(jax_mesh.sharded_dedup_mask(jm, sharded, threshold=4,
                                                  axis=axis, **kw))
    if with_corpus:
        kw["corpus"] = torch.from_numpy(kw["corpus"])
    shards = mesh.shard_batch(tm, torch.from_numpy(h))
    got = mesh.sharded_dedup_mask(tm, shards, 4, axis=axis, **kw)
    assert [tuple(k.shape) for k in got] == [(4,)] * 8
    assert np.array_equal(want, torch.cat(got).numpy())
    assert want.tolist() == _expected_keep(with_corpus)


def _tree(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_trees(a: str, b: str) -> list:
    """The same files under a and b, equal byte for byte (JSON once each
    root and the wall-clock fields are blanked) -> the file names."""
    files = _tree(a)
    assert files and _tree(b) == files
    for rel in files:
        x, y = (_read(os.path.join(r, rel)) for r in (a, b))
        if rel.endswith(".json"):
            x, y = (_stable_text(t.decode(), r) for t, r in ((x, a), (y, b)))
        assert x == y, rel
    return files


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _stable_text(text: str, root: str) -> str:
    text = text.replace(root, "<out>")
    return re.sub(r'"(timestamp|generation_time|generation_id)":"[^"]*"',
                  r'"\1":""', text)


@pytest.mark.parametrize("dedup", [True, False])
def test_rpm_generator_on_a_mesh_writes_the_single_device_tree(
        tmp_path, monkeypatch, dedup):
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "stats"))
    batches = []
    real_call = rpm_pipeline.LeafPipeline.__call__

    def call(pipe, keys, use_grid):
        batches.append(keys.shape[0])
        return real_call(pipe, keys, use_grid)

    monkeypatch.setattr(rpm_pipeline.LeafPipeline, "__call__", call)
    roots, metas, calls = {}, {}, {}
    for name, m in (("single", None), ("mesh", _cpu_mesh(4))):
        roots[name] = str(tmp_path / name)
        cfg = GenConfig(out_dir=roots[name], seed=7, canvas_size=(64, 64),
                        batch_size=8, max_elems=4)
        gen = RPMGenerator(cfg, CPU, mesh=m)
        assert gen.mesh is m
        batches.clear()
        metas[name] = _stable_text(json.dumps(
            gen.generate_ids(list(range(10)), dedup=dedup, dedup_threshold=4),
            ensure_ascii=False, separators=(",", ":")), roots[name])
        gen.close()
        # the pipeline ran once a shard: batches of 2, four to a batch of 8
        calls[name] = list(batches)
    assert set(calls["single"]) == {8} and set(calls["mesh"]) == {2}
    assert len(calls["mesh"]) == 4 * len(calls["single"])
    assert metas["mesh"] == metas["single"]
    assert ('"duplicate":true' in metas["single"]) == dedup
    _assert_same_trees(roots["single"], roots["mesh"])


def test_rpm_generator_entry_points_take_the_mesh(tmp_path, monkeypatch):
    """warmup, measure_device_rate and generate_sample run each shard
    through the pipeline, and generate_sample writes what one device
    writes."""
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "stats"))
    sizes = []
    real_call = rpm_pipeline.LeafPipeline.__call__
    monkeypatch.setattr(rpm_pipeline.LeafPipeline, "__call__",
                        lambda pipe, k, u: (sizes.append(k.shape[0]),
                                            real_call(pipe, k, u))[1])
    metas = {}
    for name, m in (("single", None), ("mesh", _cpu_mesh(2))):
        root = str(tmp_path / name)
        gen = RPMGenerator(GenConfig(out_dir=root, seed=3, batch_size=2,
                                     canvas_size=(64, 64), max_elems=4),
                           CPU, mesh=m)
        sizes.clear()
        gen.warmup([0, 1])
        assert gen.measure_device_rate([0, 1], iters=1) > 0
        meta = gen.generate_sample(
            5, category_path=["图形相似", "位置变换", "平移"])
        metas[name] = _stable_text(json.dumps(meta, separators=(",", ":")),
                                   root)
        gen.close()
        assert set(sizes) == ({2} if m is None else {1})
    assert metas["mesh"] == metas["single"]
    _assert_same_trees(str(tmp_path / "single"), str(tmp_path / "mesh"))


def test_rpm_generator_mesh_rules(tmp_path):
    cfg = GenConfig(out_dir=str(tmp_path), batch_size=6, use_mesh="auto")
    gen = RPMGenerator(cfg, CPU)
    gen.close()
    assert gen.mesh is None                            # the CPU: no mesh
    with pytest.raises(ValueError, match="does not split"):
        RPMGenerator(cfg, CPU, mesh=_cpu_mesh(4))
    with pytest.raises(ValueError, match="the mesh starts at"):
        RPMGenerator(cfg, CPU, mesh=mesh.make_mesh(devices=["meta", "meta"]))


def test_auto_mesh_starts_from_the_generators_card(tmp_path, monkeypatch):
    """On a host of 4 cards a generator on cuda:1 builds its mesh from
    cuda:1 on, and use_mesh=False pins it to cuda:1 (no card is touched:
    the constructors allocate nothing on the device)."""
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "stats"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)

    def cards(*idx):
        return tuple(torch.device("cuda", i) for i in idx)

    assert mesh.auto_mesh(CPU) is None
    assert mesh.auto_mesh("cuda:1").devices == cards(1, 2, 3, 0)
    assert mesh.auto_mesh("cuda:1", batch_size=6).devices == cards(1, 2, 3)
    assert mesh.auto_mesh("cuda:3", batch_size=5) is None
    assert mesh.auto_mesh("cuda").devices == cards(2, 3, 0, 1)

    cuda1 = torch.device("cuda", 1)
    gen = mg_generator.GeometryGenerator(cuda1)
    gen.close()
    assert gen.mesh.devices == cards(1, 2, 3, 0) and gen.device == cuda1
    for use_mesh, batch, want in (("auto", 8, cards(1, 2, 3, 0)),
                                  (True, 6, cards(1, 2, 3)),
                                  (False, 8, None)):
        gen = RPMGenerator(GenConfig(out_dir=str(tmp_path / "rpm"),
                                     batch_size=batch, use_mesh=use_mesh),
                           cuda1)
        gen.close()
        assert gen.device == cuda1
        assert (gen.mesh.devices if gen.mesh else None) == want


# (seed, mode) pairs; 4 repeats 0 (another shard), 6 repeats 1 (the same
# shard), 8 repeats 2 (the ragged batch against the corpus)
MG_SCENES = [(1, "adjacent"), (2, "nested"), (3, "random"),
             (4, "intersecting"), (1, "adjacent"), (5, "nested"),
             (2, "nested"), (6, "random"), (3, "random"), (7, "adjacent"),
             (8, "intersecting")]


def test_mg_generator_on_a_mesh_writes_the_unsharded_tree(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "stats"))
    renders = []
    real_render = mg_generator.render_scene_tensors

    def render(scene, dpi):
        renders.append(len(scene["mask_mode"]))
        return real_render(scene, dpi)

    monkeypatch.setattr(mg_generator, "render_scene_tensors", render)
    seeds, modes = zip(*MG_SCENES)
    roots, records = {}, {}
    for name, m in (("single", None), ("mesh", _cpu_mesh(4))):
        root = roots[name] = str(tmp_path / name)
        gen = mg_generator.GeometryGenerator(CPU, mesh=m)
        renders.clear()
        recs = gen.generate_batches(
            list(seeds), list(modes),
            [f"{root}/images/{i}.png" for i in range(len(seeds))],
            [f"{root}/params/{i}.json" for i in range(len(seeds))],
            dpi=25, batch_size=8, dedup=True)
        gen.close()
        assert renders == ([8, 3] if m is None else [2, 2, 2, 2, 3])
        records[name] = [{k: v for k, v in r.items()
                          if k not in ("generation_id", "timestamp")}
                         for r in recs]
    assert records["mesh"] == records["single"]
    assert [i for i, r in enumerate(records["mesh"])
            if r.get("duplicate")] == [4, 6, 8]
    files = _assert_same_trees(roots["single"], roots["mesh"])
    assert len(files) == 2 * 8
