# test_torch_leaf_blob.py — the raw transfer's blob written by the leaf's step.
"""Without a transfer codec and without a mesh, ``RPMGenerator._dispatch``
takes the batch's blob from ``LeafPipeline.blob``: the leaf's step and
``io/transfer.blob_step`` in one step, one CUDA graph a leaf on a card, so
no second graph holds the batch's frames.  A packed codec and a mesh keep
the leaf step, the compaction and the separate blob step
(``RPMGenerator._coalesce``).  The dedup's keep mask crosses to the host
beside the blob.  On the CPU every step runs as it is.

- One leaf of each distinct output tree (the three overlay leaves share
  one; the nine leaves make seven): the blob's bytes and layout, and the
  host's split of them, equal the leaf step followed by the blob step,
  and the split equals the step's outputs as they cross (exact).
- The dedup at 1 bit over 12 grid-only ids: the duplicates are those of a
  greedy pass over a run's pHashes in generation order, both decisions
  occur, and the kept ids' files equal those of a run without the dedup.
- Raw, the leaf's step writes the blob; rle4d and a mesh of two CPU
  handles take the blob step; the ``rpm.batch`` spans say which
  (grid-only).
- On a card (skips without one): a warm call of full export at 512²,
  batch 32, over one id of each leaf captures 9 leaf graphs and no blob
  graph, and one leaf's replayed blob equals the separate path's byte for
  byte.  It imports nothing of the JAX package, so on a card:
  ``python -m pytest --noconftest -p no:cacheprovider -q
  tests/test_torch_leaf_blob.py -k card``.

Canvas 64, batch 2.
"""
import json
import os

import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu_torch.io import transfer
from reasoning_image_generation_tpu_torch.models.rpm import generator
from reasoning_image_generation_tpu_torch.models.rpm.generator import (
    RPMGenerator)
from reasoning_image_generation_tpu_torch.parallel import mesh
from reasoning_image_generation_tpu_torch.utils import graphs, profiling
from reasoning_image_generation_tpu_torch.utils.config import (
    OVERLAY_LEAVES, RULE_LEAVES, GenConfig)

torch.set_num_threads(1)

S = 64
CPU = torch.device("cpu")
# one leaf of each distinct tree: the overlay leaves share theirs
DISTINCT = [l for l in RULE_LEAVES if l not in OVERLAY_LEAVES[1:]]


@pytest.fixture(autouse=True)
def own_stats(tmp_path, monkeypatch):
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "stats"))


def make_gen(root, device=CPU, mesh_=None, **kw):
    kw.setdefault("canvas_size", (S, S))
    kw.setdefault("batch_size", 2)
    return RPMGenerator(GenConfig(out_dir=str(root), seed=7, **kw), device,
                        mesh=mesh_)


def path_of(gen, leaf):
    return next(p for p in gen._leaves if p[-1] == leaf)


def count_calls(monkeypatch, obj, name):
    """Patch ``obj.name`` to note each call in the returned list."""
    calls, real = [], getattr(obj, name)
    monkeypatch.setattr(obj, name, lambda *a, **k: (calls.append(1),
                                                    real(*a, **k))[1])
    return calls


def tree_key(out):
    leaves, treedef = transfer.tree_flatten(out)
    return treedef, tuple((tuple(a.shape), a.dtype) for a in leaves)


def test_the_nine_leaves_make_seven_trees(tmp_path):
    """DISTINCT names one leaf of each tree the leaf steps output."""
    gen = make_gen(tmp_path)
    keys, ug = gen._batch_inputs([(3, None, False), (11, None, True)])
    trees = {}
    for leaf in RULE_LEAVES:
        trees.setdefault(tree_key(gen._pipeline(leaf).step(keys, ug)),
                         []).append(leaf)
    gen.close()
    assert len(trees) == 7
    assert sorted(ls[0] for ls in trees.values()) == sorted(DISTINCT)


@pytest.mark.parametrize("leaf", DISTINCT)
def test_leaf_blob_equals_step_then_blob(leaf, tmp_path, monkeypatch):
    gen = make_gen(tmp_path)
    coalesced = count_calls(monkeypatch, gen, "_coalesce")
    chunk = [(3, path_of(gen, leaf), False), (11, path_of(gen, leaf), True)]
    pipe = gen._pipeline(leaf)
    _l, _p, _c, (copy, keep, treedef, specs, raw, n_real) = gen._dispatch(
        leaf, pipe, chunk)
    got = copy.numpy()
    keys, ug = gen._batch_inputs(chunk)
    out = pipe.step(keys, ug)
    sizes = gen._shrink_sizes(leaf, out)
    assert sizes == (None,) * len(transfer.tree_leaves(out))
    want, layout = transfer.blob_step(
        out, sizes=sizes,
        flat=gen.cfg.transfer_codec in generator._COMPACT_CODECS)
    gen.close()
    assert coalesced == [] and keep is None and raw == {} and n_real == 2
    assert (treedef, specs) == layout.value
    assert got.dtype == np.uint8 and np.array_equal(got, want.numpy())
    split = transfer.split_flat if got.ndim == 1 else transfer.split_blob
    host, host_def = transfer.tree_flatten(split(got, treedef, specs))
    step, step_def = transfer.tree_flatten(out)
    assert host_def == step_def
    for h, a in zip(host, step):
        a = transfer.host_array(transfer.narrow(a))
        assert h.dtype == a.dtype and np.array_equal(h, a)


def _no_clock(x):
    """`x` with every wall-clock entry dropped, at any depth."""
    if isinstance(x, dict):
        return {k: _no_clock(v) for k, v in x.items()
                if k not in ("timestamp", "generation_time")}
    if isinstance(x, list):
        return [_no_clock(v) for v in x]
    return x


def _files(root):
    """{relative path: bytes} of the PNGs and sample JSONs under `root`,
    wall-clock fields dropped from the JSON."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, root)
            if f.endswith(".json"):
                with open(p, encoding="utf-8") as fh:
                    out[rel] = _no_clock(json.loads(
                        fh.read().replace(root, "<out>")))
            elif f.endswith(".png"):
                with open(p, "rb") as fh:
                    out[rel] = fh.read()
    return out


def test_keep_mask_beside_the_blob_keeps_the_decisions(tmp_path):
    ids, thr = list(range(12)), 1
    metas, files = {}, {}
    for dedup in (False, True):
        root = str(tmp_path / str(dedup))
        gen = make_gen(root, grid_only=True)
        metas[dedup] = {m["id"]: m for m in gen.generate_ids(
            ids, dedup=dedup, dedup_threshold=thr)}
        order = [e for es in gen._sample_assignments(ids).values()
                 for e in es]
        gen.close()
        files[dedup] = _files(root)
    kept, dups = [], set()
    for sid, _path, _ug in order:
        h = int(metas[False][sid]["grid_phash"], 16)
        if any(bin(h ^ k).count("1") <= thr for k in kept):
            dups.add(sid)
        else:
            kept.append(h)
    assert 0 < len(dups) < len(ids)
    assert {s for s, m in metas[True].items() if m.get("duplicate")} == dups
    for sid, path, _ug in order:
        if sid in dups:
            assert metas[True][sid] == {"id": sid, "category_path": list(path),
                                        "rule": path[-1], "duplicate": True}
    assert files[True] == {
        rel: v for rel, v in files[False].items()
        if not any(f"_{sid:06d}" in rel for sid in dups)}


@pytest.mark.parametrize("case", ["raw", "rle4d", "mesh"])
def test_each_path_writes_its_blob(case, tmp_path, monkeypatch):
    """Raw, the leaf's step writes each batch's blob; rle4d and a mesh run
    the blob step; each ``rpm.batch`` span says which (grid-only)."""
    kw, m = {}, None
    if case == "rle4d":
        kw = {"sparse_transfer": True, "transfer_codec": "rle4d"}
    elif case == "mesh":
        m = mesh.make_mesh(devices=["cpu"] * 2)
    gen = make_gen(tmp_path, mesh_=m, grid_only=True, **kw)
    coalesced = count_calls(monkeypatch, gen, "_coalesce")
    leaf_blobs = count_calls(monkeypatch, generator.LeafPipeline, "blob")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        n = len(profiling.spans())
        metas = gen.generate_ids([3, 4])
    batches = [s for s in profiling.spans()[n:] if s.name == "rpm.batch"]
    gen.close()
    assert not any(mt.get("error") for mt in metas)
    by_leaf = case == "raw"
    assert len(leaf_blobs if by_leaf else coalesced) == len(batches) > 0
    assert (coalesced if by_leaf else leaf_blobs) == []
    assert {b.attrs["blob"] for b in batches} == {
        "leaf" if by_leaf else "step"}


# ---- on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_card_full_export_captures_leaf_blobs(card, tmp_path):
    gen = make_gen(tmp_path, device=card, canvas_size=(512, 512),
                   batch_size=32)
    first = {}
    for es in gen._sample_assignments(range(400)).values():
        sid, path, _ug = es[0]
        first[path[-1]] = sid
    assert len(first) == 9
    caps = graphs.CAPTURES
    metas = gen.generate_ids(sorted(first.values()))
    captured = graphs.CAPTURES - caps
    pipes = gen._pipelines
    assert not any(mt.get("error") for mt in metas)
    assert [len(p._blobs._captured) for p in pipes.values()] == [1] * 9
    assert not any(p._graphs._captured for p in pipes.values())
    assert not gen._coalesce._captured
    assert captured == 9 + len(gen._keys._captured)
    # a second key set through 平移: its leaf graph's blob against the leaf
    # step's graph and the blob step's graph
    leaf = "平移"
    path = path_of(gen, leaf)
    keys, ug = gen._batch_inputs([(sid, path, sid % 3 == 0)
                                  for sid in range(1000, 1032)])
    flat = gen.cfg.transfer_codec in generator._COMPACT_CODECS
    blob, layout, hashes = pipes[leaf].blob(keys, ug, flat=flat)
    out = pipes[leaf](keys, ug)
    want, want_layout = gen._coalesce(
        out, sizes=(None,) * len(transfer.tree_leaves(out)), flat=flat)
    gen.close()
    assert layout.value == want_layout.value
    assert blob.dtype == want.dtype and torch.equal(blob, want)
    assert torch.equal(hashes, out["grid_phash"])
