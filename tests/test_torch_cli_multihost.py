# test_torch_cli_multihost.py — the port's host-sharded CLI and its merge.
"""The six cases of tests/test_cli_multihost.py on the port's CLI
(``--num_hosts 2`` with ``--host_id 0`` and ``1`` into one out_dir, no
coordinator).  Both packages' CLIs on the same seed are in
tests/test_torch_cli_multihost_both.py, a file of its own so that no worker
of a file-sharded run takes both long cases.  Everything runs on the CPU
(``--device cpu``).

Tolerance: exact.  Indexes are compared as parsed JSON with the out_dir
replaced and the wall-clock fields dropped; duplicate flags, hashes and
the files left on disk must be the same.
"""
import json
import os

import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu_torch import cli
from reasoning_image_generation_tpu_torch.cli import merge_host_indexes
from reasoning_image_generation_tpu_torch.parallel.mesh import host_shard_ids

from .test_torch_generator import _no_timestamps, _tree

torch.set_num_threads(1)


def _load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f)


def test_host_shard_ids_needs_both_ranks_and_strides():
    ids = list(range(10, 21))
    shards = [host_shard_ids(ids, k, 3) for k in range(3)]
    assert shards[0] == [10, 13, 16, 19] and shards[2] == [12, 15, 18]
    assert sorted(sum(shards, [])) == ids
    assert host_shard_ids(ids, 0, 1) == ids
    with pytest.raises(TypeError):
        host_shard_ids(ids)
    with pytest.raises(ValueError):
        host_shard_ids(ids, 3, 3)


def test_two_host_cli_shards_and_merged_index(tmp_path):
    out = str(tmp_path / "out")
    common = ["--device", "cpu", "--out_dir", out, "--n", "4", "--seed", "7",
              "--batch_size", "2", "--num_hosts", "2"]
    cli.main(common + ["--host_id", "0"])
    assert not os.path.exists(os.path.join(out, "index.json"))   # the gate
    cli.main(common + ["--host_id", "1"])

    s0 = _load(os.path.join(out, "index_host00.json"))
    s1 = _load(os.path.join(out, "index_host01.json"))
    assert s0["run_id"] == s1["run_id"] == "seed7-n4-h2-g3-doff-full"
    assert [m["id"] for m in s0["metas"]] == [0, 2]
    assert [m["id"] for m in s1["metas"]] == [1, 3]
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]

    idx = _load(os.path.join(out, "index.json"))
    assert [m["id"] for m in idx] == [0, 1, 2, 3]
    for m in idx:
        assert os.path.exists(m["grid_path"])
        assert os.path.exists(os.path.join(m["sample_dir"], "meta.json"))
        assert len(bytes.fromhex(m["grid_phash"])) == 8


def test_merge_dedup_across_host_shards(tmp_path):
    h_a = "00" * 8
    h_a_near = "03" + "00" * 7       # hamming distance 2 from h_a
    h_b = "ff" * 8
    shard0 = [{"id": 0, "grid_phash": h_a}, {"id": 2, "grid_phash": h_b}]
    shard1 = [{"id": 1, "grid_phash": h_a_near},
              {"id": 3, "grid_phash": "0f" * 8}]
    out = str(tmp_path)
    for i, shard in enumerate((shard0, shard1)):
        _dump(shard, os.path.join(out, f"index_host{i:02d}.json"))
    metas = merge_host_indexes(out, dedup_threshold=4)
    dup = {m["id"]: m.get("duplicate", False) for m in metas}
    assert dup == {0: False, 1: True, 2: False, 3: False}
    assert len(_load(os.path.join(out, "index.json"))) == 4


def test_merge_gate_waits_for_all_shards(tmp_path):
    out = str(tmp_path)
    _dump([{"id": 0}], os.path.join(out, "index_host00.json"))
    # a stale shard of an old 3-host run neither opens nor pollutes the gate
    _dump([{"id": 99}], os.path.join(out, "index_host02.json"))
    assert merge_host_indexes(out, num_hosts=2) is None
    assert not os.path.exists(os.path.join(out, "index.json"))
    with open(os.path.join(out, "index_host01.json"), "w") as f:
        f.write('[{"id": 1')                     # a torn write
    assert merge_host_indexes(out, num_hosts=2) is None
    _dump([{"id": 1}], os.path.join(out, "index_host01.json"))
    metas = merge_host_indexes(out, num_hosts=2)
    assert [m["id"] for m in metas] == [0, 1]


def test_merge_dedup_removes_duplicate_artifacts(tmp_path):
    out = str(tmp_path)
    sdir = os.path.join(out, "samples", "sample_000001")
    os.makedirs(sdir)
    gpath = os.path.join(out, "grids", "grid_000001.png")
    os.makedirs(os.path.dirname(gpath))
    _dump({}, os.path.join(sdir, "meta.json"))
    with open(gpath, "wb") as f:
        f.write(b"png")
    shard = [{"id": 0, "grid_phash": "00" * 8},
             {"id": 1, "grid_phash": "00" * 8,
              "sample_dir": sdir, "grid_path": gpath}]
    _dump(shard, os.path.join(out, "index_host00.json"))
    metas = merge_host_indexes(out, dedup_threshold=4, num_hosts=1)
    assert metas[1]["duplicate"]
    assert not os.path.exists(sdir) and not os.path.exists(gpath)


def test_merge_dedup_matches_scalar_oracle(tmp_path):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (12, 8), np.uint8)
    hashes = base[rng.integers(0, 12, 80)]
    flips = rng.integers(0, 2, hashes.shape).astype(np.uint8)
    hashes = hashes ^ (flips & rng.integers(0, 2, hashes.shape).astype(np.uint8))
    metas = [{"id": i, "grid_phash": bytes(h).hex()}
             for i, h in enumerate(hashes)]
    _dump(metas, os.path.join(str(tmp_path), "index_host00.json"))
    merged = merge_host_indexes(str(tmp_path), dedup_threshold=4, num_hosts=1)
    kept, expect = [], {}
    for i, h in enumerate(hashes):
        hb = bytes(h)
        dup = any(sum(bin(a ^ b).count("1") for a, b in zip(hb, k)) <= 4
                  for k in kept)
        expect[i] = dup
        if not dup:
            kept.append(hb)
    assert {m["id"]: m.get("duplicate", False) for m in merged} == expect
    assert any(expect.values()) and not all(expect.values())


def test_merge_gate_ignores_stale_run_shards(tmp_path):
    out = str(tmp_path)
    _dump({"run_id": "new", "metas": [{"id": 0}]},
          os.path.join(out, "index_host00.json"))
    _dump({"run_id": "old", "metas": [{"id": 999}]},
          os.path.join(out, "index_host01.json"))
    assert merge_host_indexes(out, num_hosts=2, run_id="new") is None
    _dump({"run_id": "new", "metas": [{"id": 1}]},
          os.path.join(out, "index_host01.json"))
    metas = merge_host_indexes(out, num_hosts=2, run_id="new")
    assert [m["id"] for m in metas] == [0, 1]
    _dump([{"id": 5}], os.path.join(out, "index_host01.json"))
    assert [m["id"] for m in merge_host_indexes(out, num_hosts=2)] == [0, 5]


def test_coordinator_ends_in_the_same_systemexit_text():
    from reasoning_image_generation_tpu import cli as jax_cli
    texts = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
        with pytest.raises(SystemExit) as e:
            main([*extra, "--coordinator", "localhost:1234"])
        texts.append(str(e.value))
    assert texts[0] == texts[1] and "--coordinator is not supported" in texts[0]


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    prof = tmp_path / "prof"
    cli.main(["--device", "cpu", "--out_dir", str(tmp_path / "o"), "--n", "1",
              "--batch_size", "1", "--seed", "0", "--grid_only",
              "--profile_dir", str(prof)])
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in _load(str(traces[0]))
