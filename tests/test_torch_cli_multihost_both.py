# test_torch_cli_multihost_both.py — both CLIs, two hosts, one merged index.
"""The JAX package's CLI and the port's (``--device cpu``) on the same seed
with ``--num_hosts 2``, ``--host_id 0`` then ``1``, grid-only, with a
merge-time dedup that drops samples: the merged index.json and the files
left on disk must be the same.

Tolerance: exact.  Indexes are compared as parsed JSON with the out_dir
replaced and the wall-clock fields dropped.
"""
import json
import os

import torch

from reasoning_image_generation_tpu_torch import cli

from .test_torch_generator import _no_timestamps, _tree

torch.set_num_threads(1)

# pHash distances of seed 7's first four grids: 24 (ids 0, 2) and 30 (1, 3)
# within a host, 22 (0-1, 2-3), 28 and 32 across: at 22 each host keeps both
# of its samples and the merge drops ids 1 and 3
MERGE_THRESHOLD = 22


def test_both_clis_write_the_same_merged_index(tmp_path):
    """Two hosts, grid-only, merge-time dedup at a threshold that drops a
    sample: index.json, the shards' ids and the files left on disk are the
    same from both packages.  The seed and threshold are chosen so that the
    two hosts' own dedup keeps a pair that the merge then finds."""
    from reasoning_image_generation_tpu import cli as jax_cli
    roots = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        common = [*extra, "--out_dir", out, "--n", "4", "--seed", "7",
                  "--batch_size", "2", "--num_hosts", "2", "--grid_only",
                  "--dedup", "--dedup_threshold", str(MERGE_THRESHOLD)]
        main(common + ["--host_id", "0"])
        main(common + ["--host_id", "1"])
        roots[name] = out
    index = {n: _no_timestamps(json.loads(
        open(os.path.join(r, "index.json"), encoding="utf-8").read()
        .replace(r, "<out>"))) for n, r in roots.items()}
    assert index["port"] == index["jax"]
    assert [m["id"] for m in index["port"] if m.get("duplicate")] == [1, 3]
    keep = lambda files: [f for f in files if not f.endswith(".tmp")]
    assert keep(_tree(roots["port"])) == keep(_tree(roots["jax"]))
    for m in index["port"]:
        gone = m.get("duplicate", False)
        path = os.path.join(roots["port"], "grids", f"grid_{m['id']:06d}.png")
        assert os.path.exists(path) != gone
