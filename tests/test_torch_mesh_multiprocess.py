# test_torch_mesh_multiprocess.py — a two-process torch.distributed world.
"""Two CPU processes join one gloo world through the port's
``distributed_init(..., backend="gloo")``, each with
``make_hybrid_mesh(devices=[cpu, cpu])``: a 2x2 ("host", "data") mesh.
On the hashes of tests/test_mesh_multiprocess.py (8 in all, 4 a process;
index 5, on process 1, duplicates index 1, on process 0; the corpus holds
index 2) ``sharded_dedup_mask`` over ("host", "data") must give the same
global keep masks as the JAX package there, and ``RPMGenerator`` must
refuse the multi-process world.

The worker body is this file run as a script:
``python tests/test_torch_mesh_multiprocess.py <pid> <nproc> <port> <dir>``.
"""
import json
import os
import socket
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_world_global_dedup(tmp_path):
    port = _free_port()
    env = {**os.environ,
           "PYTHONPATH": _REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(pid), "2", str(port),
         str(tmp_path)], cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        line = [l for l in out.splitlines() if l.startswith("MESH_RESULT ")]
        assert line, f"no result line:\n{out[-3000:]}"
        r = json.loads(line[-1][len("MESH_RESULT "):])
        results[r["pid"]] = r
    assert results[0]["shape"] == results[1]["shape"] == {"host": 2, "data": 2}
    assert set(results[0]["shard_ids"]) == {0, 2, 4, 6}
    assert set(results[1]["shard_ids"]) == {1, 3, 5, 7}
    # the JAX package's masks (tests/test_mesh_multiprocess.py)
    assert results[0]["mask"] == [1, 1, 1, 1]
    assert results[1]["mask"] == [1, 0, 1, 1]
    assert results[0]["mask_corpus"] == [1, 1, 0, 1]
    assert results[1]["mask_corpus"] == [1, 0, 1, 1]
    assert results[0]["refused"] and results[1]["refused"]


def _worker(pid: int, nproc: int, port: str, out_dir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from reasoning_image_generation_tpu_torch.models.rpm.generator import (
        RPMGenerator)
    from reasoning_image_generation_tpu_torch.parallel.mesh import (
        distributed_init, host_shard_ids, make_hybrid_mesh, shard_batch,
        sharded_dedup_mask)
    from reasoning_image_generation_tpu_torch.utils.config import GenConfig

    torch.set_num_threads(1)
    distributed_init(f"127.0.0.1:{port}", nproc, pid, backend="gloo")
    try:
        mesh = make_hybrid_mesh(devices=["cpu", "cpu"])
        rng = np.random.default_rng(0)
        full = rng.integers(0, 256, (8, 8), dtype=np.uint8)
        full[5] = full[1]
        shards = shard_batch(mesh, torch.from_numpy(full[pid * 4:pid * 4 + 4]))
        axis = ("host", "data")
        mask = torch.cat(sharded_dedup_mask(mesh, shards, 4, axis=axis))
        corpus = np.zeros((16, 8), np.uint8)
        corpus[0] = full[2]
        mask_c = torch.cat(sharded_dedup_mask(
            mesh, shards, 4, axis=axis, corpus=torch.from_numpy(corpus),
            corpus_count=1))
        try:
            RPMGenerator(GenConfig(out_dir=os.path.join(out_dir, str(pid))),
                         torch.device("cpu"))
            refused = False
        except NotImplementedError:
            refused = True
        print("MESH_RESULT " + json.dumps({
            "pid": pid, "shape": mesh.shape,
            "shard_ids": host_shard_ids(range(8), pid, nproc),
            "mask": mask.int().tolist(), "mask_corpus": mask_c.int().tolist(),
            "refused": refused}), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
