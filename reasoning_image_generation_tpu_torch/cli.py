#!/usr/bin/env python3
# cli.py — batch generation front-end (the JAX package's flags + --device).
"""CLI for the RPM sequence-puzzle pipeline on one torch device.

Same flags, defaults and index.json as ``reasoning_image_generation_tpu.cli``:
  --out_dir --n --grid --seed --test --workers --use_threads --batch_size
  --dedup --dedup_threshold --resume --no_labels --no_border --grid_only
  --pretty_json
  --profile_dir --num_hosts --host_id
plus ``--device {cuda,cpu}`` (default cuda; the CPU runs only when asked
for by name).  ``--sparse`` packs the frames on the device before they
cross to the host (``GenConfig.transfer_codec``, default 'rle4d': runs,
palettes and inter-frame deltas; the PNGs are written from the runs) and
writes the same files.  ``--no_aot`` is accepted and does nothing (the
port's compiled step is a CUDA graph, captured in the process that runs
it: it has no on-disk form to skip); ``--coordinator`` is refused with an
explanation, as there.

    python -m reasoning_image_generation_tpu_torch.cli --out_dir out --n 64

Several hosts: one independent process per host, each with ``--num_hosts N
--host_id K`` and the same other flags, into one out_dir.  Host K
generates the ids with ``id % N == K`` and publishes ``index_hostKK.json``
(written to a temporary file and renamed, so no reader sees half of one).
The host that finds all N shards of this run merges them into index.json;
with ``--dedup`` the merge repeats the pHash dedup across hosts (first by id
wins) and deletes the files of the samples it drops.
"""
from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import re
import shutil
import time
from typing import Optional

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", type=str, default="./out")
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--grid", type=int, default=3)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--test", action="store_true")
    p.add_argument("--workers", type=int, default=None,
                   help="export-pool threads (default: 8)")
    p.add_argument("--use_threads", action="store_true", default=True,
                   help="kept for reference-flag compatibility (export is "
                        "always thread-pooled unless --workers 0)")
    p.add_argument("--batch_size", type=int, default=32,
                   help="samples per pipeline call")
    p.add_argument("--dedup", action="store_true",
                   help="drop near-duplicate samples (pHash)")
    p.add_argument("--dedup_threshold", type=int, default=4)
    p.add_argument("--resume", action="store_true",
                   help="skip sample ids whose meta.json already exists")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the run "
                        "into this directory")
    p.add_argument("--no_labels", action="store_true",
                   help="omit S0../A-D cell labels on the grids")
    p.add_argument("--no_border", action="store_true",
                   help="omit the 1px cell borders on the grids")
    p.add_argument("--sparse", action="store_true",
                   help="lossless device->host transfer codec: frames are "
                        "packed on the device (GenConfig.transfer_codec, "
                        "default rle4d) and PNGs written from the runs")
    p.add_argument("--grid_only", action="store_true",
                   help="export only grid_%%06d.png + meta/coco")
    p.add_argument("--pretty_json", action="store_true",
                   help="write meta/coco JSON with indent=2")
    p.add_argument("--no_aot", action="store_true",
                   help="accepted for compatibility; ignored")
    p.add_argument("--num_hosts", type=int, default=1,
                   help="total host processes generating into out_dir; "
                        "this host writes the ids where "
                        "id %% num_hosts == host_id")
    p.add_argument("--host_id", type=int, default=0,
                   help="this host's rank in [0, num_hosts)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="unsupported: hosts run independently over disjoint "
                        "id shards and the merge step dedups across hosts "
                        "via the pHashes carried in every meta, so no "
                        "lockstep collective is needed.  Passing a "
                        "coordinator is an error.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device to generate on (default: cuda)")
    return p.parse_args(argv)


def write_index(out_dir: str, metas):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "index.json"), "w", encoding="utf-8") as f:
        json.dump(metas, f, ensure_ascii=False, indent=2)


def _merge_dedup(metas, dedup_threshold: int) -> None:
    """Greedy first-wins-by-id pHash dedup across merged metas, as the
    generator's corpus pass does it on the device: a sample is a duplicate
    when within `dedup_threshold` Hamming bits of an earlier kept one.
    Samples marked here have their exported files deleted (a duplicate
    found inside a generator is never exported), so the directory matches
    the index."""
    cand = [m for m in metas
            if not m.get("duplicate") and not m.get("error")
            and m.get("grid_phash")]
    if not cand:
        return
    hashes = np.stack([np.frombuffer(bytes.fromhex(m["grid_phash"]),
                                     np.uint8) for m in cand])
    kept = np.empty_like(hashes)
    n_kept = 0
    for m, h in zip(cand, hashes):
        if n_kept:
            dist = np.unpackbits(kept[:n_kept] ^ h[None, :],
                                 axis=1).sum(axis=1)
            if int(dist.min()) <= dedup_threshold:
                m["duplicate"] = True
                _remove_sample_artifacts(m)
                continue
        kept[n_kept] = h
        n_kept += 1


def _remove_sample_artifacts(meta: dict) -> None:
    """Delete the exported files of a merge-time duplicate."""
    d = meta.get("sample_dir")
    if d and os.path.isdir(d):
        shutil.rmtree(d, ignore_errors=True)
    g = meta.get("grid_path")
    if g and os.path.exists(g):
        try:
            os.remove(g)
        except OSError:
            pass


def merge_host_indexes(out_dir: str, dedup_threshold: Optional[int] = None,
                       num_hosts: Optional[int] = None,
                       run_id: Optional[str] = None):
    """Merge the per-host shards (index_hostNN.json) into index.json, sorted
    by id.  A shard that does not parse counts as not yet there.  With
    `num_hosts` the merge happens only once all shards 0..num_hosts-1 are
    there (else None is returned: the last host to finish merges), and
    shards of a larger earlier run are ignored.  With `run_id`, shards
    stamped with another run's id count as not yet there, so a fast host
    cannot merge with another host's leftover.  With `dedup_threshold` the
    corpus dedup is repeated across hosts (``_merge_dedup``)."""
    shards = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "index_host*.json"))):
        m = re.search(r"index_host(\d+)\.json$", path)
        if not m:
            continue
        rank = int(m.group(1))
        if num_hosts is not None and rank >= num_hosts:
            continue  # stale shard from a previous, larger run
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError):
            shards.pop(rank, None)  # unreadable == not yet present
            continue
        # {"run_id":…, "metas":[…]} (CLI) or a bare meta list (library use)
        shard_run, metas = ((data.get("run_id"), data.get("metas", []))
                            if isinstance(data, dict) else (None, data))
        if run_id is not None and shard_run != run_id:
            continue  # stale shard from a different run
        shards[rank] = metas
    if num_hosts is not None and set(shards) != set(range(num_hosts)):
        return None  # another host will finish later and merge
    metas = [m for rank in sorted(shards) for m in shards[rank]]
    metas.sort(key=lambda m: m.get("id", m.get("index", 0)))
    if dedup_threshold is not None:
        _merge_dedup(metas, dedup_threshold)
    write_index(out_dir, metas)
    return metas


def _run_id(args) -> str:
    """The id of one multi-host run: every host derives the same value from
    the launch parameters they share, so stamping needs no coordination."""
    return (f"seed{args.seed}-n{args.n}-h{args.num_hosts}-g{args.grid}"
            f"-d{args.dedup_threshold if args.dedup else 'off'}"
            f"-{'grid' if args.grid_only else 'full'}")


def _shard_path(args) -> str:
    return os.path.join(args.out_dir, f"index_host{args.host_id:02d}.json")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    if args.coordinator:
        raise SystemExit(
            "--coordinator is not supported: hosts scale out "
            "independently over disjoint id shards "
            "(--num_hosts/--host_id); the merge step dedups across hosts "
            "via the pHash carried in every meta, so no lockstep "
            "collective is needed.")
    from .utils.config import GenConfig

    from .device import resolve_device
    from .models.rpm.generator import RPMGenerator

    device = resolve_device(args.device)
    if args.test:
        cfg = GenConfig(out_dir="./out_test", grid_size=3, seed=42,
                        batch_size=32)
        gen = RPMGenerator(cfg, device)
        metas = gen.generate(3)
        gen.close()
        for m in metas:
            for p in (m["sample_dir"], m["grid_path"],
                      os.path.join(m["sample_dir"], "meta.json"),
                      os.path.join(m["sample_dir"], "coco.json")):
                if not os.path.exists(p):
                    raise SystemExit(f"integration test failed: {p} missing")
        print("Integration test passed, samples in ./out_test")
        return

    cfg = GenConfig(out_dir=args.out_dir, grid_size=args.grid, seed=args.seed,
                    batch_size=args.batch_size, grid_only=args.grid_only,
                    pretty_json=args.pretty_json, sparse_transfer=args.sparse)
    workers = args.workers if args.workers is not None else 8
    gen = RPMGenerator(cfg, device, io_workers=max(1, workers),
                       use_threads=workers != 0,
                       show_labels=not args.no_labels,
                       show_border=not args.no_border)
    ids = list(range(args.n))
    if args.num_hosts > 1:
        from .parallel.mesh import host_shard_ids
        ids = host_shard_ids(ids, process_index=args.host_id,
                             process_count=args.num_hosts)
        # clear this host's shard of an earlier run, so that the merge gate
        # waits for this run's
        try:
            os.remove(_shard_path(args))
        except OSError:
            pass
    t0 = time.time()
    print(f"Start generating {len(ids)} samples -> {args.out_dir} "
          f"(batch={args.batch_size}, seed={args.seed}, device={device})")
    from .utils.profiling import trace
    with trace(args.profile_dir):
        metas = gen.generate_ids(ids, progress=True, dedup=args.dedup,
                                 dedup_threshold=args.dedup_threshold,
                                 resume=args.resume)
    gen.close()
    if args.num_hosts > 1:
        # publish atomically; only the host that sees every shard of this
        # run merges, and the merge is idempotent
        run_id = _run_id(args)
        tmp = _shard_path(args) + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"run_id": run_id, "metas": metas},
                      f, ensure_ascii=False, indent=2)
        os.replace(tmp, _shard_path(args))
        merge_host_indexes(args.out_dir,
                           args.dedup_threshold if args.dedup else None,
                           num_hosts=args.num_hosts, run_id=run_id)
    else:
        write_index(args.out_dir, metas)
    dt = time.time() - t0
    print(f"Done. Generated {len(metas)} samples to {args.out_dir} "
          f"in {dt:.2f}s ({len(metas)/dt:.2f} samples/s)")


if __name__ == "__main__":
    main()
