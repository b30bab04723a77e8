#!/usr/bin/env python3
# cli.py — batch generation front-end (the JAX package's flags + --device).
"""CLI for the RPM sequence-puzzle pipeline on one torch device.

Same flags, defaults and index.json as ``reasoning_image_generation_tpu.cli``:
  --out_dir --n --grid --seed --test --workers --use_threads --batch_size
  --dedup --dedup_threshold --resume --no_labels --no_border --grid_only
  --pretty_json
plus ``--device {cuda,cpu}`` (default cuda; the CPU runs only when asked
for by name).  ``--sparse``, ``--no_aot`` and ``--profile_dir`` are
accepted and do nothing; ``--num_hosts > 1`` and ``--coordinator`` are not
supported yet.

    python -m reasoning_image_generation_tpu_torch.cli --out_dir out --n 64
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time


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
                   help="accepted for compatibility; ignored")
    p.add_argument("--no_labels", action="store_true",
                   help="omit S0../A-D cell labels on the grids")
    p.add_argument("--no_border", action="store_true",
                   help="omit the 1px cell borders on the grids")
    p.add_argument("--sparse", action="store_true",
                   help="accepted for compatibility; ignored (frames are "
                        "copied to the host raw)")
    p.add_argument("--grid_only", action="store_true",
                   help="export only grid_%%06d.png + meta/coco")
    p.add_argument("--pretty_json", action="store_true",
                   help="write meta/coco JSON with indent=2")
    p.add_argument("--no_aot", action="store_true",
                   help="accepted for compatibility; ignored")
    p.add_argument("--num_hosts", type=int, default=1,
                   help="only 1 is supported")
    p.add_argument("--host_id", type=int, default=0)
    p.add_argument("--coordinator", type=str, default=None,
                   help="not supported")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device to generate on (default: cuda)")
    return p.parse_args(argv)


def write_index(out_dir: str, metas):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "index.json"), "w", encoding="utf-8") as f:
        json.dump(metas, f, ensure_ascii=False, indent=2)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    if args.num_hosts > 1 or args.coordinator:
        raise NotImplementedError(
            "multi-host generation (--num_hosts > 1, --coordinator) is not "
            "ported yet")
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
                    pretty_json=args.pretty_json)
    workers = args.workers if args.workers is not None else 8
    gen = RPMGenerator(cfg, device, io_workers=max(1, workers),
                       use_threads=workers != 0,
                       show_labels=not args.no_labels,
                       show_border=not args.no_border)
    ids = list(range(args.n))
    t0 = time.time()
    print(f"Start generating {len(ids)} samples -> {args.out_dir} "
          f"(batch={args.batch_size}, seed={args.seed}, device={device})")
    metas = gen.generate_ids(ids, progress=True, dedup=args.dedup,
                             dedup_threshold=args.dedup_threshold,
                             resume=args.resume)
    gen.close()
    write_index(args.out_dir, metas)
    dt = time.time() - t0
    print(f"Done. Generated {len(metas)} samples to {args.out_dir} "
          f"in {dt:.2f}s ({len(metas)/dt:.2f} samples/s)")


if __name__ == "__main__":
    main()
