# cli.py — multigraph batch front-end (the JAX package's flags + --device).
"""Generates the single-image dataset on one torch device.

Same flags and defaults as the JAX package's models/multigraph/cli.py
(reference multigraph_generation/cli.py:30-72): 100 samples,
global_scale=1.3, dpi=200, batch 16, modes 'adjacent', seed 0; outputs
out_dir/images/{i}_{mode}.png and out_dir/params/{i}_{mode}.json with
per-sample seed seed+i, modes pre-sampled with ``random.choice``.  Plus
``--device {cuda,cpu}`` (default cuda; the CPU runs only when asked for).

    python -m reasoning_image_generation_tpu_torch.models.multigraph.cli \\
        --n 64 --modes random,nested,adjacent,intersecting
"""
from __future__ import annotations

import argparse
import random
import time


def generate_all(device, num_samples: int = 100, out_dir: str = "output",
                 global_scale: float = 1.3, dpi: int = 200,
                 mode_choices=("adjacent",), batch_size: int = 16,
                 seed0: int = 0):
    from .generator import GeometryGenerator

    # pre-sample modes like the reference (multigraph_generation/cli.py:41-42)
    modes = [random.choice(list(mode_choices)) for _ in range(num_samples)]
    gen = GeometryGenerator(device, global_scale=global_scale)
    t0 = time.time()
    gen.generate_batches(
        seeds=[seed0 + i for i in range(num_samples)],
        modes=modes,
        save_paths=[f"{out_dir}/images/{i}_{modes[i]}.png"
                    for i in range(num_samples)],
        params_save_paths=[f"{out_dir}/params/{i}_{modes[i]}.json"
                           for i in range(num_samples)],
        dpi=dpi, batch_size=batch_size,
        progress=lambda done: print(f"生成完成：{done}/{num_samples}"))
    gen.close()
    dt = time.time() - t0
    print(f"所有生成任务完成 ({num_samples} samples in {dt:.2f}s, "
          f"{num_samples / dt:.2f}/s)")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--out_dir", type=str, default="output")
    p.add_argument("--global_scale", type=float, default=1.3)
    p.add_argument("--dpi", type=int, default=200)
    p.add_argument("--modes", type=str, default="adjacent",
                   help="comma list: random,nested,adjacent,intersecting")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device to generate on (default: cuda)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ...device import resolve_device
    generate_all(resolve_device(args.device), args.n, args.out_dir,
                 args.global_scale, args.dpi, tuple(args.modes.split(",")),
                 args.batch_size, args.seed)


if __name__ == "__main__":
    main()
