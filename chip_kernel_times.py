#!/usr/bin/env python3
"""Time the two CUDA rasterizers alone on one NVIDIA card, once per build.

    python3 chip_kernel_times.py ["<extra nvcc flags>" ...]

Each argument is one build: its flags (possibly none, as "") are added to
ops/cuda_build.NVCC_FLAGS, both kernels are rebuilt and timed at the main
paths' shapes (K1: 256 sampled frames of 512x512, half with grid lines; K2:
16 generated scenes of 1600x1600).  With no argument it times the sources
as they are.  It is for comparing variants of a kernel inside one call, on
one card: -D macros of a source under change, -maxrregcount, and the like.
Per build it prints `ms` (CUDA events round 50 calls of the wrapper),
`device_ms` (the kernel's own time under torch.profiler) and whether the
output equals the first build's.  chip_smoke.py is the check that a kernel
is right; this script only times.
"""
import subprocess
import sys

import torch

import chip_smoke
from reasoning_image_generation_tpu_torch.models.multigraph import (
    renderer, renderer_cuda)
from reasoning_image_generation_tpu_torch.models.rpm.pipeline import (
    make_sample_fn, sample_keys)
from reasoning_image_generation_tpu_torch.ops import (
    cuda_build, raster, raster_cuda)
from reasoning_image_generation_tpu_torch.utils.config import GenConfig

ACTS = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]


def event_ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, kernel, reps=20):
    with torch.profiler.profile(activities=ACTS) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key:
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
            n += e.count
    return us / 1e3 / max(n, 1)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_kernel_times.py needs a card")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    fr = make_sample_fn("平移", GenConfig())(
        sample_keys(7, list(range(32)), dev),
        torch.arange(32, device=dev) % 2 == 1)
    flat = fr["rframes"].map(lambda a: a.flatten(0, 1))
    ug = torch.arange(256, device=dev) % 2 == 1
    meta, vx, vy = raster.prepare_render_data(flat, 512, 512, ug)
    args = renderer.prepare_scene_batch(renderer.scene_batch_to_torch(
        chip_smoke.mg_generated_batch(16), dev), 200)
    k1 = lambda: raster_cuda.render_prepared_cuda(meta, vx, vy, ug, 512, 512)
    k2 = lambda: renderer_cuda.render_prepared_cuda(*args, 1600, 1600)
    base = list(cuda_build.NVCC_FLAGS)
    first = None
    for flags in [a.split() for a in sys.argv[1:]] or [[]]:
        cuda_build.NVCC_FLAGS[:] = base + flags
        cuda_build._built.clear()            # rebuild with these flags
        outs = (k1(), k2())
        torch.cuda.synchronize()
        first = first or outs
        print(f"{flags}: K1 ms {event_ms(k1):.4f} device_ms "
              f"{device_ms(k1, 'raster_kernel'):.4f} | K2 ms "
              f"{event_ms(k2):.4f} device_ms "
              f"{device_ms(k2, 'mg_render_kernel'):.4f} | equal to the "
              f"first build: {torch.equal(outs[0], first[0])} "
              f"{torch.equal(outs[1], first[1])}", flush=True)


if __name__ == "__main__":
    main()
