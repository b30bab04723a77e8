#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. card: CUDA must be available; prints the card's name and power limit;
  2. build: compiles the frame rasterizer (csrc/raster.cu) with nvcc;
  3. kernel: the rasterizer against its plain PyTorch version on the card,
     byte for byte, on every element set below, with both timed;
  4. main path: the port's CLI for 64 samples at 512x512, once with full
     export and once with --grid_only --dedup; checks index.json, decodes
     every PNG and requires that the CLI runs launched the kernel;
  5. card against CPU: 2 ids of each of the 9 rule leaves through the
     pipeline on the card and on the CPU; every output must be equal.
Prints the kernel table as one JSON line, then the contract line
{"ok": true, "device": {...}} last.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from reasoning_image_generation_tpu_torch import cli
    from reasoning_image_generation_tpu_torch.device import resolve_device
    from reasoning_image_generation_tpu_torch.io.png_read import read_png
    from reasoning_image_generation_tpu_torch.models.rpm.pipeline import (
        LeafPipeline, make_sample_fn, sample_keys)
    from reasoning_image_generation_tpu_torch.ops import raster, raster_cuda
    from reasoning_image_generation_tpu_torch.utils.config import (
        RULE_LEAVES, SHAPE_KINDS, GenConfig)
    from reasoning_image_generation_tpu_torch.utils.state import (
        ElementState, dicts_to_state, stack)

    # ---- 1. card ----
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed ({smi.returncode})"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    raster_cuda.build()
    log(f"build: {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernel against its plain version ----
    W = H = 512

    def elem(kind, size=140, center=(256, 256), angle=45.0,
             color=(40, 80, 200)):
        return {"kind": kind, "size": size, "fill": True, "stroke_width": 2,
                "center": center, "angle": angle,
                "bbox": (0, 0, size, size), "flip": {"h": False, "v": False},
                "color": color}

    cases = []
    kinds = stack([dicts_to_state(
        [elem(k), elem("circle", 80, (420, 100), color=(200, 30, 30))], 8)
        for k in SHAPE_KINDS])
    cases.append(("11 kinds", kinds, 512, 512))
    cfg = GenConfig()
    for leaf, B in (("平移", 32), ("直接叠加", 32)):
        fr = make_sample_fn(leaf, cfg)(sample_keys(7, list(range(B)), dev),
                                       torch.arange(B, device=dev) % 2 == 1)
        flat = fr["rframes"].map(lambda a: a.flatten(0, 1))
        cases.append((f"sampled {leaf} frames", flat, 512, 512))
    wrap = [elem("hexagon", 40, (60, 32), angle=30.0),
            elem("circle", 30, (140, 30), color=(200, 30, 30)),
            elem("plus", 40, (200, 32 + 2 * 64), angle=0.0),  # 2 canvases off
            elem("star", 36, (250, 40), color=(30, 160, 60))]
    cases.append(("wrap gate 256x64", stack([dicts_to_state(wrap, 8)]),
                  256, 64))
    tiles = [elem("hexagon", 90, (580, 100), angle=30.0),
             elem("heart", 70, (40, 190), color=(30, 160, 60)),
             elem("star", 80, (510, 60), color=(200, 30, 30)),
             elem("circle", 60, (300, 64))]
    cases.append(("600x200", stack([dicts_to_state(tiles, 8)]), 600, 200))
    untiled = [elem("hexagon", 90, (380, 100), angle=30.0),
               elem("heart", 70, (40, 180), color=(30, 160, 60))]
    cases.append(("400x200", stack([dicts_to_state(untiled, 8)]), 400, 200))

    max_err = 0
    for name, st, cw, ch in cases:
        st = st.map(lambda a: a.to(dev))
        n = st.kind.shape[0]
        for grid in (False, True):
            ug = torch.full((n,), grid, device=dev)
            got = raster_cuda.render_frames(st, cw, ch, ug)
            ref = raster.render_frames(st, cw, ch, ug)
            torch.cuda.synchronize()
            if got.shape != (n, ch, cw, 3) or ref.shape != got.shape:
                fail(f"kernel shape {tuple(got.shape)} on {name}")
            err = int((got.int() - ref.int()).abs().max())
            max_err = max(max_err, err)
            log(f"kernel vs plain: {name} ({n} frames {cw}x{ch}, "
                f"grid={grid}): maxdiff {err}")
    if max_err != 0:
        fail(f"kernel disagrees with its plain version (maxdiff {max_err})")

    # timing at the main path's shape: 256 frames of 512x512
    flat = cases[1][1].map(lambda a: a.to(dev))
    ug = torch.arange(flat.kind.shape[0], device=dev) % 2 == 1
    meta, vx, vy = raster.prepare_render_data(flat, W, H, ug)

    def timed(fn, reps):
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

    plain_ms = timed(lambda: raster.render_prepared(meta, vx, vy, ug, W, H, 3),
                     3)
    kern_ms = timed(lambda: raster_cuda.render_prepared_cuda(
        meta, vx, vy, ug, W, H), 20)
    plain_ms2 = timed(lambda: raster.render_prepared(meta, vx, vy, ug, W, H, 3),
                      3)
    kern_ms2 = timed(lambda: raster_cuda.render_prepared_cuda(
        meta, vx, vy, ug, W, H), 20)
    log(f"K1 time per {meta.shape[0]} frames of {W}x{H}: kernel "
        f"{kern_ms:.3f} / {kern_ms2:.3f} ms, plain {plain_ms:.3f} / "
        f"{plain_ms2:.3f} ms (plain, kernel, kernel, plain order: "
        f"{plain_ms:.3f}, {kern_ms:.3f}, {kern_ms2:.3f}, {plain_ms2:.3f})")

    # ---- 4. main path through the CLI ----
    raster_cuda.LAUNCHES = 0
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, extra in (("full", []), ("grid_only_dedup",
                                          ["--grid_only", "--dedup"])):
            out = os.path.join(tmp, tag)
            t0 = time.perf_counter()
            cli.main(["--device", "cuda", "--n", "64", "--batch_size", "32",
                      "--seed", "0", "--out_dir", out, *extra])
            wall = time.perf_counter() - t0
            runs[tag] = (out, wall)
        launches = raster_cuda.LAUNCHES
        for tag, (out, wall) in runs.items():
            with open(os.path.join(out, "index.json"), encoding="utf-8") as f:
                index = json.load(f)
            if len(index) != 64:
                fail(f"{tag}: index.json has {len(index)} entries, want 64")
            errs = [m for m in index if m.get("error")]
            if errs:
                fail(f"{tag}: {len(errs)} error records, first: "
                     f"{errs[0].get('error_message')}")
            kept = [m for m in index if not m.get("duplicate")]
            n_png = 0
            for m in kept:
                g = read_png(m["grid_path"])
                if g.ndim != 3 or g.shape[1] != W or g.shape[2] != 3:
                    fail(f"{tag}: grid {m['grid_path']} has shape {g.shape}")
                n_png += 1
                if tag == "full":
                    for s in m["sequence"]:
                        if read_png(s["state_path"]).shape != (H, W, 3):
                            fail(f"{tag}: bad frame {s['state_path']}")
                        n_png += 1
                    for o in m["options"]:
                        if read_png(o["option_path"]).shape != (H, W, 3):
                            fail(f"{tag}: bad frame {o['option_path']}")
                        n_png += 1
            log(f"main path {tag}: 64 samples ({len(kept)} kept, "
                f"{64 - len(kept)} duplicates), {n_png} PNGs decoded, "
                f"wall {wall:.3f} s, {64 / wall:.3f} samples/s")
    log(f"raster_cuda.LAUNCHES after the CLI runs: {launches}")
    if launches <= 0:
        fail("the main path never launched the rasterizer kernel")

    # ---- 5. card against CPU ----
    cpu = resolve_device("cpu")
    for leaf in RULE_LEAVES:
        ids = [3, 11]
        ug = [False, True]
        outs = []
        for d in (dev, cpu):
            pipe = LeafPipeline(leaf, GenConfig(batch_size=2))
            outs.append(pipe(sample_keys(0, ids, d),
                             torch.tensor(ug, device=d)))
        g, c = outs
        diffs = []
        for k in ("states", "options"):
            for f in ElementState._fields:
                if not torch.equal(getattr(g[k], f).cpu(), getattr(c[k], f)):
                    diffs.append(f"{k}.{f}")
        for k in ("perm", "correct_index", "grid_img", "grid_phash",
                  "state_imgs", "option_imgs"):
            if not torch.equal(g[k].cpu(), c[k]):
                n_bad = int((g[k].cpu() != c[k]).sum())
                diffs.append(f"{k} ({n_bad} values)")
        for f, a, b in zip(g["params"]._fields, g["params"], c["params"]):
            if not torch.equal(a.cpu(), b):
                diffs.append(f"params.{f}")
        log(f"card vs cpu {leaf}: " + ("equal" if not diffs else
                                        "DIFF " + ", ".join(diffs)))
        if diffs:
            fail(f"card and CPU disagree on {leaf}: {diffs}")

    log(json.dumps({"kernels": [{
        "name": "rpm_frame_rasterizer",
        "route": "cuda",
        "source": "reasoning_image_generation_tpu_torch/csrc/raster.cu",
        "replaces": "reasoning_image_generation_tpu/ops/raster_pallas.py:291",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
