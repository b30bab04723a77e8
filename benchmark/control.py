#!/usr/bin/env python3
# control.py — the check's control: the plain reference, put in the
# program's place, computed one step of precision below what the
# configuration states.
"""Usage, from the root of a checkout, on a card:

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

For each seed and each control of the cell's system it makes one run of
the cell (``run.main``, a window of one call by default) in which the
files the check samples are the control's: the check's own reference
computation is run once under the lower precision and its output written
over the program's files (PNGs, meta, coco and index entries, params),
then the check goes on unchanged and compares them with the reference as
stated.  The control has to come out as not correct.  The lower steps are
the ones a later change would be tempted by:

- ``tf32`` (RPM, float32 with TF32 off for its matrix products): TF32 on
  for every float32 matrix product (the grid composition's resampling,
  the pHash);
- ``bf16_raster`` (RPM, the rest of its float32; mg, float64 geometry and
  a float32 raster): the rasterizer's prepared float32 inputs rounded
  through bfloat16.

Each run is a process of its own (the program cannot build a second
generator in one process, see PERF.md).  It prints one line a run, with
the run's ``correct`` and checks, and exits non-zero when a control came
out as correct or gave no result.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import struct
import subprocess
import sys
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from benchlib import common  # noqa: E402

# what a control run saw of its precision (TF32's effect on a product)
EVIDENCE: dict = {}


@contextlib.contextmanager
def tf32():
    import torch
    import plainref.device as pdev
    pdev.TF32 = True
    pdev.configure_numerics()
    try:
        yield
        if torch.cuda.is_available():
            # that TF32 was in force: a random float32 product moves
            a = torch.randn((256, 256), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(7))
            on = a @ a
            pdev.TF32 = False
            pdev.configure_numerics()
            EVIDENCE["tf32_product_maxdiff"] = float((on - a @ a).abs().max())
    finally:
        pdev.TF32 = False
        pdev.configure_numerics()


@contextlib.contextmanager
def bf16_raster(module: str):
    import torch
    mod = importlib.import_module(module)
    mod.ROUND_INPUTS = torch.bfloat16
    try:
        yield
    finally:
        mod.ROUND_INPUTS = None


CONTROLS = {
    "rpm": {"tf32": tf32,
            "bf16_raster": lambda: bf16_raster("plainref.ops.raster")},
    "mg": {"bf16_raster": lambda: bf16_raster(
        "plainref.models.multigraph.renderer")},
}


def write_png(path: str, img) -> None:
    """An 8-bit RGB PNG of `img` (u8 ``[H, W, 3]``), with zlib alone."""
    import numpy as np
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_json(path: str, data) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=2)


def write_rpm(out_dir: str, args, low: dict) -> None:
    """The control's files of each sampled id the program exported (a
    duplicate or a failed id keeps the program's entry)."""
    for call in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, call, "index.json")
        if not call.startswith("call_") or not os.path.isfile(path):
            continue
        entries = common.load_json(path)
        for k, m in enumerate(entries):
            r = low.get(m.get("id", m.get("index")))
            if r is None or m.get("duplicate") or m.get("error"):
                continue
            sid = m.get("id", m.get("index"))
            sample_dir = os.path.join(out_dir, "samples",
                                      f"sample_{sid:06d}")
            write_png(os.path.join(out_dir, "grids", f"grid_{sid:06d}.png"),
                      r["grid"])
            for name, img in r["frames"].items():
                write_png(os.path.join(sample_dir, name), img)
            os.makedirs(sample_dir, exist_ok=True)
            write_json(os.path.join(sample_dir, "meta.json"), r["meta"])
            write_json(os.path.join(sample_dir, "coco.json"), r["coco"])
            entries[k] = r["meta"]
        write_json(path, entries)


def write_mg(out_dir: str, args, low: list) -> None:
    from benchlib import mg
    picked = args[0]
    for (i, _sd, mode), (img, rec) in zip(picked, low):
        png, params = mg.paths(out_dir, i, mode)
        write_png(png, img)
        write_json(params, rec)


WRITE = {"rpm": write_rpm, "mg": write_mg}


@contextlib.contextmanager
def planted(system: str, control: str):
    """The cell's runner with the control in the program's place: the
    check's reference, once under `control`, written over the program's
    files, then once as stated for the comparison."""
    runner = importlib.import_module(f"benchlib.{system}")
    real_check, real_ref = runner.check, runner.reference
    where = {}

    def check(cell, seed, done, out_dir, *rest):
        where["out_dir"] = out_dir
        return real_check(cell, seed, done, out_dir, *rest)

    def reference(cell, *args):
        with CONTROLS[system][control]():
            low = real_ref(cell, *args)
        WRITE[system](where["out_dir"], args, low)
        return real_ref(cell, *args)

    runner.check, runner.reference = check, reference
    try:
        yield
    finally:
        runner.check, runner.reference = real_check, real_ref


def run_control(workload: str, seed: int, control: str, seconds: float = 1,
                **main_kwargs) -> dict:
    """One run of the cell with `control` planted -> run.main's result."""
    import run
    base = main_kwargs.get("base", common.HERE)
    system = common.load_cell(workload, base)["config_data"]["system"]
    EVIDENCE.clear()
    with planted(system, control):
        return run.main(["--workload", workload, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", "0"],
                        **main_kwargs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1)
    p.add_argument("--controls", nargs="*")
    p.add_argument("--one", action="store_true",
                   help="run the one seed and control given here")
    args = p.parse_args(argv)
    if args.one:
        out = run_control(args.workload, args.seeds[0], args.controls[0],
                          args.seconds)
        print(json.dumps({"workload": args.workload,
                          "control": args.controls[0],
                          "seed": args.seeds[0], "correct": out["correct"],
                          "checks": out["checks"], **EVIDENCE}), flush=True)
        return 0
    system = common.load_cell(args.workload)["config_data"]["system"]
    bad = 0
    for seed in args.seeds:
        for control in args.controls or sorted(CONTROLS[system]):
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one",
                 "--workload", args.workload, "--seeds", str(seed),
                 "--controls", control, "--seconds", str(args.seconds)],
                stdout=subprocess.PIPE, text=True)
            lines = [json.loads(l) for l in p.stdout.splitlines()
                     if l.startswith('{"workload"')]
            if p.returncode or not lines:
                bad += 1
                common.log(f"{control} seed {seed}: no result "
                           f"(exit {p.returncode})")
                continue
            bad += bool(lines[-1]["correct"])
            print(json.dumps(lines[-1]), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except common.BenchError as e:
        common.log(f"no result: {e}")
        sys.exit(2)
