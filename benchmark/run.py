#!/usr/bin/env python3
# run.py — one run of one cell of the benchmark of
# reasoning_image_generation_tpu_torch on NVIDIA cards.
"""Usage, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads ``benchmark/workloads/<cell>.json`` and its configuration, refuses to
run without as many CUDA cards as the cell asks for, builds the generator
and captures what the window replays (set-up), measures for ``--seconds``,
checks what the window wrote against the frozen plain reference
(``benchmark/plainref``), and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics) and ``device``.  Each number compared is printed beside
its limit as the last lines of standard error and under ``checks``, the
result's last key.  It exits non-zero, printing no result, when it finds
no card, when JAX or the JAX package got loaded, or when the JAX package's
benchmark files were opened.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(HERE), HERE):   # the program, then the harness
    if _p not in sys.path:
        sys.path.insert(0, _p)

from benchlib import common  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device_name: str = "cuda", base: str = common.HERE,
         manifest_root: str = common.ROOT) -> dict:
    """One run -> the result line's object (also printed).  `device_name`
    'cpu' and the other keywords are for the benchmark's own tests, which
    drive a tiny cell on the host; the command line always measures the
    card."""
    args = parse_args(argv)
    guard = common.OpenGuard()
    cell = common.load_cell(args.workload, base)
    chips = int(cell.get("chips", 1))
    run_dir = common.pin_environment()
    import importlib
    import torch
    if device_name == "cuda":
        common.check_card(chips)
        common.log(f"card: {common.card_line()}; torch {torch.__version__}, "
                   f"CUDA {torch.version.cuda}")
    from reasoning_image_generation_tpu_torch.device import resolve_device
    device = resolve_device(device_name)
    runner = importlib.import_module(f"benchlib.{cell['config_data']['system']}")
    io0 = common.io_written()
    try:
        res = runner.run(cell, args, device, run_dir, bool(args.trace),
                         T_START)
        out_bytes = common.tree_bytes(res["out_dir"])
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    io1 = common.io_written()
    common.log(f"written: outputs {out_bytes} bytes; process write_bytes "
               f"{io1.get('write_bytes', 0) - io0.get('write_bytes', 0)}, "
               f"wchar {io1.get('wchar', 0) - io0.get('wchar', 0)}")
    ctx = res["ctx"]
    name, value, unit = res["rate"]
    common.log(f"rate: {name} {value!r} {unit}")
    common.log("spans: " + json.dumps(
        {k: ctx[k] for k in ("window_s", "calls", "samples", "warmup_s",
                             "warm_calls", "call_s", "check_s")
         if k in ctx}))

    loaded = common.forbidden_loaded()
    if loaded:
        raise common.BenchError(f"JAX or the JAX package was loaded: "
                                f"{loaded[:8]}")
    if guard.seen:
        raise common.BenchError(f"the JAX package's benchmark files were "
                                f"opened: {guard.seen[:4]}")

    man = common.manifest(manifest_root)
    if args.trace:
        metrics = {}
        for m in common.cell_metrics(man, cell["name"], "per_layer"):
            v = common.load_reader(m["name"], base)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        known = {"setup_s": (res["setup_s"], "s"),
                 "peak_device_gib": (res["peak"] / 2 ** 30, "GiB")}
        metrics = {m["name"]: {"value": known[m["name"]][0],
                               "unit": m["unit"]}
                   for m in common.cell_metrics(man, cell["name"],
                                                "end_to_end")
                   if m["name"] in known}
    checks = res["checks"]
    correct = all(v <= lim for _n, v, lim in checks)
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": chips, "memory_peak_bytes": int(res["peak"])}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device_info}
    tr = ctx.get("trace")
    if args.trace and tr is not None:
        from benchlib import trace
        device_info["busy_s"] = trace.busy_s(tr)
        device_info["window_s"] = trace.window_s(tr)
        out["breakdown"] = trace.breakdown(tr)
        common.log(f"trace: {trace.kernels(tr)} kernels kept, launches "
                   f"{tr['launched']}, kept {tr['kept']}, reduced in "
                   f"{tr['reduce_s']:.3f} s")
        if tr["dropped"]:
            common.log(f"trace dropped records: kept/launched "
                       f"{tr['dropped']}")
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        common.log(f"check {n}: {v} (limit {lim})")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    try:
        main()
    except common.BenchError as e:
        common.log(f"no result: {e}")
        sys.exit(2)
