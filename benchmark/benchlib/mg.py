# mg.py — the multigraph scene generator under a cell's traffic.
"""Set-up builds one ``GeometryGenerator`` as the mg CLI does and runs warm
calls of the cell's size, on scenes the window never draws, until one
captures no graph (at most ``WARM_CALLS``): the first captures the render,
pack and blob graphs, the next let the transfer tiers grow from a fresh
run-statistics directory to where a process that ran before starts
(``utils/cache.py`` persists them for that).  A later new maximum still
recaptures the pack or the blob inside the window
(``mg.captures_in_window``).  One scene through ``generate`` then waits
for the warm calls' files.  The window calls ``generate_batches`` back to back on consecutive
ranges of ``scenes_per_call`` scenes (scene i has the seed ``--seed`` + i;
each call holds the four modes in equal numbers, in an order drawn from
the seed, where the CLI draws each scene's mode alone), and ends
with ``close``, which waits for the last files: the rate is every scene of
those calls over their whole wall time.

The check, once the window has closed and the generator is gone,
rebuilds two scenes of each mode the window drew, chosen from the seed,
with the frozen plain reference (``plainref``: scene build on the host,
prep and the plain renderer on the card, QC and features on the host),
and compares the PNG's pixels and the params JSON.
"""
from __future__ import annotations

import gc
import os
import random
import time

from . import common, compare

# fields of a record that differ from run to run by design
VOLATILE = ("generation_id", "timestamp")

# warm calls at most: set-up stops once a call captures no graph
WARM_CALLS = 4


def plan(seed: int, n: int, modes, per_call: int) -> list:
    """(index, scene seed, mode) of the run's first n scenes.  Each call
    of `per_call` scenes holds every mode in equal numbers (the remainder
    to the first modes), in an order drawn from the seed: every seed's
    call has the same mix, the seed changes the scenes and their order."""
    out = []
    for k in range(-(-n // per_call)):
        mix = [modes[j % len(modes)] for j in range(per_call)]
        random.Random(seed * 1000003 + k).shuffle(mix)
        out += [(k * per_call + j, seed + k * per_call + j, m)
                for j, m in enumerate(mix)]
    return out[:n]


def paths(out_dir: str, i: int, mode: str):
    return (os.path.join(out_dir, "images", f"{i}_{mode}.png"),
            os.path.join(out_dir, "params", f"{i}_{mode}.json"))


def run(cell: dict, args, device, run_dir: str, tracing: bool,
        t_start: float) -> dict:
    import torch
    from reasoning_image_generation_tpu_torch.models.multigraph import (
        renderer_cuda)
    from reasoning_image_generation_tpu_torch.models.multigraph.generator \
        import GeometryGenerator
    from reasoning_image_generation_tpu_torch.utils import graphs
    from . import roofline, trace

    s = cell["config_data"]["settings"]
    per_call = int(cell["traffic"]["scenes_per_call"])
    modes = cell["traffic"]["modes"]
    B, dpi = int(s["batch_size"]), int(s["dpi"])
    out_dir = os.path.join(run_dir, "out")
    seed = args.seed
    # the warm call's scenes come after every scene a window can reach
    warm_seed = seed + 10 ** 7
    gen = GeometryGenerator(device, global_scale=float(s["global_scale"]),
                            io_workers=8,
                            transfer_codec=s["transfer_codec"])

    def call(items, base_dir):
        ps = [paths(base_dir, i, m) for i, _s, m in items]
        gen.generate_batches([sd for _i, sd, _m in items],
                             [m for _i, _s, m in items],
                             [p[0] for p in ps], [p[1] for p in ps],
                             dpi=dpi, batch_size=B)

    t = time.perf_counter()
    warm = 0
    while warm < WARM_CALLS * per_call:
        c0 = graphs.CAPTURES
        call(plan(warm_seed, warm + per_call, modes, per_call)[warm:],
             os.path.join(out_dir, "warm"))
        warm += per_call
        if graphs.CAPTURES == c0:
            break
    gen.generate(modes[0], None, None, dpi=dpi, seed=warm_seed + warm)
    if device.type == "cuda":
        torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    before = {"transfer": gen.transfer_bytes, "captures": graphs.CAPTURES}
    done, stretch, call_s = [], None, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        items = plan(seed, len(done) + per_call, modes,
                     per_call)[len(done):]
        tc = time.perf_counter()
        if tracing and stretch is None:
            stretch = trace.Stretch({"mg_render_kernel": renderer_cuda})
            with stretch:
                call(items, out_dir)
        else:
            call(items, out_dir)
        call_s.append(round(time.perf_counter() - tc, 3))
        done += items
    transfer = gen.transfer_bytes - before["transfer"]
    gen.close()                      # waits for the last files
    wall = time.perf_counter() - t0
    ctx = {"system": "mg", "samples": len(done), "window_s": wall,
           "calls": len(done) // per_call, "transfer_bytes": transfer,
           "captures": graphs.CAPTURES - before["captures"],
           "warmup_s": warmup_s, "warm_calls": warm // per_call,
           "call_s": call_s, "call_n": [per_call] * len(call_s),
           "trace": None}
    if stretch is not None:             # the window's first call
        S = s["canvas_px"]
        sizes = [min(B, per_call - lo) for lo in range(0, per_call, B)]
        ctx["trace"] = stretch.reduce()
        ctx["trace"]["k2_bytes"] = sum(roofline.k2_bytes(n, S, S)
                                       for n in sizes)
    peak = (torch.cuda.max_memory_reserved(device)
            if device.type == "cuda" else 0)
    del gen
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks, failed = check(cell, seed, done, out_dir, device)
    ctx["check_s"] = time.perf_counter() - t
    return {"rate": ("mg_scenes_per_s", len(done) / wall, "scenes/s"),
            "setup_s": setup_s, "peak": peak, "ctx": ctx, "checks": checks,
            "attempted": len(done), "failed": failed, "out_dir": out_dir}


def check(cell: dict, seed: int, done, out_dir: str, device):
    """-> ([(name, reading, limit)], failed)."""
    limits = cell["limits"]
    missing = sum(1 for i, _s, m in done
                  if not all(os.path.isfile(p) and os.path.getsize(p) > 0
                             for p in paths(out_dir, i, m)))
    rng = random.Random(seed * 7919 + 29)
    picked = []
    for mode in sorted({m for _i, _s, m in done}):
        of_mode = [d for d in done if d[2] == mode]
        picked += rng.sample(of_mode, min(2, len(of_mode)))
    ref = reference(cell, picked, device)
    px = json_bad = 0
    for (i, _sd, mode), (img, rec) in zip(picked, ref):
        png, params = paths(out_dir, i, mode)
        px += compare.png_diff(png, img)
        try:
            got = common.load_json(params)
        except (OSError, ValueError):
            json_bad += 1
            continue
        json_bad += compare.json_diff(got, rec, VOLATILE)
    checks = [("missing", missing, limits["missing"]),
              ("px_mismatch", px, limits["px_mismatch"]),
              ("json_mismatch", json_bad, limits["json_mismatch"])]
    return checks, missing


def reference(cell: dict, picked, device) -> list:
    """The frozen plain path over the picked scenes -> [(pixels, record)]."""
    import json
    import torch
    from plainref.models.multigraph.check import (check_scene_inside,
                                                  compute_scene_features)
    from plainref.models.multigraph.record import _jsonable, _shape_params_dict
    from plainref.models.multigraph.renderer import render_scene_batch
    from plainref.models.multigraph.scene import BOUNDS, build_scene_batch
    s = cell["config_data"]["settings"]
    gs, dpi = float(s["global_scale"]), int(s["dpi"])
    out = []
    for lo in range(0, len(picked), 4):          # four scenes at a time
        chunk = picked[lo:lo + 4]
        batch, metas = build_scene_batch([sd for _i, sd, _m in chunk],
                                         [m for _i, _s, m in chunk], gs)
        with torch.no_grad():
            imgs = render_scene_batch(batch, dpi, device).cpu().numpy()
        for j, (_i, sd, mode) in enumerate(chunk):
            scene = {k: v[j] for k, v in batch.items()}
            rec = {"seed": int(sd), "mode": mode,
                   "shape_count": metas[j]["shape_count"],
                   "bounds": list(BOUNDS), "global_scale": gs,
                   "shapes": [_shape_params_dict(m)
                              for m in metas[j]["shapes"]],
                   "qc": check_scene_inside(scene, BOUNDS, dpi=dpi)}
            if rec["shape_count"] > 1:
                rec["geos_features"] = _jsonable(
                    compute_scene_features(scene))
            out.append((imgs[j], json.loads(json.dumps(rec))))
    return out
