# rpm.py — the RPM sequence-puzzle generator under a cell's traffic.
"""Set-up builds one ``RPMGenerator`` as ``cli.main`` does (8 export
threads) and runs one warm call over one id of every rule leaf: that
captures every graph the window replays (the leaf steps, the keys, the
dedup step, the blobs).  The window calls ``generate_ids`` back
to back on disjoint sets of ``ids_per_call`` ids, and writes each call's
index with the CLI's ``write_index``; a call starts only while the window
has time left.  A call takes the next ids of each rule leaf up to the
leaf's share of the call (``call_ids``): every call of every seed holds
the same leaves in the same numbers, so the seed changes which puzzles
are made and in what order, not how much work a call is.  The rate is every id of those calls
over their whole wall time.

The check, once the window has closed and the generator is gone,
recomputes a sample of the window's ids, drawn from the seed (two of each
rule leaf that the window reached, and the duplicates' hashes), with the
frozen plain reference (``plainref``) on the card, and compares what the
window wrote: the PNGs' pixels, ``meta.json``, ``coco.json`` and the
index entry, and the grid pHash; and it replays the dedup's keep
decisions of every id against the index's hashes.
"""
from __future__ import annotations

import gc
import json
import os
import random
import time
from collections import defaultdict

import numpy as np

from . import common, compare

# fields of a meta that differ from run to run by design
VOLATILE = ("generation_time", "timestamp")


def leaves_of(cfg_data: dict):
    from plainref.utils.config import GenConfig, category_leaves
    cfg = GenConfig(**{k: v for k, v in cfg_data["settings"].items()
                       if k in GenConfig.__dataclass_fields__})
    leaves = category_leaves(cfg.categories)
    weights = [cfg.category_weights.get(l[-1], 1.0) for l in leaves]
    return leaves, weights


def assign(seed: int, ids, leaves, weights):
    """Each id's (leaf path, use_grid), drawn as the generator draws them,
    grouped by leaf in the order the generator submits them."""
    groups = defaultdict(list)
    for sid in ids:
        rng = random.Random(seed + sid)
        path = rng.choices(leaves, weights=weights, k=1)[0]
        use_grid = rng.choice([False, True])
        groups[path[-1]].append((sid, path, use_grid))
    return groups


def seq_len(leaf: str) -> int:
    from plainref.models.rpm.pipeline import seq_len_for
    return seq_len_for(leaf)


def quotas(n: int, weights) -> list:
    """Ids of each leaf in a call of n ids: shares of the weights, the
    remainder to the first leaves in the taxonomy's order."""
    total = sum(weights)
    q = [int(n * w // total) for w in weights]
    for i in range(n - sum(q)):
        q[i % len(q)] += 1
    return q


def call_ids(seed: int, start: int, n: int, leaves, weights):
    """The next call's ids from `start` on: the first ids of each leaf
    until its quota is full (ids past a full quota are left out), so that
    every call of every seed has the same leaves in the same numbers, in
    another order -> (ids, the next call's start)."""
    want = dict(zip((l[-1] for l in leaves), quotas(n, weights)))
    ids, sid = [], start
    while len(ids) < n:
        leaf = random.Random(seed + sid).choices(
            leaves, weights=weights, k=1)[0][-1]
        if want[leaf]:
            want[leaf] -= 1
            ids.append(sid)
        sid += 1
    return ids, sid


def k1_launch_bytes(cell: dict, seed: int, ids) -> list:
    """The bytes of each K1 launch a call over `ids` makes: one a padded
    batch, of batch × (states + options) frames."""
    from . import roofline
    s = cell["config_data"]["settings"]
    W, H = s["canvas_size"]
    B = s["batch_size"]
    leaves, weights = leaves_of(cell["config_data"])
    out = []
    for leaf, entries in assign(seed, ids, leaves, weights).items():
        frames = B * (seq_len(leaf) + s["num_options"])
        nb = -(-len(entries) // B)
        out += [roofline.k1_bytes(frames, s["max_elems"], W, H)] * nb
    return out


def gen_config(cell: dict, seed: int, out_dir: str):
    from reasoning_image_generation_tpu_torch.utils.config import GenConfig
    s = dict(cell["config_data"]["settings"])
    s["canvas_size"] = tuple(s["canvas_size"])
    s["grid_only"] = bool(cell["traffic"]["grid_only"])
    keep = {k: v for k, v in s.items() if k in GenConfig.__dataclass_fields__}
    return GenConfig(out_dir=out_dir, seed=seed, **keep)


def warm_ids(cell: dict, seed: int) -> list:
    """One id of every rule leaf, the first of each, in the taxonomy's
    order: the generator captures the leaves in the order their ids come,
    and the shared pool's size depends on that order, so every seed
    captures in the same one."""
    leaves, weights = leaves_of(cell["config_data"])
    first = {}
    sid = 0
    while len(first) < len(leaves):
        leaf = random.Random(seed + sid).choices(
            leaves, weights=weights, k=1)[0][-1]
        first.setdefault(leaf, sid)
        sid += 1
    return [first[l[-1]] for l in leaves]


def run(cell: dict, args, device, run_dir: str, tracing: bool,
        t_start: float) -> dict:
    import torch
    from reasoning_image_generation_tpu_torch.cli import write_index
    from reasoning_image_generation_tpu_torch.models.rpm.generator import (
        RPMGenerator)
    from reasoning_image_generation_tpu_torch.ops import raster_cuda
    from reasoning_image_generation_tpu_torch.utils import graphs
    from . import trace

    traffic = cell["traffic"]
    dedup = bool(traffic["dedup"])
    thr = int(traffic.get("dedup_threshold", 4))
    per_call = int(traffic["ids_per_call"])
    out_dir = os.path.join(run_dir, "out")
    seed = args.seed
    gen = RPMGenerator(gen_config(cell, seed, out_dir), device,
                       io_workers=8, use_threads=True)
    t = time.perf_counter()
    warm = warm_ids(cell, seed)
    metas = gen.generate_ids(warm, dedup=dedup, dedup_threshold=thr)
    write_index(os.path.join(out_dir, "warm"), metas)
    if device.type == "cuda":
        torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    calls, call_s = [], []
    before = {"transfer": gen.transfer_bytes, "captures": graphs.CAPTURES}
    stretch = None
    leaves, weights = leaves_of(cell["config_data"])
    nxt = max(warm) + 1
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        ids, nxt = call_ids(seed, nxt, per_call, leaves, weights)
        tc = time.perf_counter()
        if tracing and stretch is None:
            stretch = trace.Stretch({"raster_kernel": raster_cuda})
            with stretch:
                metas = gen.generate_ids(ids, dedup=dedup,
                                         dedup_threshold=thr)
        else:
            metas = gen.generate_ids(ids, dedup=dedup, dedup_threshold=thr)
        call_dir = os.path.join(out_dir, f"call_{len(calls):03d}")
        write_index(call_dir, metas)
        calls.append((ids, call_dir))
        call_s.append(round(time.perf_counter() - tc, 3))
    wall = time.perf_counter() - t0
    samples = sum(len(c[0]) for c in calls)
    ctx = {"system": "rpm", "samples": samples, "window_s": wall,
           "calls": len(calls),
           "transfer_bytes": gen.transfer_bytes - before["transfer"],
           "captures": graphs.CAPTURES - before["captures"],
           "warmup_s": warmup_s, "call_s": call_s,
           "call_n": [len(ids) for ids, _ in calls], "trace": None}
    if stretch is not None:             # the window's first call
        ctx["trace"] = stretch.reduce()
        ctx["trace"]["k1_bytes"] = sum(k1_launch_bytes(cell, seed,
                                                       calls[0][0]))
    peak = (torch.cuda.max_memory_reserved(device)
            if device.type == "cuda" else 0)
    gen.close()
    del gen
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks, attempted, failed = check(cell, seed, calls, out_dir, device,
                                      dedup, thr)
    ctx["check_s"] = time.perf_counter() - t
    return {"rate": ("rpm_samples_per_s", samples / wall, "samples/s"),
            "setup_s": setup_s, "peak": peak, "ctx": ctx, "checks": checks,
            "attempted": attempted, "failed": failed, "out_dir": out_dir}


def sample_ids(seed: int, calls, groups_by_call, n_per_leaf: int = 2):
    """Two ids of each leaf the window reached, drawn from the seed."""
    rng = random.Random(seed * 7919 + 17)
    by_leaf = defaultdict(list)
    for groups in groups_by_call:
        for leaf, entries in groups.items():
            by_leaf[leaf] += entries
    picked = []
    for leaf in sorted(by_leaf):
        entries = by_leaf[leaf]
        picked += rng.sample(entries, min(n_per_leaf, len(entries)))
    return picked


def check(cell: dict, seed: int, calls, out_dir: str, device, dedup: bool,
          thr: int):
    """-> ([(name, reading, limit)], attempted, failed)."""
    limits = cell["limits"]
    leaves, weights = leaves_of(cell["config_data"])
    grid_only = bool(cell["traffic"]["grid_only"])
    groups_by_call = [assign(seed, ids, leaves, weights) for ids, _ in calls]
    picked = sample_ids(seed, calls, groups_by_call)
    ref = reference(cell, seed, picked, device, out_dir)
    index = {}
    for ids, call_dir in calls:
        with open(os.path.join(call_dir, "index.json"), encoding="utf-8") as f:
            for m in json.load(f):
                index[m.get("id", m.get("index"))] = m
    attempted = sum(len(ids) for ids, _ in calls)
    missing = 0
    for ids, _ in calls:
        for sid in ids:
            m = index.get(sid)
            if m is None or m.get("error"):
                missing += 1
            elif not m.get("duplicate") and not files_there(
                    out_dir, sid, grid_only):
                missing += 1
    # the keep decisions of every id against the index's hashes
    keep_bad = 0
    order_by_call = []
    if dedup:
        for groups in groups_by_call:
            order = [sid for entries in groups.values()
                     for sid, _p, _u in entries]
            order_by_call.append(order)
            keep_bad += compare.kept_violations(
                [index.get(sid) for sid in order], thr)
    px = json_bad = 0
    bits = 0
    for sid, path, use_grid in picked:
        m = index.get(sid)
        r = ref[sid]
        if m is None or m.get("error"):
            continue
        if m.get("duplicate"):
            # its hash lies within the threshold of an earlier kept one
            order = next(o for o in order_by_call if sid in o) \
                if dedup else []
            earlier = [index.get(o) for o in order[:order.index(sid)]] \
                if dedup else []
            keep_bad += compare.duplicate_violation(r["phash"], earlier, thr)
            json_bad += compare.json_diff(
                m, {"id": sid, "category_path": list(path), "rule": path[-1],
                    "duplicate": True}, ())
            continue
        bits = max(bits, compare.hamming_hex(m.get("grid_phash", ""),
                                             r["phash"]))
        px += compare.png_diff(os.path.join(out_dir, "grids",
                                            f"grid_{sid:06d}.png"), r["grid"])
        sample_dir = os.path.join(out_dir, "samples", f"sample_{sid:06d}")
        for name, img in r["frames"].items():
            px += compare.png_diff(os.path.join(sample_dir, name), img)
        for fname, want in (("meta.json", r["meta"]), ("coco.json", r["coco"])):
            try:
                got = common.load_json(os.path.join(sample_dir, fname))
            except (OSError, ValueError):
                json_bad += 1
                continue
            json_bad += compare.json_diff(got, want,
                                          VOLATILE + ("grid_phash",))
            if fname == "meta.json":
                bits = max(bits, compare.hamming_hex(
                    got.get("grid_phash", ""), r["phash"]))
        json_bad += compare.json_diff(m, r["meta"],
                                      VOLATILE + ("grid_phash",))
    checks = [("missing", missing, limits["missing"]),
              ("keep_violations", keep_bad, limits["keep_violations"]),
              ("px_mismatch", px, limits["px_mismatch"]),
              ("json_mismatch", json_bad, limits["json_mismatch"]),
              ("phash_bits", bits, limits["phash_bits"])]
    return checks, attempted, missing


def files_there(out_dir: str, sid: int, grid_only: bool) -> bool:
    sample_dir = os.path.join(out_dir, "samples", f"sample_{sid:06d}")
    need = [os.path.join(out_dir, "grids", f"grid_{sid:06d}.png"),
            os.path.join(sample_dir, "meta.json"),
            os.path.join(sample_dir, "coco.json")]
    if not grid_only:
        need.append(os.path.join(sample_dir, "query.png"))
    return all(os.path.isfile(p) for p in need)


def reference(cell: dict, seed: int, picked, device, out_dir: str) -> dict:
    """The frozen plain path over the picked ids, one leaf at a time ->
    {id: {grid, frames {file: pixels}, phash hex, meta, coco}}."""
    import torch
    from plainref.models.rpm.metadata import build_coco, build_sample_meta
    from plainref.models.rpm.pipeline import LeafPipeline, sample_keys
    from plainref.utils.config import GenConfig
    s = dict(cell["config_data"]["settings"])
    s["canvas_size"] = tuple(s["canvas_size"])
    s["grid_only"] = bool(cell["traffic"]["grid_only"])
    cfg = GenConfig(out_dir=out_dir, seed=seed, **{k: v for k, v in s.items()
                                  if k in GenConfig.__dataclass_fields__})
    by_leaf = defaultdict(list)
    for e in picked:
        by_leaf[e[1][-1]].append(e)
    res = {}
    O = cfg.num_options
    for leaf, entries in by_leaf.items():
        pipe = LeafPipeline(leaf, cfg)
        L = pipe.L
        with torch.no_grad():
            keys = sample_keys(seed, [e[0] for e in entries], device)
            ug = torch.tensor([e[2] for e in entries], dtype=torch.bool,
                              device=device)
            out = pipe.step(keys, ug)
        host = {k: (v.map(lambda a: a.cpu().numpy()) if hasattr(v, "map")
                    else type(v)(*(a.cpu().numpy() for a in v))
                    if isinstance(v, tuple)
                    else v.cpu().numpy()) for k, v in out.items()}
        for b, (sid, path, use_grid) in enumerate(entries):
            res[sid] = one_sample(cfg, pipe, host, b, sid, path, use_grid,
                                  seed, L, O, build_sample_meta, build_coco)
    return res


def one_sample(cfg, pipe, host, b, sid, path, use_grid, seed, L, O,
               build_sample_meta, build_coco) -> dict:
    """The files the generator writes for sample `b` of a leaf's batch, as
    the plain path makes them."""
    out_dir = cfg.out_dir
    leaf = path[-1]
    sample_dir = os.path.join(out_dir, "samples", f"sample_{sid:06d}")
    grid_path = os.path.join(out_dir, "grids", f"grid_{sid:06d}.png")
    perm = host["perm"][b]
    params = host["params"]
    meta = build_sample_meta(
        sid, leaf, list(path), out_dir, sample_dir, grid_path,
        host["states"].map(lambda a: a[b]),
        host["options"].map(lambda a: a[b]), perm,
        int(host["correct_index"][b]), type(params)(*(a[b] for a in params)),
        bool(use_grid), cfg.grid_size, cfg.canvas_size, pipe.layout,
        cfg.seed, (cfg.seed or 0) + sid, grid_only=cfg.grid_only)
    hexhash = bytes(host["grid_phash"][b]).hex()
    meta["grid_phash"] = hexhash
    coco = build_coco(sid, leaf, grid_path, out_dir, pipe.layout.grid_h,
                      meta["cells_meta"])
    frames = {}
    if not cfg.grid_only:
        for t in range(L):
            frames[f"state_{t}.png"] = host["state_imgs"][b, t]
        for pos in range(O):
            src = int(perm[pos])
            name = "proto_true_next.png" if src == 0 else f"option_{src}.png"
            frames[name] = host["option_imgs"][b, pos]
        frames["query.png"] = np.asarray(pipe.layout.query_patch)
    return {"grid": host["grid_img"][b], "frames": frames, "phash": hexhash,
            "meta": json.loads(json.dumps(meta, ensure_ascii=False)),
            "coco": json.loads(json.dumps(coco, ensure_ascii=False))}
