#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                # one card
    python3 chip_smoke.py --all-cards    # phases 1, 2, 14, 16 on every card
    python3 chip_smoke.py --eager-step   # phases 1, 2, the eager step's
                                         # host syncs and wall, the warm
                                         # dispatch's launches, 16

On a card a generator's batch is a few CUDA graph replays (utils/graphs.py:
the leaf step or the mg render, and the rest of the batch: keys,
compaction, dedup, pHash, pack, blob), all of a card's graphs in one
memory pool, so phases 4, 5, 8, 10 to 14 run through graphs.
--eager-step prints, for each batch step of phase 15, the host syncs of
one warm eager step and its host wall, and for each generator
configuration of dispatch_configs() the host syncs, the launches outside
graph replays (torch.profiler) and the host wall of one warm dispatch; it
reads the package beside the script, so a copy of the script in an older
tree reads that tree's step (its LeafPipeline.__call__ where it has no
``step``) and generators.

Phases, in order; any failure exits non-zero before the result line:
  1. card: CUDA must be available; prints the card's name and power limit;
  2. build: compiles the frame rasterizer (csrc/raster.cu), the mg scene
     renderer (csrc/mg_render.cu), both with csrc/poly.cuh, the threefry
     key streams (csrc/threefry.cu with csrc/threefry.cuh) and the PNG
     encoder (csrc/fastpng.c), all at once, and prints each build's time;
     fails unless the PNG encoder picked is the C one;
  3. K1: the rasterizer against its plain PyTorch version on the card, byte
     for byte, on every element set of k1_cases; both timed on 256 frames
     (CUDA events around the wrapper, and the kernel's own device time
     under torch.profiler);
  3a. threefry: the card tests of tests/test_torch_prng_native.py (each
     key stream on the key views the leaves hand it, eagerly and replayed
     from a CUDA graph, the samplers through it, no op of the integer
     code on the card, the 9 leaves' sample functions, all bit for bit
     against the CPU; one launch a call), run by pytest without JAX; then
     each of the 9 rule leaves' LeafPipeline.step against the CPU's step
     of a batch of 2 at 512x512: a batch of 2 on the card, and rows 0 and
     31 of a batch of 32 grid-only, each eager and replayed, every output
     equal; at batch 32 the threefry launches of a step, the capture
     call's wall and a replay's kernels (readings);
  4. RPM main path: the port's CLI for 64 samples at 512x512, with full
     export, with --grid_only --dedup, and with --sparse (the rle4d
     transfer codec), whose tree must equal the full export's (PNGs in
     decoded pixels, JSON but for wall-clock fields); checks index.json,
     decodes every PNG, prints each run's transfer_bytes and requires that
     these runs launched K1 and that each launched the threefry kernel
     (prng_cuda.LAUNCHES, printed); prints the graphs each CLI run captured
     (phases 8 and 10 too).  Before it RPMGenerator.warmup captures one
     leaf's graph at batch 32; after it measure_device_rate reads that
     leaf's samples/s, queued and blocking (a reading, not a check);
  5. RPM card against CPU: 2 ids of each of the 9 rule leaves through the
     pipeline on the card and on the CPU; every output must be equal;
  6. K1 at the 'hq' shape: sampled and hand-built frames (strokes 4 and 6
     after scaling, mirrored outlines, an element across an edge) through
     ops/raster.render_batch in 'hq' mode at 512x512, scale 2.  The inner
     1024x1024 render is compared kernel against plain on the card, byte
     for byte; the run must have launched K1; the downsampled frames of
     the card must equal the port's on the CPU; the 1024x1024 launch is
     timed as in phase 3, on 64 frames;
  7. 'soft' fills, an outline and a background colour, the overlay
     (prepare and blend) and Shape.draw, each on the card against the port
     on the CPU.  Exact where the arithmetic is selection or elementwise
     float32; at most 1 on a bounded share of the bytes where erf or a
     float32 matmul's summation order differs between card and CPU;
  8. two hosts on one card: the RPM CLI with --num_hosts 2, --host_id 0
     then 1, --grid_only --dedup into one directory, against a reference
     built from one single-process run without dedup (each host's greedy
     pass in its visiting order, then the merge's by id); no file of a
     sample dropped at the merge may remain;
  9. K2: the mg scene renderer against its plain version on the card, byte
     for byte, on 16 generated scenes and the hand-built scenes at dpi 200,
     34 and 25, and on the pixel-space scenes of mg_pixel_batch at 1600,
     272 and 200 px; both timed on the 16 scenes at 1600x1600, as K1;
 10. mg main path: the port's mg CLI for 64 scenes at dpi 200 (1600x1600),
     through its rle4 transfer, twice (the second run warm, with the first
     run's tiers); decodes every PNG, parses every params JSON and
     requires that the runs launched K2;
 11. mg card against CPU: GeometryGenerator (rle4) on 8 scenes at dpi 50
     with dedup on both devices; records (but generation_id and
     timestamp), params JSON and pixels must be equal;
 12. mg stage profile: host-timed stages of one batch of 16 scenes at
     1600x1600 (median of 3: scene build; prep, K2 and pHash eagerly;
     the render with its pHash, the dedup step and the rle4 pack replayed
     (the rle4 pack eagerly too); the generator's pack, blob, copy and
     split; PNG encode from the runs; QC), the blob copy's device time,
     and the device's busy time under torch.profiler for 64 scenes
     through GeometryGenerator;
 13. transfer codecs: every codec's pack and compaction on the card must
     equal the port's on the CPU, element for element, on K1's frames of
     平移 and 直接叠加 (batch 32, 512x512: states, options with their delta
     bases, grids before their overlay) and on K2's 16 scenes at 1600x1600
     (rle4, rle5, and a budget that forces overflows: those scenes must
     come back raw, the rest decode to the card's pixels); a blob read
     through the pinned copy must equal the device's bytes.  Prints each
     codec's pack time on the card (CUDA events, median of 3) and, per
     batch, the bytes the generators move and the blob copy's time, first
     from no statistics and then with tiers, beside the raw batch's copy
     (pinned and pageable);
 14. device mesh: RPMGenerator (512x512, batch 32, full export, dedup; 平移
     40 ids, 直接叠加 12: full batches and ragged tails) and
     GeometryGenerator (32 scenes at 1600x1600, batch 16, four modes,
     dedup, duplicates across shards and batches) on make_mesh of two
     handles to the card, each against its run on one device, each warmed
     first (its graphs captured): metas or records, keep masks, JSON and
     PNG bytes equal; K1 and K2 launched once a shard, and the threefry
     kernel by each RPM run (prng_cuda.LAUNCHES, printed).  Then an NCCL
     world of size 1: sharded_dedup_mask over
     ("host", "data") on make_hybrid_mesh against dedup_keep_mask and
     dedup_keep_mask_vs_corpus, with a timeout of its own; prints the
     mesh runs' wall time beside one device's (a reading).  With
     --all-cards the generators build their mesh by themselves over the
     visible cards (RPM over the most that divide its batch of 32, mg
     over all), against RPM pinned by use_mesh=False and mg on a mesh of
     one card, twice (the walls are read from the second, warm pass), and
     the NCCL world's mesh holds every card;
 15. the compiled batch step: for every rule leaf at 512x512, batch 32,
     full export (and 平移 grid-only and --sparse rle4d), the pipeline's
     CUDA graph replay must equal LeafPipeline.step byte for byte on two
     key sets, the first replay's outputs must be unchanged by the
     second, K1 must count 2 warm launches and 1 a replay, a warm eager
     step must pass set_sync_debug_mode('error') and a replay make no
     host sync ('warn' counts none).  The mg render's replay
     (GeometryGenerator) must equal the eager render on 16 scenes at
     1600x1600, and on 16 others at the second replay.  Prints per step
     the capture call, eager step and replay in host wall and CUDA events
     (median of 3), the kernels the profiler traced in a replay, the
     memory reserved, and the device's busy share over an RPM generator
     run of 64 samples (readings, not checks).  Then the rest of a batch
     (tail_cases: the RPM keys, the --sparse compaction rle4d and rle5d,
     the dedup step at 32 and 16, the RPM blob of a full export and of
     --sparse at tiers; the mg render with its pHash, the rle4 and rle5
     packs, the mg blob at tiers): each replay must equal its eager step
     byte for byte on two input sets, A's outputs unchanged by B's
     replay; then every graph of the phase, leaf steps included, replayed
     in the reverse of capture order and each again on A, B, A, must
     still equal its eager step.  Prints the shared pool's memory (the
     allocator's snapshot) after the 11 leaf graphs and after all, and
     each tail step's capture call, eager and replay times and kernels.
     Then a warm dispatch of each of dispatch_configs() (RPM 平移 full
     export and --sparse rle4d, both with the dedup; mg rle4 with the
     dedup) must pass set_sync_debug_mode('error') and launch no kernel
     outside its graphs but copies; prints its syncs, its launches
     outside graph replays (torch.profiler) and its host wall;
 16. the JAX package and JAX were never imported.
Prints the kernel table as one JSON line (with each kernel's bound: the
larger of its bytes over 3.35 TB/s and its float32 operations over
67 TFLOP/s, the H100 SXM's published peaks; the operations are counted per
pixel with the kernels' cull rules at their finest grain, so the bound
depends on no tile shape), the card's name and power limit, then the
contract line {"ok": true, "device": {...}} last.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_PER_S = 67e12         # H100 SXM float32, outside the tensor cores

# float32 operations per pixel, counted from the kernels' sources (a fused
# multiply-add counts 2; per-edge and per-line constants are not counted)
EDGE_DIST_OPS = 16     # one polygon edge of the distance loop
EDGE_CROSS_OPS = 6     # one polygon edge of the crossing count
EDGE_OPS = EDGE_DIST_OPS + EDGE_CROSS_OPS
K1_CIRCLE_OPS = 10     # analytic circle distance + stroke
K1_ELEM_OPS = 20       # stroke ramp, compositing
K2_SHAPE_OPS = 16      # stroke band, mask keep, compositing
K2_GRAD_OPS = 34       # radial gradient fill
K2_RB_OPS = 12         # replace_boundary stroke
K2_LINE_OPS = 35       # one decoration segment
OUT_OPS = 9            # round and clamp 3 channels


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _tiles(W: int, H: int, tw: int, th: int):
    """Tile origins (x [1, nx], y [ny, 1]) and pixels per tile [ny, nx]."""
    import torch
    tx = torch.arange(0, W, tw, dtype=torch.float32)
    ty = torch.arange(0, H, th, dtype=torch.float32)
    npx = (H - ty).clamp(max=th)[:, None] * (W - tx).clamp(max=tw)[None, :]
    return tx[None, :], ty[:, None], npx


def k1_work_tiled(meta, W: int, H: int):
    """The earlier count, kept so that earlier bounds stay readable: bytes
    and float32 operations for prepared frames when a 32x32 tile cull in
    the wrap-around metric decides which elements each pixel evaluates, at
    all their edges."""
    import torch
    from reasoning_image_generation_tpu_torch.ops import raster as R
    m = meta.float().cpu()
    N, E = m.shape[:2]
    tx, ty, npx = _tiles(W, H, 32, 32)
    ecx = ((m[..., R.M_BX0] + m[..., R.M_BX1]) * 0.5)[..., None, None]
    ecy = ((m[..., R.M_BY0] + m[..., R.M_BY1]) * 0.5)[..., None, None]
    ehw = ((m[..., R.M_BX1] - m[..., R.M_BX0]) * 0.5)[..., None, None]
    ehh = ((m[..., R.M_BY1] - m[..., R.M_BY0]) * 0.5)[..., None, None]
    dxw = (torch.remainder(tx + 16 - ecx + W / 2, W) - W / 2).abs()
    dyw = (torch.remainder(ty + 16 - ecy + H / 2, H) - H / 2).abs()
    hit = (m[..., R.M_VALID] > 0)[..., None, None] & (dxw <= 16 + ehw) & \
        (dyw <= 16 + ehh)                                # [N, E, ny, nx]
    circle = m[..., R.M_CIRCLE] > 0
    cres = m[..., R.M_CRESCENT] > 0
    edges = torch.where(m[..., R.M_SMALL] > 0, 8, 64).float()
    per_px = torch.where(circle, K1_CIRCLE_OPS,
                         torch.where(cres, 2 * K1_CIRCLE_OPS,
                                     edges * EDGE_OPS)) + K1_ELEM_OPS
    per_px = per_px + (m[..., R.M_HASP1] > 0) * (8 * EDGE_OPS + K1_ELEM_OPS)
    ops = float((hit * npx * per_px[..., None, None]).sum()) \
        + N * H * W * OUT_OPS
    nbytes = N * H * W * 3 + N * E * (R.NMETA + 2 * 2 * 64) * 4 + N
    return nbytes, ops


def k2_work_tiled(meta, lin, W: int, H: int):
    """The earlier count, kept so that earlier bounds stay readable: bytes
    and float32 operations for prepared scenes when a 32x16 tile cull
    decides which shapes, masks and lines each pixel evaluates, at all
    their edges."""
    from reasoning_image_generation_tpu_torch.models.multigraph import (
        renderer as R)
    m, q = meta.float().cpu(), lin.float().cpu()
    N = m.shape[0]
    tx, ty, npx = _tiles(W, H, 32, 16)

    def hit(valid, bx0, bx1, by0, by1):
        e = lambda v: v[..., None, None]
        return e(valid) & (e(bx1) >= tx) & (e(bx0) <= tx + 32) & \
            (e(by1) >= ty) & (e(by0) <= ty + 16)

    sh = hit(m[:, R.R_VALID, :3] > 0, m[:, R.R_BX0, :3], m[:, R.R_BX1, :3],
             m[:, R.R_BY0, :3], m[:, R.R_BY1, :3])       # [N, 3, ny, nx]
    mode = m[:, R.R_MODE, 0]
    per_shape = 64 * EDGE_OPS + K2_SHAPE_OPS \
        + (m[:, R.R_GRAD, :3] > 0) * K2_GRAD_OPS
    per_shape[:, 0] += (mode == 2) * K2_RB_OPS
    n_masks = (m[:, R.R_MASK_VALID, :3] > 0).sum(1) * (mode > 0)
    lh = hit(q[..., R.L_VALID] > 0, q[..., R.L_BX0], q[..., R.L_BX1],
             q[..., R.L_BY0], q[..., R.L_BY1])           # [N, 24, ny, nx]
    ops = float((sh * npx * per_shape[..., None, None]).sum()) \
        + float((sh[:, 0] * npx * (n_masks * 64 * EDGE_OPS)[:, None, None]
                 ).sum()) \
        + float((lh * npx).sum()) * K2_LINE_OPS + N * H * W * OUT_OPS
    nbytes = N * H * W * 3 + (meta.numel() + 4 * N * 3 * 64 + lin.numel()) * 4
    return nbytes, ops


def k1_work(meta, vx, vy, W: int, H: int):
    """Bytes and float32 operations K1 needs for prepared frames, counted
    per pixel with the kernel's rules at their finest grain
    (raster.tile_culls with a 1x1 tile): an element's stroke and
    compositing for the pixels inside its bbox and wrap gate, the distance
    step for the edges near that pixel, the crossing step for the edges
    that span that pixel's row, and only where the element is filled."""
    import torch
    from reasoning_image_generation_tpu_torch.ops import raster as R
    N, E = meta.shape[:2]
    ops = 0.0
    # every live element slot is counted as a frame of its own (the rules
    # know no neighbour), a few to a pass; outlines of at most 8 edges go
    # 8 times as many to a pass as 64-edge ones: the passes' memory is alike
    on = meta[..., R.M_VALID].reshape(-1) > 0
    fm = meta.reshape(N * E, 1, R.NMETA)[on]
    fx = vx.reshape(N * E, 1, *vx.shape[2:])[on]
    fy = vy.reshape(N * E, 1, *vy.shape[2:])[on]
    poly = ~((fm[..., R.M_CIRCLE] > 0) | (fm[..., R.M_CRESCENT] > 0))
    big = (poly & ~(fm[..., R.M_SMALL] > 0))[:, 0]
    passes = []
    for idx, V in ((torch.nonzero(~big).squeeze(1), R.SMALL_V),
                   (torch.nonzero(big).squeeze(1), 64)):
        step = max(1, (1 << 26) // (H * W * 2 * V))
        passes += [idx[i:i + step] for i in range(0, len(idx), step)]
    for idx in passes:
        m = fm[idx]
        c = R.tile_culls(m, fx[idx], fy[idx], W, H, (1, 1))
        live = c.live                                     # [n, 1, H, W]
        analytic = (m[..., R.M_CIRCLE] > 0) | (m[..., R.M_CRESCENT] > 0)
        per_px = K1_ELEM_OPS * (1 + (m[..., R.M_HASP1] > 0).float()) + \
            torch.where(m[..., R.M_CIRCLE] > 0, K1_CIRCLE_OPS,
                        2 * K1_CIRCLE_OPS) * analytic
        ops += float((live.sum((-1, -2)) * per_px).sum())
        ops += float(c.near.sum()) * EDGE_DIST_OPS
        # crossing steps: edges spanning a row, on that row's live pixels
        cols = live.sum(-1).float()                       # [n, 1, H]
        filled = (m[..., R.M_FILL] != 0)[..., None]
        ops += float((c.rows.sum((-1, -2)) * cols * filled).sum()) \
            * EDGE_CROSS_OPS
        del c, live
    ops += N * H * W * OUT_OPS
    nbytes = N * H * W * 3 + N * E * (R.NMETA + 2 * 2 * 64) * 4 + N
    return nbytes, ops


def k2_work(args, W: int, H: int):
    """Bytes and float32 operations K2 needs for prepared scenes, counted
    per pixel with the kernel's rules at their finest grain
    (renderer.tile_culls with a 1x1 tile): the distance step for the edges
    near that pixel, stroke and compositing where there is one, the
    crossing step for the edges that span the pixel's row where the sign
    is read (gradient, replace_boundary, the mask union under shape 0's
    stroke), the gradient inside a gradient shape's bbox, and a line where
    it is near."""
    from reasoning_image_generation_tpu_torch.models.multigraph import (
        renderer as R)
    meta, lin = args[0], args[5]
    N = meta.shape[0]
    ops = 0.0
    for i in range(N):
        one = [a[i:i + 1] for a in args]
        c = R.tile_culls(*one, H, W, (1, 1))
        m = one[0][0]
        mode = float(m[R.R_MODE, 0])
        live = c.shape_live[0]                            # [3, H, W]
        n_near = (c.shape_near[0].sum(-1) * live)         # [3, H, W]
        m_near = c.mask_near[0].sum(-1).sum(0) * live[0]  # [H, W]
        ops += float(n_near.sum()) * EDGE_DIST_OPS
        ops += float((n_near > 0).sum()) * K2_SHAPE_OPS
        grad = m[R.R_GRAD, :3] > 0
        rb = (m_near > 0) & (mode == 2)
        sign = grad[:, None, None] & live
        sign[0] |= rb
        rows = c.shape_rows[0].sum(-1)[..., None]         # [3, H, 1]
        ops += float((rows * sign).sum()) * EDGE_CROSS_OPS
        ops += float((grad[:, None, None] * live).sum()) * K2_GRAD_OPS
        ops += float(rb.sum()) * K2_RB_OPS
        if mode > 0:
            ops += float(m_near.sum()) * EDGE_DIST_OPS
            read = (n_near[0] > 0) | rb
            mrows = c.mask_rows[0].sum(-1).sum(0)[:, None]  # [H, 1]
            ops += float((mrows * read).sum()) * EDGE_CROSS_OPS
        ops += float((c.line_near[0] & c.line_live[0]).sum()) * K2_LINE_OPS
        del c
    ops += N * H * W * OUT_OPS
    nbytes = N * H * W * 3 + (meta.numel() + 4 * N * 3 * 64 + lin.numel()) * 4
    return nbytes, ops


MG_MODES = ("random", "nested", "adjacent", "intersecting")


def mg_generated_batch(n: int = 16):
    """n generated mg scenes, seeds 0..n-1, modes cycling over MG_MODES."""
    from reasoning_image_generation_tpu_torch.models.multigraph.scene import (
        build_scene_batch)
    return build_scene_batch(list(range(n)),
                             [MG_MODES[i % 4] for i in range(n)])[0]


def mg_hand_batch():
    """Hand-built mg scenes for the branches generated scenes rarely or
    never reach: a mask 'cut', a 'replace_boundary' with 3 masks, radial
    gradients on all 3 shapes, 24 decoration lines (one of zero length, some
    crossing the canvas edge), and all of them in one scene."""
    import numpy as np
    from reasoning_image_generation_tpu_torch.models.multigraph.scene import (
        MPL_CYCLE, circle_poly, empty_scene, hex_to_rgb, rect_poly,
        regular_poly, wedge_poly)

    def shape(sc, i, verts, lw=1.8, alpha=0.9):
        sc["shape_verts"][i] = verts
        sc["shape_lw"][i] = lw
        sc["shape_alpha"][i] = alpha
        sc["shape_valid"][i] = True

    def masks(sc, mode, *polys):
        sc["mask_mode"] = np.int32(mode)
        for i, p in enumerate(polys):
            sc["mask_verts"][i] = p
            sc["mask_valid"][i] = True

    def gradients(sc):
        for i, (c0, c1) in enumerate((("#FF6B6B", "#4ECDC4"),
                                      ("#1f77b4", "#ffdd00"),
                                      ("#2ca02c", "#9467bd"))):
            sc["grad_valid"][i] = True
            sc["grad_c0"][i] = hex_to_rgb(c0)
            sc["grad_c1"][i] = hex_to_rgb(c1)
            sc["grad_alpha"][i] = 0.75 - 0.2 * i

    def lines(sc):
        for k in range(24):
            a = 2 * np.pi * k / 24
            p0 = (0.4 * np.cos(a), 0.4 * np.sin(a))
            p1 = p0 if k == 5 else (6.2 * np.cos(a), 6.2 * np.sin(a))
            sc["line_pts"][k] = [p0[0], p0[1], p1[0], p1[1]]
            sc["line_lw"][k] = 0.8 + 0.15 * (k % 5)
            sc["line_alpha"][k] = 0.5 + 0.02 * k
            sc["line_color"][k] = hex_to_rgb(MPL_CYCLE[k % len(MPL_CYCLE)])
            sc["line_valid"][k] = True

    scenes = []
    sc = empty_scene()                                   # mask cut
    shape(sc, 0, circle_poly((0.3, -0.2), 3.0))
    masks(sc, 1, rect_poly((1.5, -1.0), 3.0, 2.0),
          circle_poly((-2.8, 1.5), 1.2))
    scenes.append(sc)
    sc = empty_scene()                                   # replace_boundary
    shape(sc, 0, regular_poly((0.0, 0.0), 6, 3.4), lw=2.0)
    masks(sc, 2, circle_poly((2.5, 1.0), 1.4),
          regular_poly((-2.0, -2.2), 3, 1.6, 0.4),
          rect_poly((-1.0, 2.3), 2.0, 1.5))
    scenes.append(sc)
    sc = empty_scene()                                   # 3 gradients
    shape(sc, 0, circle_poly((-2.2, 1.8), 1.9))
    shape(sc, 1, rect_poly((0.2, -0.5), 3.5, 2.5), lw=1.5)
    shape(sc, 2, wedge_poly((-1.5, -2.5), 2.2, 20.0, 290.0), lw=1.6)
    gradients(sc)
    scenes.append(sc)
    sc = empty_scene()                                   # 24 lines
    shape(sc, 0, regular_poly((0.0, 0.0), 5, 2.5, 0.3))
    lines(sc)
    scenes.append(sc)
    sc = empty_scene()                                   # everything at once
    shape(sc, 0, circle_poly((0.0, 0.0), 3.2))
    shape(sc, 1, rect_poly((-4.45, -4.55), 2.0, 2.0), lw=1.5)
    shape(sc, 2, regular_poly((3.4, 3.4), 4, 1.3), lw=1.6)
    masks(sc, 2, circle_poly((2.4, 0.0), 1.3), rect_poly((-3.9, -1.0), 2.0, 2.0))
    gradients(sc)
    lines(sc)
    scenes.append(sc)
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}


def mg_pixel_batch(S: int, device):
    """Prepared K2 inputs (as renderer.prepare_scene_batch packs them) built
    directly in pixel space on an S x S canvas, aimed at the kernel's culls
    (32x16 tiles, strokes that reach lw/2 + 0.5): outline edges exactly on
    tile borders and exactly one reach away from a tile's last pixel
    centre, a zero-length edge, a horizontal edge on a pixel-centre row, a
    shape that wholly contains tiles (gradient off and on), masks that
    leave shape 0's bbox under 'cut' and 'replace_boundary', lines on a
    tile border, on a pixel-centre row and of zero length, and an empty
    scene."""
    import numpy as np
    import torch
    from reasoning_image_generation_tpu_torch.models.multigraph import (
        renderer as R)

    def rect(x0, y0, x1, y1):
        """64 vertices: 16 a side, the first of each side repeated once
        (a zero-length edge)."""
        t = np.concatenate([[0.0], np.arange(15) / 15.0])
        xs = np.concatenate([x0 + (x1 - x0) * t, np.full(16, x1),
                             x1 + (x0 - x1) * t, np.full(16, x0)])
        ys = np.concatenate([np.full(16, y0), y0 + (y1 - y0) * t,
                             np.full(16, y1), y1 + (y0 - y1) * t])
        return xs, ys

    def ring(cx, cy, r):
        a = 2 * np.pi * np.arange(64) / 64
        return cx + r * np.cos(a), cy + r * np.sin(a)

    u = S / 200.0                  # the coarse layout scales with the canvas
    lw = 2.0                       # reach 1.5 px
    scenes = []
    # edges on tile borders (x = 64, y = 48), one reach beyond the tile's
    # last pixel centre (x = 159.5 + 1.5), a horizontal edge on a pixel row
    box = rect(64.0, 48.0, 161.0, 112.5)
    scenes.append({"shapes": [(box, lw, None)]})
    scenes.append({"shapes": [(box, lw, ((255, 107, 107), (78, 205, 196)))]})
    # a shape that wholly contains tiles, another wholly inside it
    big = rect(20 * u, 24 * u, 180 * u, 170 * u)
    scenes.append({"shapes": [(big, 3.0, None), (ring(100 * u, 90 * u, 30 * u),
                                                 lw, None)]})
    scenes.append({"shapes": [(big, 3.0, ((31, 119, 180), (255, 221, 0))),
                              (ring(100 * u, 90 * u, 30 * u), lw,
                               ((44, 160, 44), (148, 103, 189)))]})
    # masks that leave shape 0's bbox, one wholly outside it
    base = ring(100 * u, 100 * u, 50 * u)
    masks = [rect(120 * u, 80 * u, 199 * u, 128.0), ring(20 * u, 20 * u, 15 * u),
             ring(75 * u, 100 * u, 20 * u)]
    for mode in (1, 2):
        scenes.append({"shapes": [(base, lw, None)], "masks": masks,
                       "mode": mode})
    scenes.append({"shapes": [(base, lw, ((255, 107, 107), (78, 205, 196))),
                              (rect(96.0, 32.0, 128.0, 64.0), 1.0, None)],
                   "masks": masks, "mode": 2})
    # lines: on a tile border, a reach from it, on a pixel row, zero length
    scenes.append({"shapes": [(ring(100 * u, 100 * u, 40 * u), lw, None)],
                   "lines": [(96.0, 10.0, 96.0, 150 * u), (129.5, 5.0, 129.5, 90.0),
                             (8.0, 40.5, 190 * u, 40.5), (50.0, 50.0, 50.0, 50.0),
                             (3.0, 3.0, 197 * u, 180 * u), (-20.0, 70.0, 230 * u, 64.0)]})
    scenes.append({})              # nothing valid: a white canvas
    N = len(scenes)
    meta = np.zeros((N, R.NMETA, R.NCOL), np.float32)
    svx = np.zeros((N, 3, 64), np.float32)
    svy, mvx, mvy = svx.copy(), svx.copy(), svx.copy()
    lin = np.zeros((N, 24, R.NLIN), np.float32)
    meta[:, R.R_BX0], meta[:, R.R_BY0] = 1e9, 1e9
    meta[:, R.R_BX1], meta[:, R.R_BY1] = -1e9, -1e9
    for i, sc in enumerate(scenes):
        meta[i, R.R_MODE, 0] = sc.get("mode", 0)
        for j, ((xs, ys), w, grad) in enumerate(sc.get("shapes", [])):
            svx[i, j], svy[i, j] = xs, ys
            x, y = svx[i, j], svy[i, j]
            pad = np.float32(w * 0.5 + 2.0)
            meta[i, [R.R_VALID, R.R_LW, R.R_ALPHA], j] = 1.0, w, 0.9
            meta[i, [R.R_BX0, R.R_BX1, R.R_BY0, R.R_BY1], j] = (
                x.min() - pad, x.max() + pad, y.min() - pad, y.max() + pad)
            if grad:
                cx, cy = x.mean(), y.mean()
                meta[i, [R.R_GRAD, R.R_GCX, R.R_GCY, R.R_GALPHA], j] = (
                    1.0, cx, cy, 0.6)
                meta[i, R.R_GRMAX, j] = np.hypot(x - cx, y - cy).max() + 1e-6
                meta[i, R.R_C0R:R.R_C0R + 3, j] = grad[0]
                meta[i, R.R_C1R:R.R_C1R + 3, j] = grad[1]
        for j, (xs, ys) in enumerate(sc.get("masks", [])):
            mvx[i, j], mvy[i, j] = xs, ys
            meta[i, R.R_MASK_VALID, j] = 1.0
        for k, (x0, y0, x1, y1) in enumerate(sc.get("lines", [])):
            w = 1.0 + 0.5 * k
            pad = w * 0.5 + 2.0
            lin[i, k, :R.L_R] = (1.0, min(x0, x1) - pad, max(x0, x1) + pad,
                                 min(y0, y1) - pad, max(y0, y1) + pad,
                                 x0, y0, x1, y1, w, 0.8)
            lin[i, k, R.L_R:R.L_R + 3] = (30.0 * k, 200.0 - 25 * k, 90.0)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (meta, svx, svy, mvx, mvy, lin))


def k1_elem(kind, size=140, center=(256, 256), angle=45.0,
            color=(40, 80, 200)):
    return {"kind": kind, "size": size, "fill": True, "stroke_width": 2,
            "center": center, "angle": angle, "bbox": (0, 0, size, size),
            "flip": {"h": False, "v": False}, "color": color}


def k1_hand_cases():
    """(name, frames [N, 8] as ElementState on the CPU, W, H): hand-built
    element sets for the rasterizer's branches and culls (32x32 tiles,
    strokes that reach band + 0.28 = 2.28 px)."""
    from reasoning_image_generation_tpu_torch.utils.config import SHAPE_KINDS
    from reasoning_image_generation_tpu_torch.utils.state import (
        dicts_to_state, stack)
    elem = k1_elem
    frames = lambda *els: stack([dicts_to_state(list(e), 8) for e in els])
    cases = [("11 kinds", frames(*(
        [elem(k), elem("circle", 80, (420, 100), color=(200, 30, 30))]
        for k in SHAPE_KINDS)), 512, 512)]
    wrap = [elem("hexagon", 40, (60, 32), angle=30.0),
            elem("circle", 30, (140, 30), color=(200, 30, 30)),
            elem("plus", 40, (200, 32 + 2 * 64), angle=0.0),  # 2 canvases off
            elem("star", 36, (250, 40), color=(30, 160, 60))]
    cases.append(("wrap gate 256x64", frames(wrap), 256, 64))
    tiles = [elem("hexagon", 90, (580, 100), angle=30.0),
             elem("heart", 70, (40, 190), color=(30, 160, 60)),
             elem("star", 80, (510, 60), color=(200, 30, 30)),
             elem("circle", 60, (300, 64))]
    cases.append(("600x200", frames(tiles), 600, 200))
    untiled = [elem("hexagon", 90, (380, 100), angle=30.0),
               elem("heart", 70, (40, 180), color=(30, 160, 60))]
    cases.append(("400x200", frames(untiled), 400, 200))
    # axis-aligned squares: horizontal edges on pixel rows; vertices on the
    # tile borders 32 and 96 (size 64), 2 px (inside the reach) and 3 and
    # 4 px (beyond it) from them; a heart that wholly contains tiles; a
    # 2 px square whose outline is all but zero-length edges
    borders = [[elem("square", sz, (64, 64), angle=0.0),
                elem("heart", 200, (150, 150), color=(30, 160, 60)),
                elem("square", 2, (200, 40), angle=0.0)]
               for sz in (64, 60, 58, 56, 68)]
    cases.append(("tile borders 256x256", frames(*borders), 256, 256))
    # elements two canvases off in x and in y, and the seam inside a tile,
    # on a width whose rows are not 4-byte aligned (byte stores)
    off = [elem("hexagon", 40, (60 + 2 * 250, 32), angle=30.0),
           elem("plus", 40, (200, 32 + 2 * 70), angle=0.0),
           elem("heart", 50, (125 - 250, 35 - 70), color=(30, 160, 60)),
           elem("circle", 30, (140 + 3 * 250, 30), color=(200, 30, 30)),
           elem("star", 36, (245, 66), color=(200, 30, 30))]
    cases.append(("wrap gate 250x70", frames(off, off[2:]), 250, 70))
    cases.append(("3 empty frames", frames([], [], []), 96, 80))
    # 16 element slots, 13 of them live: the edge tables outgrow the 48 KB
    # of shared memory a kernel gets without asking
    crowd = [elem(k, 50 + 6 * i, (30 + 17 * i, 200 - 13 * i), angle=20.0 * i,
                  color=(20 * i, 250 - 19 * i, 90))
             for i, k in enumerate(list(SHAPE_KINDS) + ["heart", "plus"])]
    cases.append(("16 slots 256x256",
                  stack([dicts_to_state(crowd, 16),
                         dicts_to_state(crowd[::-1], 16)]), 256, 256))
    return cases


def k1_hq_hand_frames():
    """Frames [4, 8] on a 512x512 canvas for the 'hq' mode at scale 2:
    strokes of 2 and 3 (4 and 6 at 1024x1024, bands 3 and 4), mirrored
    outlines of kinds that have no mirror symmetry at these angles, an
    element across the right edge, one across a corner and one two
    canvases off (the wrap gate), a crescent and circles."""
    from reasoning_image_generation_tpu_torch.utils.state import (
        dicts_to_state, stack)

    def el(kind, size, center, stroke, flip=(False, False), **kw):
        d = k1_elem(kind, size=size, center=center, **kw)
        d["stroke_width"] = stroke
        d["flip"] = {"h": flip[0], "v": flip[1]}
        return d
    return stack([dicts_to_state(f, 8) for f in (
        [el("heart", 180, (140, 150), 2, (True, False), angle=20.0),
         el("circle", 90, (380, 330), 3, color=(200, 30, 30)),
         el("star", 120, (500, 100), 3, (False, True), angle=13.0)],
        [el("crescent", 150, (256, 256), 2, (True, False), angle=40.0),
         el("plus", 160, (505, 500), 3, angle=30.0),
         el("triangle", 140, (120, 380), 2, (True, True), angle=77.0)],
        [el("hexagon", 130, (60 + 2 * 512, 64), 3, angle=30.0),
         el("square", 64, (64, 64), 2, angle=0.0),
         el("pentagon", 100, (300, 120), 3, (True, False), angle=5.0),
         el("heart", 90, (10, 250), 3, (False, True), color=(30, 160, 60))],
        [])])


CODECS = ("rle", "rle2", "rle3", "rle3d", "rle4", "rle4d", "rle5", "rle5d",
          "sparse")
COMPACT = ("rle3", "rle3d", "rle4", "rle4d", "rle5", "rle5d")


def events_ms(fn, reps: int = 3) -> float:
    """Median over `reps` calls of fn's device time between two CUDA events
    (after one warm call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[reps // 2]


def pageable_ms(t, reps: int = 3) -> float:
    """Median host time of ``t.cpu()`` (a copy into pageable memory, what
    the port did before the blob copy)."""
    import torch
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.cpu()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[reps // 2]


def diff_leaves(a, b) -> list:
    """Indices of the leaves where two packed trees differ (card tensors
    against CPU tensors, shapes and dtypes included)."""
    from reasoning_image_generation_tpu_torch.io.transfer import tree_flatten
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    if len(la) != len(lb):
        return ["arity"]
    return [i for i, (x, y) in enumerate(zip(la, lb))
            if x.shape != y.shape or x.dtype != y.dtype
            or not bool((x.cpu() == y).all())]


WALL_CLOCK = ("timestamp", "generation_time", "generation_id")


def stable(x):
    """A JSON value with every wall-clock entry dropped, at any depth."""
    if isinstance(x, dict):
        return {k: stable(v) for k, v in x.items() if k not in WALL_CLOCK}
    return [stable(v) for v in x] if isinstance(x, list) else x


def tree_difference(a: str, b: str):
    """The first file in which the trees under a and b differ: PNGs byte
    for byte, JSON once each root and the wall-clock fields are gone ->
    (its name or None, the number of files)."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    def read(path):
        with open(path, "rb") as f:
            return f.read()
    names = files(a)
    if files(b) != names:
        return "the file lists", len(names)
    for rel in names:
        x, y = (read(os.path.join(r, rel)) for r in (a, b))
        if rel.endswith(".json"):
            x, y = (stable(json.loads(t.decode().replace(r, "<out>")))
                    for t, r in ((x, a), (y, b)))
        if x != y:
            return rel, len(names)
    return None, len(names)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_world_of_one(dev, devices, timeout_s: float = 180.0):
    """sharded_dedup_mask over ("host", "data") on make_hybrid_mesh of
    `devices`, in an NCCL world of size 1 on a loopback port, on
    hashes with a duplicate across the shards, a near one inside a shard
    and two in a corpus; the group is destroyed afterwards.  Runs in a
    thread of its own: a collective that hangs ends the whole run after
    `timeout_s`.  -> (hashes, masks without and with the corpus, the
    corpus, the mesh's shape, the gathers the collective made)."""
    import threading
    import numpy as np
    import torch
    import torch.distributed as dist
    from reasoning_image_generation_tpu_torch.parallel import mesh as mesh_lib

    done = {}
    real_gather = dist.all_gather_into_tensor
    gathers = []

    def counted_gather(*args, **kw):
        gathers.append(args[1].shape)
        return real_gather(*args, **kw)

    def body():
        try:
            torch.cuda.set_device(dev)
            dist.init_process_group(
                "nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                world_size=1, rank=0)
            dist.all_gather_into_tensor = counted_gather
            try:
                m = mesh_lib.make_hybrid_mesh(devices=devices)
                h = np.random.default_rng(5).integers(0, 256, (64, 8),
                                                      dtype=np.uint8)
                h[40] = h[3]                    # across the two shards
                h[10] = h[2]
                h[10, 5] ^= 16                  # a bit off, inside one
                ht = torch.from_numpy(h).to(dev)
                corpus = torch.zeros((4096, 8), dtype=torch.uint8, device=dev)
                corpus[0], corpus[1] = ht[50], ht[7]
                shards = mesh_lib.shard_batch(m, ht)
                axis = ("host", "data")
                # each device's slice of the mask lies on that device
                keep = torch.cat([k.to(dev) for k in
                                  mesh_lib.sharded_dedup_mask(
                                      m, shards, 4, axis=axis)])
                keep_c = torch.cat([k.to(dev) for k in
                                    mesh_lib.sharded_dedup_mask(
                                        m, shards, 4, axis=axis,
                                        corpus=corpus, corpus_count=2)])
                torch.cuda.synchronize()
                done["out"] = (ht, keep, keep_c, corpus, dict(m.shape))
            finally:
                dist.all_gather_into_tensor = real_gather
                dist.destroy_process_group()
        except Exception as e:  # reported by the caller
            done["error"] = repr(e)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        print(f"FAIL: the NCCL world of size 1 did not finish in "
              f"{timeout_s:.0f} s", flush=True)
        os._exit(1)
    if "error" in done:
        fail(f"the NCCL world of size 1 failed: {done['error']}")
    return done["out"] + (gathers,)


def mesh_phase(dev, S: int, all_cards: bool = False):
    """Phase 14's generator runs on make_mesh of two handles to `dev` or,
    with `all_cards`, on the mesh each generator builds by itself over the
    visible cards, each against one device's run -> (K1 launches, K2
    launches) of the mesh runs, each counted from 0 just before its run;
    each RPM run must launch the threefry kernel."""
    import torch
    from reasoning_image_generation_tpu_torch.models.multigraph import (
        renderer_cuda)
    from reasoning_image_generation_tpu_torch.models.multigraph.generator \
        import GeometryGenerator
    from reasoning_image_generation_tpu_torch.models.multigraph.scene import (
        build_scene_batch)
    from reasoning_image_generation_tpu_torch.models.rpm.generator import (
        RPMGenerator)
    from reasoning_image_generation_tpu_torch.ops import prng_cuda, raster_cuda
    from reasoning_image_generation_tpu_torch.parallel import mesh as mesh_lib
    from reasoning_image_generation_tpu_torch.utils.config import GenConfig

    n_cards = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    if all_cards:
        if n_cards < 2:
            fail(f"--all-cards needs more than one card, {n_cards} visible")
        # RPM: the most cards that divide its batch of 32; mg: all of them
        k = max(d for d in range(1, n_cards + 1) if 32 % d == 0)
        mesh2, where = None, f"{n_cards} cards, the generators' own mesh"
        want = {"rpm": tuple(cards[:k]), "mg": tuple(cards)}
        # one device: RPM pinned by use_mesh=False, mg on a mesh of one
        single = {"rpm": None, "mg": mesh_lib.make_mesh(devices=[dev])}
    else:
        mesh2 = mesh_lib.make_mesh(devices=[dev, dev])
        where = f"2 handles to {dev}"
        want = {"rpm": mesh2.devices, "mg": mesh2.devices}
        single = {"rpm": None, "mg": None}
    MESH_THRESHOLD = 12
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        rpm, launches, tf_launches = {}, {}, {}
        for name in ("single", "mesh"):
            use_mesh = not (all_cards and name == "single")
            gen = RPMGenerator(GenConfig(out_dir=f"{tmp}/rpm_{name}", seed=0,
                                         batch_size=32, use_mesh=use_mesh),
                               dev, mesh=mesh2 if name == "mesh" else None)
            got = gen.mesh.devices if gen.mesh is not None else None
            if got != (want["rpm"] if name == "mesh" else None):
                fail(f"RPM {name}: mesh {got}")
            if name == "single":
                groups = gen._sample_assignments(range(1000))
                # 平移: a full batch and a ragged 8; 直接叠加: a ragged 12
                ids = ([e[0] for e in groups["平移"][:40]]
                       + [e[0] for e in groups["直接叠加"][:12]])
            gen.warmup(ids)         # the graphs of every shard's card
            raster_cuda.LAUNCHES = prng_cuda.LAUNCHES = 0
            t0 = time.perf_counter()
            metas = gen.generate_ids(ids, dedup=True,
                                     dedup_threshold=MESH_THRESHOLD)
            walls[f"rpm {name}"] = time.perf_counter() - t0
            launches[name] = raster_cuda.LAUNCHES
            tf_launches[name] = prng_cuda.LAUNCHES
            gen.close()
            rpm[name] = stable(json.loads(json.dumps(metas).replace(
                f"{tmp}/rpm_{name}", "<out>")))
        rpm_mesh_launches = launches["mesh"]
        keep = {n: [not m.get("duplicate") for m in rpm[n]] for n in rpm}
        if len(ids) != 52 or any(m.get("error") for m in rpm["mesh"]):
            fail(f"mesh RPM: {len(ids)} ids, errors "
                 f"{[m for m in rpm['mesh'] if m.get('error')][:1]}")
        if keep["mesh"] != keep["single"]:
            fail("mesh RPM: the keep masks differ from one device's")
        if rpm["mesh"] != rpm["single"]:
            fail("mesh RPM: the metas differ from one device's")
        bad, n_files = tree_difference(f"{tmp}/rpm_single", f"{tmp}/rpm_mesh")
        if bad:
            fail(f"mesh RPM: the tree differs from one device's in {bad}")
        # three batches (平移 2, 直接叠加 1), each over its shards
        n_rpm = len(want["rpm"])
        if launches["single"] != 3 or rpm_mesh_launches != 3 * n_rpm:
            fail(f"mesh RPM: K1 launched {launches}, want 3 on one device "
                 f"and {3 * n_rpm} (once a shard) on the mesh")
        if min(tf_launches.values()) <= 0:
            fail(f"mesh RPM: the threefry kernel launched {tf_launches}")
        log(f"mesh RPM ({where}: {n_rpm} shards): {len(ids)} samples of "
            f"512x512 (平移 40, 直接叠加 12), batch 32, full export, dedup "
            f"threshold "
            f"{MESH_THRESHOLD}: {keep['mesh'].count(False)} duplicates, keep "
            f"masks and metas equal to one device's, {n_files} files equal "
            f"byte for byte; K1 launches {rpm_mesh_launches} (one device: "
            f"{launches['single']}); threefry launches {tf_launches['mesh']} "
            f"(one device: {tf_launches['single']})")

        scenes = [(k, MG_MODES[k % 4]) for k in range(28)]
        scenes[25] = scenes[18]     # in batch 2, across its shards
        scenes += scenes[:4]        # batch 2 against batch 1's corpus
        seeds, modes = (list(x) for x in zip(*scenes))
        mg, launches = {}, {}
        for name in ("single", "mesh"):
            root = f"{tmp}/mg_{name}"
            g = GeometryGenerator(dev, mesh=mesh2 if name == "mesh"
                                  else single["mg"])
            got = g.mesh.devices if g.mesh is not None else None
            if got != (want["mg"] if name == "mesh" else
                       single["mg"] and single["mg"].devices):
                fail(f"mg {name}: mesh {got}")
            # the render's graphs of every shard's card (batches of 16)
            g._render_imgs(build_scene_batch(seeds[:16], modes[:16])[0],
                           200, hashed=True)
            renderer_cuda.LAUNCHES = 0
            t0 = time.perf_counter()
            recs = g.generate_batches(
                seeds, modes, [f"{root}/images/{i}.png" for i in range(32)],
                [f"{root}/params/{i}.json" for i in range(32)], dpi=200,
                batch_size=16, dedup=True)
            g.close()           # QC lands in the records on the pool
            walls[f"mg {name}"] = time.perf_counter() - t0
            launches[name] = renderer_cuda.LAUNCHES
            mg[name] = stable(recs)
        mg_mesh_launches = launches["mesh"]
        dups = [i for i, r in enumerate(mg["mesh"]) if r.get("duplicate")]
        if mg["mesh"] != mg["single"]:
            fail("mesh mg: the records differ from the unsharded run's")
        if not {25, 28, 29, 30, 31} <= set(dups):
            fail(f"mesh mg: duplicates {dups}, want 25 and 28..31 among them")
        bad, n_files = tree_difference(f"{tmp}/mg_single", f"{tmp}/mg_mesh")
        if bad:
            fail(f"mesh mg: the tree differs from the unsharded one in {bad}")
        n_mg = len(want["mg"]) if 16 % len(want["mg"]) == 0 else 1
        if launches["single"] != 2 or mg_mesh_launches != 2 * n_mg:
            fail(f"mesh mg: K2 launched {launches}, want 2 unsharded and "
                 f"{2 * n_mg} (once a shard) on the mesh")
        log(f"mesh mg ({where}: {n_mg} shards): 32 scenes of {S}x{S}, "
            f"batch 16, four modes, dedup: duplicates {dups}, records, "
            f"params JSON and "
            f"{n_files} files equal to the unsharded run's, PNGs byte for "
            f"byte; K2 launches {mg_mesh_launches} (unsharded: "
            f"{launches['single']})")
    log("mesh wall (a reading, not a check): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items()))

    return rpm_mesh_launches, mg_mesh_launches


def phase_14(dev, S: int, all_cards: bool = False):
    """Both generators on a mesh (mesh_phase), then sharded_dedup_mask in
    an NCCL world of size 1 over the same devices -> the mesh runs' (K1,
    K2) launches."""
    import torch
    from reasoning_image_generation_tpu_torch.ops.phash import (
        dedup_keep_mask, dedup_keep_mask_vs_corpus)
    launches = mesh_phase(dev, S, all_cards)
    if all_cards:
        # no earlier phase warmed the cards: the first pass pays each
        # card's first use, so the walls are read from a second
        launches = mesh_phase(dev, S, all_cards)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if all_cards else [dev, dev])
    ht, nk, nk_c, corpus, shape, gathers = nccl_world_of_one(dev, devices)
    want = dedup_keep_mask(ht, 4)
    want_c = dedup_keep_mask_vs_corpus(corpus, 2, ht, 4)
    dropped = [i for i in range(64) if not bool(want[i])]
    dropped_c = [i for i in range(64) if not bool(want_c[i])]
    if shape != {"host": 1, "data": len(devices)} or len(gathers) != 2:
        fail(f"NCCL world of 1: mesh shape {shape}, {len(gathers)} gathers")
    if not (torch.equal(nk, want) and torch.equal(nk_c, want_c)):
        fail("NCCL world of 1: sharded_dedup_mask differs from "
             "dedup_keep_mask / dedup_keep_mask_vs_corpus")
    if dropped != [10, 40] or dropped_c != [7, 10, 40, 50]:
        fail(f"NCCL world of 1: dropped {dropped} and {dropped_c} with the "
             f"corpus")
    log(f"NCCL world of size 1, make_hybrid_mesh {shape} over "
        f"{[str(d) for d in devices]}: sharded_dedup_mask over (host, data) "
        f"through {len(gathers)} all_gather_into_tensor calls equals "
        f"dedup_keep_mask (drops {dropped}) and dedup_keep_mask_vs_corpus "
        f"(drops {dropped_c}); group destroyed")
    return launches


def step_cases():
    """The batch steps of phase 15, (name, leaf, GenConfig fields), all at
    512x512, batch 32: every rule leaf with full export, and 平移 also
    grid-only and with --sparse (rle4d)."""
    from reasoning_image_generation_tpu_torch.utils.config import RULE_LEAVES
    return [(leaf, leaf, {}) for leaf in RULE_LEAVES] + [
        ("平移 grid-only", "平移", {"grid_only": True}),
        ("平移 --sparse rle4d", "平移",
         {"sparse_transfer": True, "transfer_codec": "rle4d"})]


def step_inputs(dev, which: int):
    """Two key sets of 32 samples (ids 0..31 and 5000..5031) with their
    use_grid flags, on `dev`."""
    import torch
    from reasoning_image_generation_tpu_torch.models.rpm.pipeline import (
        sample_keys)
    i = torch.arange(32, device=dev)
    if which == 0:
        return sample_keys(0, list(range(32)), dev), i % 2 == 1
    return sample_keys(0, list(range(5000, 5032)), dev), i % 3 == 0


def tree_equal(a, b) -> bool:
    """Two trees hold the same leaves: structure, and for a tensor its
    shape, dtype and every value, for an io/transfer.Static its value."""
    import torch
    from reasoning_image_generation_tpu_torch.io.transfer import tree_flatten
    (la, da), (lb, db) = tree_flatten(a), tree_flatten(b)
    if da != db or len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.shape == y.shape
                    and x.dtype == y.dtype and bool(torch.equal(x, y))):
                return False
        elif type(x) is not type(y) or x.value != y.value:
            return False
    return True


def host_and_events_ms(fn, reps: int = 3):
    """Medians over `reps` calls of fn (warmed by the caller): the host
    wall from the call to a synchronised end, and the device time between
    two CUDA events around the call -> (host ms, events ms)."""
    import torch
    walls, evs = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        evs.append(a.elapsed_time(b))
    return sorted(walls)[reps // 2], sorted(evs)[reps // 2]


def device_time(prof):
    """A torch.profiler trace's device-side events -> (the kernels it
    kept, their ms, the ms of copies and memsets).  Only device events
    count: a CPU op's own device time repeats that of what it launched.
    The tracer may drop records: the counts are what it kept."""
    import torch
    n, k_us, c_us = 0, 0.0, 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if "Memcpy" in e.key or "Memset" in e.key:
            c_us += us
        else:
            n += e.count
            k_us += us
    return n, k_us / 1e3, c_us / 1e3


def profiled_kernels(fn):
    """``device_time`` of one call of fn (warmed by the caller)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return device_time(prof)


def count_syncs(fn):
    """The synchronising CUDA operations one call of fn makes, as
    torch.cuda.set_sync_debug_mode("warn") reports them -> (their count,
    the Python lines that made them, each with its count)."""
    import collections
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in seen
        if "synchroniz" in str(w.message)
        and "debug mode" not in str(w.message))    # (its own notice)
    return sum(where.values()), dict(where)


def eager_step_report(dev) -> dict:
    """Per case of step_cases(): the host syncs of one warm eager batch step
    and its host wall (median of 3) -> {name: (syncs, ms)}.  The step is
    ``LeafPipeline.step`` where the pipeline has one, else its
    ``__call__`` (a tree from before the compiled step, which ran eagerly)."""
    from reasoning_image_generation_tpu_torch.models.rpm.pipeline import (
        LeafPipeline)
    from reasoning_image_generation_tpu_torch.utils.config import GenConfig
    keys, ug = step_inputs(dev, 0)
    report = {}
    for name, leaf, extra in step_cases():
        pipe = LeafPipeline(leaf, GenConfig(batch_size=32, seed=0, **extra))
        step = getattr(pipe, "step", pipe)
        step(keys, ug)
        syncs, where = count_syncs(lambda: step(keys, ug))
        report[name] = (syncs, host_and_events_ms(lambda: step(keys, ug))[0])
        log(f"eager step {name}, batch 32 at 512x512: {syncs} host syncs "
            f"(set_sync_debug_mode 'warn'; by line: {where}), host wall "
            f"{report[name][1]:.3f} ms (median of 3)")
    return report


def pool_gib(dev):
    """(reserved, allocated) GiB of the segments of the card's one graph
    pool (utils/graphs.pool) in the allocator's snapshot, or None where
    the snapshot names no pools."""
    import torch
    from reasoning_image_generation_tpu_torch.utils import graphs
    want = tuple(graphs.pool(dev))
    reserved = allocated = 0
    named = False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None:
            continue
        named = True
        if seg.get("device") == dev.index and tuple(pid) == want:
            reserved += seg["total_size"]
            allocated += seg["allocated_size"]
    return (reserved / 2**30, allocated / 2**30) if named else None


def pool_text(now, start=None) -> str:
    if now is None:
        return "not measured (the snapshot names no pools)"
    text = f"{now[0]:.3f} GiB reserved, {now[1]:.3f} GiB of it allocated"
    if start is not None:
        text += (f" ({now[0] - start[0]:+.3f} GiB reserved since the phase "
                 f"began)")
    return text


def _tiers(tree, budgets) -> tuple:
    """`sizes` of a blob tree whose packed streams are cut to the tiers
    their own totals give (as after one batch of a run)."""
    from reasoning_image_generation_tpu_torch.io import transfer
    sizes = []
    for key in sorted(tree):
        val = tree[key]
        if key in budgets:
            host = tuple(transfer.host_array(v) for v in val)
            totals, F = transfer.stream_totals(host, budgets[key])
            sizes += transfer.compact_sizes(
                val, lambda n: totals[n] / F if n in totals else None)
        else:
            sizes += [None] * len(transfer.tree_leaves(val))
    return tuple(sizes)


def tail_cases(dev, outs, sparse_pipe):
    """The steps of the rest of a batch, each on two input sets: (name,
    StepGraphs, args A, args B, static).  RPM: the keys' fold_in, the
    --sparse compaction (rle4d, rle5d), the dedup step at batch 32 (B half
    duplicates of A), the blob of a full export and of --sparse rle4d
    (tiers from A); mg at 1600x1600, 16 scenes: render with pHash, pack
    rle4 and rle5, the dedup step at 16, the rle4 blob."""
    import torch
    from reasoning_image_generation_tpu_torch.io import transfer
    from reasoning_image_generation_tpu_torch.models.multigraph import (
        renderer_cuda)
    from reasoning_image_generation_tpu_torch.models.multigraph.generator \
        import _pack_step, _render_step
    from reasoning_image_generation_tpu_torch.models.multigraph.renderer \
        import render_scene_tensors
    from reasoning_image_generation_tpu_torch.models.multigraph.scene import (
        build_scene_batch)
    from reasoning_image_generation_tpu_torch.models.rpm.generator import (
        _compact_step)
    from reasoning_image_generation_tpu_torch.ops.phash import (
        dedup_append_step, phash)
    from reasoning_image_generation_tpu_torch.utils import prng
    from reasoning_image_generation_tpu_torch.utils.graphs import StepGraphs

    def n(v):
        return torch.full((), v, dtype=torch.int64, device=dev)

    def dedup_inputs(ha, hb, nb):
        """A: an empty corpus; B: the corpus after A, half of B's rows
        repeat A's, `nb` of them real."""
        c0 = torch.zeros((4096, 8), dtype=torch.uint8, device=dev)
        _k, c1, n1 = dedup_append_step(c0, n(0), ha, n(len(ha)), 4)
        h = len(ha) // 2
        return (c0, n(0), ha, n(len(ha))), (c1, n1, torch.cat([ha[:h],
                                                                hb[:h]]),
                                             n(nb))

    base = prng.key(0, dev)
    full_a, full_b = outs["平移"]
    sp_a, sp_b = outs["平移 --sparse rle4d"]
    keep32 = (torch.arange(32, device=dev) % 5 != 0)

    def packed(o):
        return {k: v for k, v in o.items() if k.endswith("_packed")}

    def sparse_tree(o):
        t = {k: v for k, v in o.items() if k not in (
            "state_imgs", "option_imgs", "grid_img")}
        t.update(_compact_step(packed(o), codec="rle4"))
        t["_keep"] = keep32
        return t

    budgets = {"grid_img_packed": sparse_pipe.grid_budget,
               "state_imgs_packed": sparse_pipe.frame_budget,
               "option_imgs_packed": sparse_pipe.frame_budget}
    sp_tree = [sparse_tree(o) for o in (sp_a, sp_b)]
    full_tree = [dict(o, _keep=keep32) for o in (full_a, full_b)]
    scenes = [{k: torch.as_tensor(v) for k, v in b.items()} for b in (
        mg_generated_batch(16), build_scene_batch(
            list(range(300, 316)), [MG_MODES[i % 4] for i in range(16)])[0])]
    imgs = [render_scene_tensors({k: v.to(dev) for k, v in sc.items()}, 200)
            for sc in scenes]
    hashes = [phash(i) for i in imgs]
    budget = 32768
    keep16 = (torch.arange(16, device=dev) % 3 != 0)
    mg_tree = [(_pack_step(i, budget=budget, codec="rle4"), {"keep": keep16})
               for i in imgs]
    mg_sizes = _tiers({"p": mg_tree[0][0]}, {"p": budget})
    mg_sizes += (None,) * (len(transfer.tree_leaves(mg_tree[0]))
                           - len(mg_sizes))
    d32 = dedup_inputs(full_a["grid_phash"], full_b["grid_phash"], 20)
    d16 = dedup_inputs(hashes[0], hashes[1], 16)
    blob = StepGraphs(transfer.blob_step)
    compact = StepGraphs(_compact_step)
    dedup = StepGraphs(dedup_append_step)
    pack = StepGraphs(_pack_step)
    return [
        ("RPM keys (fold_in), batch 32", StepGraphs(prng.fold_in),
         (base, torch.arange(32, device=dev)),
         (base, torch.arange(5000, 5032, device=dev)), {}),
        ("RPM compaction rle4d", compact, (packed(sp_a),), (packed(sp_b),),
         {"codec": "rle4"}),
        ("RPM compaction rle5d", compact, (packed(sp_a),), (packed(sp_b),),
         {"codec": "rle5"}),
        ("dedup step, batch 32", dedup, *d32, {"threshold": 4}),
        ("RPM blob, full export", blob, (full_tree[0],), (full_tree[1],),
         {"sizes": (None,) * len(transfer.tree_leaves(full_tree[0])),
          "flat": True}),
        ("RPM blob, --sparse rle4d at tiers", blob, (sp_tree[0],),
         (sp_tree[1],), {"sizes": _tiers(sp_tree[0], budgets), "flat": True}),
        ("mg render + pHash, 16 scenes",
         StepGraphs(_render_step, counters=(renderer_cuda,)), (scenes[0],),
         (scenes[1],), {"dpi": 200, "hashed": True}),
        ("mg pack rle4", pack, (imgs[0],), (imgs[1],),
         {"budget": budget, "codec": "rle4"}),
        ("mg pack rle5", pack, (imgs[0],), (imgs[1],),
         {"budget": budget, "codec": "rle5"}),
        ("dedup step, batch 16", dedup, *d16, {"threshold": 4}),
        ("mg blob rle4 at tiers", blob, (mg_tree[0],), (mg_tree[1],),
         {"sizes": mg_sizes, "flat": True}),
    ]


def tail_phase(dev, outs, pipes, eager_ab, in_a, in_b):
    """Phase 15's second part: each of tail_cases() captured and replayed
    against its eager step on inputs A and B (A's outputs unchanged by B's
    replay), timed eager against replayed; then every graph of the phase,
    the leaf steps' included, replayed in the reverse of capture order on
    B, and each again on A, B, A, every output equal to its eager step's.
    -> the graphs in capture order."""
    import torch
    from reasoning_image_generation_tpu_torch.io.transfer import (
        tree_flatten, tree_unflatten)
    from reasoning_image_generation_tpu_torch.utils import graphs

    def on_dev(args):
        leaves, tdef = tree_flatten(args)
        return tree_unflatten(tdef, [a.to(dev) for a in leaves])

    sparse_pipe = pipes[[n for n, _l, _e in step_cases()].index(
        "平移 --sparse rle4d")]
    t0 = time.perf_counter()
    cases = tail_cases(dev, outs, sparse_pipe)
    log(f"graphs: the tail steps' inputs and eager outputs made in "
        f"{time.perf_counter() - t0:.1f} s")
    order = [(name, pipe._graphs, in_a, in_b, {}, eager_ab[name])
             for (name, _l, _e), pipe in zip(step_cases(), pipes)]
    bad = []
    for name, sg, a, b, static in cases:
        want = (sg.fn(*on_dev(a), **static), sg.fn(*on_dev(b), **static))
        caps = graphs.CAPTURES
        t0 = time.perf_counter()
        ra = sg(*a, device=dev, **static)
        torch.cuda.synchronize()
        t_capture = time.perf_counter() - t0
        leaves, tdef = tree_flatten(ra)
        snap = tree_unflatten(tdef, [t.clone() if isinstance(t, torch.Tensor)
                                     else t for t in leaves])
        rb = sg(*b, device=dev, **static)
        eq = (tree_equal(ra, want[0]), tree_equal(rb, want[1]),
              tree_equal(ra, snap), not tree_equal(ra, rb))
        if not all(eq) or graphs.CAPTURES != caps + 1:
            bad.append(name)
        eager = host_and_events_ms(lambda: sg.fn(*on_dev(a), **static))
        replay = host_and_events_ms(lambda: sg(*a, device=dev, **static))
        n_eager = profiled_kernels(lambda: sg.fn(*on_dev(a), **static))[0]
        n_graph = profiled_kernels(lambda: sg(*a, device=dev, **static))[0]
        log(f"graph {name}: capture call {t_capture * 1e3:.3f} ms "
            f"({graphs.CAPTURES - caps} capture); replay == eager on A and "
            f"B {eq[0]} / {eq[1]}, A unchanged by B's replay {eq[2]}, A and "
            f"B differ {eq[3]}; eager {eager[0]:.3f} ms host, "
            f"{eager[1]:.3f} ms events; replay (inputs in, outputs cloned "
            f"out) {replay[0]:.3f} ms host, {replay[1]:.3f} ms events "
            f"(medians of 3); kernels traced eager {n_eager}, in a replay "
            f"{n_graph}")
        order.append((name, sg, a, b, static, want))
    if bad:
        fail(f"a graph of the batch's tail disagrees with its eager step: "
             f"{bad}")
    # out of capture order: all in reverse on B, then each on A, B, A
    runs = [(o, 1) for o in reversed(order)]
    runs += [(o, i) for o in order for i in (0, 1, 0)]
    for (name, sg, a, b, static, want), i in runs:
        got = sg(*((a, b)[i]), device=dev, **static)
        if not tree_equal(got, want[i]):
            bad.append(f"{name} on {'AB'[i]}")
    if bad:
        fail(f"replays out of capture order differ from the eager steps: "
             f"{bad}")
    log(f"graphs: {len(order)} graphs ({len(pipes)} leaf steps, "
        f"{len(cases)} of the batch's tail) replayed in the reverse of "
        f"capture order on B, then each on A, B, A: {len(runs)} replays, "
        f"every output equal to its eager step's")
    return order


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchCooperativeKernel")
# ops whose kernels are copies: a replay's output clones, input loads
COPY_OPS = ("aten::copy_", "aten::clone", "aten::_to_copy")


def launch_counts(fn):
    """The CUDA runtime calls of one call of fn under torch.profiler ->
    ({'kernels': kernels launched outside graphs, 'graphs':
    cudaGraphLaunch, 'copies': cudaMemcpy*, 'memsets': cudaMemset*},
    {the op that launched each eager kernel: count})."""
    import collections
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {"kernels": 0, "graphs": 0, "copies": 0, "memsets": 0}
    by_op = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if e.name.startswith(LAUNCH_CALLS):
            counts["kernels"] += 1
            p = e.cpu_parent
            while p is not None and p.cpu_parent is not None \
                    and not p.name.startswith("aten::"):
                p = p.cpu_parent
            by_op[p.name if p is not None else "?"] += 1
        elif e.name.startswith("cudaGraphLaunch"):
            counts["graphs"] += 1
        elif e.name.startswith("cudaMemcpy"):
            counts["copies"] += 1
        elif e.name.startswith("cudaMemset"):
            counts["memsets"] += 1
    return counts, dict(by_op)


def dispatch_configs(dev, tmp):
    """The generator configurations whose warm dispatch phase 15 and
    --eager-step read, each armed as its run arms it (the dedup's
    corpus; RPM's tiers frozen from its first batch): [(name, dispatch,
    finish, generator)]; dispatch() starts the next batch, finish(st)
    exports it."""
    from reasoning_image_generation_tpu_torch.models.multigraph.generator \
        import GeometryGenerator
    from reasoning_image_generation_tpu_torch.models.rpm.generator import (
        RPMGenerator)
    from reasoning_image_generation_tpu_torch.ops.phash import CorpusDedup
    from reasoning_image_generation_tpu_torch.utils.config import GenConfig
    configs = []
    sparse = {"sparse_transfer": True, "transfer_codec": "rle4d"}
    for name, extra in (("RPM 平移 full export --dedup", {}),
                        ("RPM 平移 --sparse rle4d --dedup", sparse)):
        gen = RPMGenerator(GenConfig(out_dir=os.path.join(tmp, str(len(
            configs))), seed=0, batch_size=32, **extra), dev)
        entries = gen._sample_assignments(range(4000))["平移"]
        gen._corpus = CorpusDedup(len(entries), gen.device, threshold=4,
                                  mesh=gen.mesh)
        pipe, metas = gen._pipeline("平移"), {}
        chunks = itertools.cycle([entries[i:i + 32]
                                  for i in range(0, 32 * 12, 32)])

        def dispatch(gen=gen, pipe=pipe, chunks=chunks):
            return gen._dispatch("平移", pipe, next(chunks))

        def finish(st, gen=gen, metas=metas):
            gen._flush(st, metas)

        finish(dispatch())
        gen._tier_stats = dict(gen._run_stats)   # as a next run freezes them
        configs.append((name, dispatch, finish, gen))
    g = GeometryGenerator(dev)
    g._corpus = CorpusDedup(16 * 16, g.device, threshold=4, mesh=g.mesh)
    # the batches cycle over 64 scenes, so the run statistics (the blob's
    # tiers, the pack budget: keys of the mg graphs) stop moving after one
    # pass; the repeats are duplicates, the same device work
    starts = itertools.cycle(range(0, 64, 16))

    def mg_dispatch():
        s = next(starts)
        ids = list(range(s, s + 16))
        return g._dispatch_batch(ids, [MG_MODES[i % 4] for i in ids], None,
                                 None, 200)

    configs.append(("mg rle4, dedup (generate_batches(dedup=True))",
                    mg_dispatch, g._finish_batch, g))
    return configs


def dispatch_report(dev, strict: bool) -> None:
    """Per configuration of dispatch_configs(), once its batches run warm
    (no capture in the batch read): the host syncs of one dispatch
    (set_sync_debug_mode 'warn'), its launches outside graph replays
    (torch.profiler) and its host wall (median of 3).  With `strict` (a
    tree whose whole batch replays) a warm dispatch runs under
    set_sync_debug_mode("error"), and no op but a copy may launch a kernel
    outside the graphs (the outputs' clones of strided views)."""
    import torch
    from reasoning_image_generation_tpu_torch.utils import graphs

    def captures():
        return getattr(graphs, "CAPTURES", 0)

    with tempfile.TemporaryDirectory() as tmp:
        for name, dispatch, finish, gen in dispatch_configs(dev, tmp):
            for _ in range(6):          # until a batch captures nothing
                caps = captures()
                finish(dispatch())
                if captures() == caps:
                    break
            else:
                fail(f"{name}: every batch captured a graph")
            if strict:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    st = dispatch()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                finish(st)
            pend = []
            syncs, where = count_syncs(lambda: pend.append(dispatch()))
            finish(pend.pop())
            counts, by_op = launch_counts(lambda: pend.append(dispatch()))
            finish(pend.pop())
            walls, skipped = [], 0
            while len(walls) < 3 and skipped < 6:
                caps = captures()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = dispatch()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                finish(st)
                if captures() == caps:
                    walls.append(wall)
                else:                   # a key moved: not a warm batch
                    skipped += 1
            gen.close()
            if not walls:
                fail(f"{name}: every batch captured a graph")
            log(f"warm dispatch, {name}: host syncs {syncs} (by line: "
                f"{where}); outside graph replays {counts['kernels']} kernel "
                f"launches (by op: {by_op}), {counts['copies']} copies, "
                f"{counts['memsets']} memsets; graph replays "
                f"{counts['graphs']}; host wall to a synchronised end "
                f"{sorted(walls)[len(walls) // 2]:.3f} ms (median of "
                f"{len(walls)}; {skipped} batches that captured left out)"
                + ("; passes set_sync_debug_mode('error')" if strict else ""))
            if strict and syncs:
                fail(f"{name}: a warm dispatch synchronised {syncs} times")
            named = {op for op in by_op if op.startswith("aten::")}
            if strict and not named <= set(COPY_OPS):
                fail(f"{name}: a warm dispatch launched kernels outside its "
                     f"graphs from {sorted(named - set(COPY_OPS))}")


def graph_phase(dev, S: int) -> None:
    """Phase 15, the compiled batch step: every case of step_cases() replayed
    as a CUDA graph against its eager step on two key sets, an eager step
    under set_sync_debug_mode("error"), the mg render's replay against its
    eager render, the readings (eager and replay times, kernels per
    graph, memory) and the device's busy share over an RPM run."""
    import gc
    import torch
    from reasoning_image_generation_tpu_torch.io.transfer import (
        tree_flatten, tree_unflatten)
    from reasoning_image_generation_tpu_torch.models.multigraph import (
        renderer as mg_renderer, renderer_cuda)
    from reasoning_image_generation_tpu_torch.models.multigraph.generator \
        import GeometryGenerator
    from reasoning_image_generation_tpu_torch.models.multigraph.scene import (
        build_scene_batch)
    from reasoning_image_generation_tpu_torch.models.rpm.generator import (
        RPMGenerator)
    from reasoning_image_generation_tpu_torch.models.rpm.pipeline import (
        LeafPipeline)
    from reasoning_image_generation_tpu_torch.ops import raster_cuda
    from reasoning_image_generation_tpu_torch.utils import graphs
    from reasoning_image_generation_tpu_torch.utils.config import GenConfig

    (ka, ua), (kb, ub) = step_inputs(dev, 0), step_inputs(dev, 1)
    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    log(f"graphs: memory reserved before the captures "
        f"{reserved0 / 2**30:.3f} GiB")
    pool_start = pool_gib(dev)
    log("graphs: the shared pool before this phase's captures (graphs of "
        "earlier phases that are still alive): " + pool_text(pool_start))
    pipes, bad = [], []
    eager_ab, outs = {}, {}
    for name, leaf, extra in step_cases():
        pipe = LeafPipeline(leaf, GenConfig(batch_size=32, seed=0, **extra))
        pipes.append(pipe)
        raster_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        ra = pipe(ka, ua)                    # warm runs, capture, replay
        torch.cuda.synchronize()
        t_capture = time.perf_counter() - t0
        at_capture = raster_cuda.LAUNCHES
        leaves, tdef = tree_flatten(ra)
        snap = tree_unflatten(tdef, [t.clone() for t in leaves])
        rb = pipe(kb, ub)                    # a replay on other inputs
        torch.cuda.synchronize()
        replays = raster_cuda.LAUNCHES - at_capture
        # a warm eager step that synchronises with the host raises here
        torch.cuda.set_sync_debug_mode("error")
        try:
            sa = pipe.step(ka, ua)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sb = pipe.step(kb, ub)
        eq = (tree_equal(ra, sa), tree_equal(rb, sb), tree_equal(ra, snap),
              not torch.equal(ra["grid_img"], rb["grid_img"]))
        eager_ab[name] = (sa, sb)
        if name in ("平移", "平移 --sparse rle4d"):
            outs[name] = (ra, rb)
        if not all(eq) or at_capture != graphs.WARM_RUNS + 1 or replays != 1:
            bad.append(name)
        syncs = count_syncs(lambda: pipe(ka, ua))[0]
        eager = host_and_events_ms(lambda: pipe.step(ka, ua))
        replay = host_and_events_ms(lambda: pipe(ka, ua))
        n_graph, graph_dev, copy_dev = profiled_kernels(lambda: pipe(ka, ua))
        reserved = torch.cuda.memory_reserved(dev)
        log(f"graph {name}, batch 32 at 512x512: capture call "
            f"{t_capture:.3f} s (K1 launches {at_capture}: "
            f"{graphs.WARM_RUNS} warm, 1 replay; the next replay "
            f"{replays}); replay == step on key sets A and B {eq[0]} / "
            f"{eq[1]}, A's outputs unchanged by B's replay {eq[2]}, A and B "
            f"differ {eq[3]}; a warm eager step passes "
            f"set_sync_debug_mode('error'), host syncs of a replay {syncs}; "
            f"eager step "
            f"{eager[0]:.3f} ms host, {eager[1]:.3f} ms events; replay "
            f"(inputs in, outputs cloned out) {replay[0]:.3f} ms host, "
            f"{replay[1]:.3f} ms events (medians of 3); a replay under "
            f"the profiler: {n_graph} kernels traced, {graph_dev:.3f} ms "
            f"device, copies {copy_dev:.3f} ms; memory reserved "
            f"{reserved / 2**30:.3f} GiB; {time.perf_counter() - t0:.1f} s "
            f"for this step's checks")
        if syncs:
            bad.append(f"{name}: {syncs} syncs in a replay")
        del ra, rb, snap, sa, sb
    if bad:
        fail(f"the compiled step failed on {bad}")
    pool_leaf = pool_gib(dev)
    log(f"graphs: the {len(pipes)} step graphs above, in the card's one "
        f"shared pool: " + pool_text(pool_leaf, pool_start))

    # the rest of each batch: its graphs against their eager steps, then
    # the replays out of capture order
    order = tail_phase(dev, outs, pipes, eager_ab, (ka, ua), (kb, ub))
    log(f"graphs: all {len(order)} graphs of this phase in the shared pool: "
        + pool_text(pool_gib(dev), pool_start))
    del outs, eager_ab, order
    dispatch_report(dev, strict=True)
    # the device's busy share over an RPM full-export run of 64 samples
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        gen = RPMGenerator(GenConfig(out_dir=tmp, seed=0, batch_size=32), dev)
        # the full-export pipelines above, their graphs captured
        gen._pipelines.update({p.leaf: p for p, (_n, _l, extra) in
                               zip(pipes, step_cases()) if not extra})
        ids = list(range(64))
        t0 = time.perf_counter()
        gen.generate_ids(ids)
        wall = time.perf_counter() - t0
        with torch.profiler.profile(activities=acts) as prof:
            gen.generate_ids(ids)
            torch.cuda.synchronize()
        gen.close()
    del gen                               # it holds the pipelines too
    _n, k_ms, c_ms = device_time(prof)
    log(f"RPM generator, 64 samples at 512x512, batch 32, full export "
        f"(9 leaves, padded batches, every graph captured): "
        f"wall {wall:.3f} s unprofiled; device busy under the profiler "
        f"{k_ms + c_ms:.3f} ms ({100 * (k_ms + c_ms) / 1e3 / wall:.2f}% of "
        f"the unprofiled wall): kernels {k_ms:.3f} ms, copies and memsets "
        f"{c_ms:.3f} ms")
    log(f"graphs: {len(pipes)} captured, memory reserved "
        f"{torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB, max allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    del pipes
    gc.collect()
    torch.cuda.empty_cache()
    log(f"graphs: memory reserved once the pipelines are gone "
        f"{torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB")

    # the mg render at 1600x1600, 16 scenes: the generator's replay
    g = GeometryGenerator(dev)
    mg_a = mg_generated_batch(16)
    mg_b = build_scene_batch(list(range(300, 316)),
                             [MG_MODES[i % 4] for i in range(16)])[0]
    renderer_cuda.LAUNCHES = 0
    ia = g._render_imgs(mg_a, 200)[0]
    torch.cuda.synchronize()
    at_capture = renderer_cuda.LAUNCHES
    snap = ia.clone()
    ib = g._render_imgs(mg_b, 200)[0]
    torch.cuda.synchronize()
    eq = (torch.equal(ia, mg_renderer.render_scene_batch(mg_a, 200, dev)),
          torch.equal(ib, mg_renderer.render_scene_batch(mg_b, 200, dev)),
          torch.equal(ia, snap), not torch.equal(ia, ib))
    eager = host_and_events_ms(
        lambda: mg_renderer.render_scene_batch(mg_a, 200, dev))
    replay = host_and_events_ms(lambda: g._render_imgs(mg_a, 200))
    n_graph = profiled_kernels(lambda: g._render_imgs(mg_a, 200))[0]
    g.close()
    log(f"graph mg render, 16 scenes at {S}x{S}: K2 launches at the capture "
        f"call {at_capture}; replay == eager on scenes A and B {eq[0]} / "
        f"{eq[1]}, A unchanged by B's replay {eq[2]}, A and B differ "
        f"{eq[3]}; eager (upload, prep, K2) {eager[0]:.3f} ms host, "
        f"{eager[1]:.3f} ms events; replay (pinned upload, outputs cloned "
        f"out) {replay[0]:.3f} ms host, {replay[1]:.3f} ms events (medians "
        f"of 3); a replay under the profiler: {n_graph} kernels traced")
    if not all(eq) or at_capture != graphs.WARM_RUNS + 1:
        fail("the mg render's graph disagrees with the eager render")


def threefry_phase(dev) -> None:
    """Phase 3a: the threefry kernel (csrc/threefry.cu, ops/prng_cuda.py),
    then the 9 rule leaves through it; see the module's docstring."""
    import torch
    from reasoning_image_generation_tpu_torch.io.transfer import tree_flatten
    from reasoning_image_generation_tpu_torch.models.rpm.pipeline import (
        LeafPipeline, sample_keys)
    from reasoning_image_generation_tpu_torch.ops import prng_cuda
    from reasoning_image_generation_tpu_torch.utils.config import (
        RULE_LEAVES, GenConfig)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", "tests/test_torch_prng_native.py",
         "-k", "card"], cwd=here, capture_output=True, text=True,
        timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    log(f"threefry card tests: {tail[0]} ({time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0 or "skipped" in tail[0]:
        fail(f"the threefry card tests failed:\n{proc.stdout[-6000:]}"
             f"{proc.stderr[-2000:]}")
    cpu = torch.device("cpu")
    B, rows = 32, [0, 31]       # rows 0 and 31 of a batch of 32 on the CPU
    ug = torch.arange(B) % 2 == 0
    for leaf in RULE_LEAVES:
        # the CPU's step of a batch of 2 on two rows' keys: a CPU step of
        # 32 at 512x512 takes minutes a leaf, and a row's outputs depend
        # on its own key alone
        want = LeafPipeline(leaf, GenConfig(batch_size=2)).step(
            sample_keys(0, rows, cpu), ug[rows])

        def check(how, out, pick=None):
            got, got_def = tree_flatten(out)
            ref, ref_def = tree_flatten(
                {k: v for k, v in want.items() if k in out})
            bad = [i for i, (g, w) in enumerate(zip(got, ref))
                   if not torch.equal(g.cpu() if pick is None
                                      else g[pick].cpu(), w)]
            if got_def != ref_def or bad:
                fail(f"threefry: {leaf} {how} on the card differs from the "
                     f"CPU in outputs {bad}")

        # every output of the batch of 2, eager and replayed
        pipe = LeafPipeline(leaf, GenConfig(batch_size=2))
        args = (sample_keys(0, rows, dev), ug[rows].to(dev))
        check("eager", pipe.step(*args))
        check("replay", pipe(*args))
        # the cell's shape: a batch of 32 at 512x512, grid-only
        pipe = LeafPipeline(leaf, GenConfig(batch_size=B, grid_only=True))
        args = (sample_keys(0, list(range(B)), dev), ug.to(dev))
        before = prng_cuda.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(*args)           # 2 warm runs, the capture, a replay
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        launches = prng_cuda.LAUNCHES - before
        check("batch 32 replay", out, rows)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            pipe(*args)
            torch.cuda.synchronize()
        kernels, kern_ms, copy_ms = device_time(prof)
        tf = [(e.count, getattr(e, "self_device_time_total", 0))
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "threefry_kernel" in e.key]
        check("batch 32 eager", pipe.step(*args), rows)
        log(f"threefry: {leaf} equal on the card and the CPU (batch 2 and "
            f"rows {rows} of batch 32 grid-only, eager and replayed); batch "
            f"32: {launches // 3} threefry "
            f"launches a step, capture call {capture_s:.3f} s, a replay "
            f"{kernels} kernels, {kern_ms:.3f} ms kernels ("
            f"{sum(c for c, _ in tf)} threefry, "
            f"{sum(u for _, u in tf) / 1e3:.3f} ms), {copy_ms:.3f} ms copies")
        if launches % 3 or launches == 0:
            fail(f"threefry: {leaf} counted {launches} launches over 2 warm "
                 f"runs and a replay")


def check_no_jax():
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "reasoning_image_generation_tpu"))
    if loaded:
        fail(f"the JAX package or JAX was imported: {loaded[:5]}")
    log("JAX package and JAX never imported")


def pack_as_generator(pipe, out: dict, pre, codec: str) -> dict:
    """The packed streams the RPM generator ships for one batch: the
    pipeline's pack, then the compaction of the rle3..rle5d family."""
    import copy
    import dataclasses
    from reasoning_image_generation_tpu_torch.ops import rle
    o = dict(out)
    pipe = copy.copy(pipe)
    pipe.cfg = dataclasses.replace(pipe.cfg, transfer_codec=codec)
    pipe._pack(o, pre)
    packed = {k: v for k, v in o.items() if k.endswith("_packed")}
    if codec in COMPACT:
        base = codec.rstrip("d")
        packed = {k: (getattr(rle, f"compact_{base}d")(*v) if len(v) == 4
                      else getattr(rle, f"compact_{base}")(*v))
                  for k, v in packed.items()}
    return packed


class TimedCopies:
    """Every blob copy the generators start, with its bytes and its device
    time (CUDA events around the pinned non-blocking copy): installs a
    subclass of io/transfer.HostCopy while in use."""

    def __enter__(self):
        import torch
        from reasoning_image_generation_tpu_torch.io import transfer
        self.log, self._orig, log = [], transfer.HostCopy, None
        log = self.log
        base = self._orig

        class Timed(base):
            # HostCopy's card path with timing events tight around the
            # copy (not around the pinned allocation before it)
            def __init__(self, blob):
                self._host = torch.empty(blob.shape, dtype=blob.dtype,
                                         pin_memory=True)
                a = torch.cuda.Event(enable_timing=True)
                self._event = torch.cuda.Event(enable_timing=True)
                a.record()
                self._host.copy_(blob, non_blocking=True)
                self._event.record()
                log.append((blob.numel(), a, self._event))

        transfer.HostCopy = Timed
        return self

    def __exit__(self, *exc):
        from reasoning_image_generation_tpu_torch.io import transfer
        transfer.HostCopy = self._orig

    def rows(self):
        """[(bytes, copy ms)] of the copies so far, all completed."""
        out = []
        for n, a, b in self.log:
            b.synchronize()
            out.append((n, a.elapsed_time(b)))
        return out


def main():
    import numpy as np
    import torch
    if sys.argv[1:] not in ([], ["--all-cards"], ["--eager-step"]):
        fail(f"usage: {sys.argv[0]} [--all-cards | --eager-step]")
    all_cards = sys.argv[1:] == ["--all-cards"]
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # the transfer tiers' statistics of this run only: none are read from,
    # or left in, the user's directory
    stats_dir = tempfile.TemporaryDirectory()
    os.environ["RIG_TORCH_CACHE"] = stats_dir.name

    from reasoning_image_generation_tpu_torch import cli
    from reasoning_image_generation_tpu_torch.device import resolve_device
    from reasoning_image_generation_tpu_torch.io import png
    from reasoning_image_generation_tpu_torch.io.png_read import read_png
    from reasoning_image_generation_tpu_torch.models.multigraph import (
        cli as mg_cli, renderer as mg_renderer, renderer_cuda)
    from reasoning_image_generation_tpu_torch.models.multigraph.generator import (
        GeometryGenerator)
    from reasoning_image_generation_tpu_torch.models.rpm.generator import (
        RPMGenerator)
    from reasoning_image_generation_tpu_torch.models.rpm.pipeline import (
        LeafPipeline, make_sample_fn, sample_keys)
    from reasoning_image_generation_tpu_torch.models.rpm.shapes import Shape
    from reasoning_image_generation_tpu_torch.ops import (
        overlay, prng_cuda, raster, raster_cuda)
    from reasoning_image_generation_tpu_torch.utils import graphs
    from reasoning_image_generation_tpu_torch.utils.config import (
        RULE_LEAVES, GenConfig)
    from reasoning_image_generation_tpu_torch.utils.state import (
        ElementState)

    t_start = time.perf_counter()

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

    # ---- 2. build: every native source at once ----
    def timed_build(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        futs = {name: ex.submit(timed_build, fn) for name, fn in (
            ("raster.cu", raster_cuda.build),
            ("mg_render.cu", renderer_cuda.build),
            ("threefry.cu", prng_cuda.build),
            ("fastpng.c", png.build))}
        builds = {name: f.result() for name, f in futs.items()}
    from reasoning_image_generation_tpu_torch.ops import cuda_build
    registers = {}
    for name, dt in builds.items():
        log(f"build {name}: {dt:.2f} s")
        for line in cuda_build.compiler_output.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
            if "Used" in line and "registers" in line:
                registers[name] = int(line.split("Used")[1].split()[0])
    log(f"build wall: {time.perf_counter() - t0:.2f} s; PNG encoder: "
        f"{png.encoder()}")
    if png.encoder() != "fastpng":
        fail("csrc/fastpng.c did not build: the PNG export fell back to zlib")

    if sys.argv[1:] == ["--eager-step"]:
        # the host syncs and wall of each eager batch step, and each
        # generator's warm dispatch, nothing else
        eager_step_report(dev)
        dispatch_report(dev, strict=False)
        check_no_jax()
        stats_dir.cleanup()
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

    if all_cards:
        # phase 14 over every visible card, then 16
        S = mg_renderer.data_to_pixel_transform(200)[3]
        phase_14(dev, S, all_cards=True)
        check_no_jax()
        stats_dir.cleanup()
        log(f"total: {time.perf_counter() - t_start:.1f} s")
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

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

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def device_ms(fn, reps, kernel):
        """The kernel's own device time per launch, from torch.profiler's
        key_averages by kernel name, over `reps` calls of the wrapper.  The
        tracer may drop records, so the mean is over those it kept; a trace
        that kept under half of them is taken again, at most twice, and the
        fullest trace counts."""
        best = (0, 0.0)
        for attempt in range(3):
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            us, count = 0.0, 0
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA and \
                        kernel in e.key:
                    us += getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0))
                    count += e.count
            log(f"profiler: {count} of {reps} launches of {kernel} traced"
                + (f" (attempt {attempt + 1})" if attempt else ""))
            best = max(best, (count, us))
            if 2 * count >= reps:
                break
        count, us = best
        if not 0 < count <= reps:
            fail(f"the profiler saw {count} launches of {kernel} in {reps}")
        return us / 1e3 / count

    # ---- 3. K1 against its plain version ----
    W = H = 512

    cases = k1_hand_cases()
    cfg = GenConfig()
    for leaf, B in (("平移", 32), ("直接叠加", 32)):
        fr = make_sample_fn(leaf, cfg)(sample_keys(7, list(range(B)), dev),
                                       torch.arange(B, device=dev) % 2 == 1)
        flat = fr["rframes"].map(lambda a: a.flatten(0, 1))
        cases.insert(1 if leaf == "平移" else 2,
                     (f"sampled {leaf} frames", flat, 512, 512))

    k1_err = 0
    for name, st, cw, ch in cases:
        st = st.map(lambda a: a.to(dev))
        n = st.kind.shape[0]
        for grid in (False, True):
            ug = torch.full((n,), grid, device=dev)
            got = raster_cuda.render_frames(st, cw, ch, ug)
            ref = raster.render_frames(st, cw, ch, ug)
            torch.cuda.synchronize()
            if got.shape != (n, ch, cw, 3) or ref.shape != got.shape:
                fail(f"K1 shape {tuple(got.shape)} on {name}")
            err = int((got.int() - ref.int()).abs().max())
            k1_err = max(k1_err, err)
            log(f"K1 vs plain: {name} ({n} frames {cw}x{ch}, "
                f"grid={grid}): maxdiff {err}")
    if k1_err != 0:
        fail(f"K1 disagrees with its plain version (maxdiff {k1_err})")

    # timing at the main path's shape: 256 frames of 512x512
    flat = cases[1][1].map(lambda a: a.to(dev))
    ug = torch.arange(flat.kind.shape[0], device=dev) % 2 == 1
    meta, vx, vy = raster.prepare_render_data(flat, W, H, ug)
    k1_plain = lambda: raster.render_prepared(meta, vx, vy, ug, W, H, 3)
    k1_kern = lambda: raster_cuda.render_prepared_cuda(meta, vx, vy, ug, W, H)
    k1_t = [timed(k1_plain, 3), timed(k1_kern, 20), timed(k1_kern, 20),
            timed(k1_plain, 3)]
    k1_dev = device_ms(k1_kern, 20, "raster_kernel")
    k1_bytes, k1_ops = k1_work(meta, vx, vy, W, H)
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k1_old_bytes, k1_old_ops = k1_work_tiled(meta, W, H)
    log(f"K1 time per {meta.shape[0]} frames of {W}x{H} (plain, kernel, "
        f"kernel, plain): {k1_t[0]:.3f}, {k1_t[1]:.3f}, {k1_t[2]:.3f}, "
        f"{k1_t[3]:.3f} ms; kernel's own device time {k1_dev:.4f} ms; bound "
        f"{k1_bound:.4f} ms ({k1_by}: {k1_bytes / 1e6:.1f} MB, "
        f"{k1_ops / 1e9:.3f} GFLOP), {100 * k1_bound / k1_dev:.1f}% of it "
        f"reached; the earlier per-tile count gave "
        f"{bound(k1_old_bytes, k1_old_ops)[0]:.4f} ms "
        f"({k1_old_ops / 1e9:.3f} GFLOP)")
    if k1_bound > k1_dev:
        fail("K1 reads faster than its bound: the bound counts too much")

    # ---- 3a. the threefry kernel, and the leaves through it ----
    threefry_phase(dev)

    # ---- 4. RPM main path through the CLI ----
    cli_captures = {}        # CUDA graphs captured by each CLI run
    with tempfile.TemporaryDirectory() as tmp:
        rate_gen = RPMGenerator(GenConfig(out_dir=tmp, seed=0, batch_size=32,
                                          grid_only=True), dev)
        rate_leaf = "平移"
        rate_ids = [e[0] for e in rate_gen._sample_assignments(
            range(2000))[rate_leaf]][:32]
        if len(rate_ids) != 32:
            fail(f"ids 0..1999 give {rate_leaf} {len(rate_ids)} samples")
        t0 = time.perf_counter()
        rate_gen.warmup(rate_ids)
        log(f"RPMGenerator.warmup, one batch of 32 of {rate_leaf}: "
            f"{time.perf_counter() - t0:.3f} s, transfer_bytes "
            f"{rate_gen.transfer_bytes}")
        if rate_gen.transfer_bytes != 0 or os.listdir(rate_gen.grids_dir):
            fail("warmup copied or wrote something")
    moved = {}               # transfer_bytes of each CLI run's generator
    real_close = RPMGenerator.close

    def close_and_count(gen):
        moved[gen.out_dir] = gen.transfer_bytes
        real_close(gen)

    RPMGenerator.close = close_and_count
    raster_cuda.LAUNCHES = 0
    runs, tf_launches = {}, {}  # tf_launches: each run's threefry launches
    with tempfile.TemporaryDirectory() as tmp:
        for tag, extra in (("full", []), ("grid_only_dedup",
                                          ["--grid_only", "--dedup"]),
                           ("sparse", ["--sparse"])):
            out = os.path.join(tmp, tag)
            t0 = time.perf_counter()
            caps = graphs.CAPTURES
            prng_cuda.LAUNCHES = 0
            cli.main(["--device", "cuda", "--n", "64", "--batch_size", "32",
                      "--seed", "0", "--out_dir", out, *extra])
            wall = time.perf_counter() - t0
            runs[tag] = (out, wall)
            tf_launches[tag] = prng_cuda.LAUNCHES
            cli_captures[f"RPM {tag}"] = graphs.CAPTURES - caps
        k1_launches = raster_cuda.LAUNCHES
        RPMGenerator.close = real_close
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
            log(f"RPM main path {tag}: 64 samples ({len(kept)} kept, "
                f"{64 - len(kept)} duplicates), {n_png} PNGs decoded, "
                f"wall {wall:.3f} s, {64 / wall:.3f} samples/s, "
                f"transfer_bytes {moved[out]}, CUDA graphs captured "
                f"{cli_captures[f'RPM {tag}']}")
        # --sparse (rle4d) writes the full export's tree
        full, sparse_out = runs["full"][0], runs["sparse"][0]
        files = sorted(os.path.relpath(os.path.join(d, f), full)
                       for d, _, fs in os.walk(full) for f in fs)
        if files != sorted(os.path.relpath(os.path.join(d, f), sparse_out)
                           for d, _, fs in os.walk(sparse_out) for f in fs):
            fail("the --sparse run wrote other files than the full export")
        wall_clock = ("timestamp", "generation_time")

        def stable_json(path, root):
            def drop(x):
                if isinstance(x, dict):
                    return {k: drop(v) for k, v in x.items()
                            if k not in wall_clock}
                return [drop(v) for v in x] if isinstance(x, list) else x
            with open(path, encoding="utf-8") as f:
                return drop(json.loads(f.read().replace(root, "<out>")))

        for rel in files:
            a, b = os.path.join(full, rel), os.path.join(sparse_out, rel)
            same = (np.array_equal(read_png(a), read_png(b))
                    if rel.endswith(".png")
                    else stable_json(a, full) == stable_json(b, sparse_out))
            if not same:
                fail(f"--sparse and the raw transfer differ in {rel}")
        log(f"RPM --sparse (rle4d) tree equal to the full export's: "
            f"{len(files)} files; transfer_bytes {moved[sparse_out]} against "
            f"{moved[full]} raw ({moved[full] / moved[sparse_out]:.2f}x)")
    log(f"raster_cuda.LAUNCHES after the RPM CLI runs: {k1_launches}")
    if k1_launches <= 0:
        fail("the RPM main path never launched the rasterizer kernel")
    log(f"prng_cuda.LAUNCHES of each RPM CLI run: {tf_launches}")
    if min(tf_launches.values()) <= 0:
        fail(f"an RPM CLI run never launched the threefry kernel: "
             f"{tf_launches}")
    rates = [rate_gen.measure_device_rate(rate_ids, iters=5, blocking=b)
             for b in (False, True)]
    rate_gen.close()
    log(f"RPMGenerator.measure_device_rate, {rate_leaf}, batch 32, 5 calls "
        f"(pipeline alone: no copy to the host, no export): "
        f"{rates[0]:.3f} samples/s queued, {rates[1]:.3f} samples/s blocking")

    # ---- 5. RPM card against CPU ----
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
        log(f"RPM card vs cpu {leaf}: " + ("equal" if not diffs else
                                            "DIFF " + ", ".join(diffs)))
        if diffs:
            fail(f"card and CPU disagree on {leaf}: {diffs}")

    # ---- 6. K1 at the 'hq' shape: 1024x1024, strokes to 6, flips ----
    SC = 2
    WB, HB = W * SC, H * SC
    hq_sets = [("hq 平移", cases[1][1].map(lambda a: a[:64])),
               ("hq 直接叠加", cases[2][1].map(lambda a: a[:40])),
               ("hq hand-built", k1_hq_hand_frames())]
    hq_err, hq_launches = 0, 0
    for name, st in hq_sets:
        st = st.map(lambda a: a.to(dev))
        n = st.kind.shape[0]
        ug = torch.arange(n, device=dev) % 2 == 1
        big = raster.hq_states(st, W, H, ug, 3, SC)
        no_grid = torch.zeros_like(ug)
        bm = raster.prepare_render_data(big, WB, HB, no_grid, honor_flip=True)
        got = raster_cuda.render_prepared_cuda(*bm, no_grid, WB, HB)
        ref = raster.render_frames(big, WB, HB, no_grid, honor_flip=True)
        torch.cuda.synchronize()
        if got.shape != (n, HB, WB, 3) or ref.shape != got.shape:
            fail(f"K1 shape {tuple(got.shape)} on {name}")
        err = int((got.int() - ref.int()).abs().max())
        hq_err = max(hq_err, err)
        strokes = sorted(set(big.stroke[big.valid].tolist()))
        del got, ref
        # the path itself, through the entry point, and against the CPU
        raster_cuda.LAUNCHES = 0
        out = raster.render_batch(st, W, H, ug, antialias_mode="hq",
                                  scale=SC, honor_flip=True)
        torch.cuda.synchronize()
        launched = raster_cuda.LAUNCHES
        hq_launches += launched
        k = min(n, 4)
        on_cpu = raster.render_batch(st.map(lambda a: a[:k].cpu()), W, H,
                                     ug[:k].cpu(), antialias_mode="hq",
                                     scale=SC, honor_flip=True)
        cpu_err = int((out[:k].cpu().int() - on_cpu.int()).abs().max())
        log(f"K1 vs plain: {name} ({n} frames {WB}x{HB}, strokes "
            f"{strokes}): maxdiff {err}; 'hq' {W}x{H} card vs cpu on {k} "
            f"frames: maxdiff {cpu_err}; launches {launched}")
        if out.shape != (n, H, W, 3) or out.dtype != torch.uint8:
            fail(f"'hq' output {tuple(out.shape)} {out.dtype} on {name}")
        if cpu_err != 0:
            fail(f"'hq' on the card and on the CPU disagree on {name}")
    if hq_err != 0:
        fail(f"K1 at {WB}x{HB} disagrees with its plain version "
             f"(maxdiff {hq_err})")
    if hq_launches < len(hq_sets):
        fail(f"'hq' launched K1 {hq_launches} times on {len(hq_sets)} batches")

    # timing at the 'hq' shape: 64 frames of 1024x1024, no grid
    st = hq_sets[0][1].map(lambda a: a.to(dev))
    ug = torch.arange(64, device=dev) % 2 == 1
    no_grid = torch.zeros_like(ug)
    hmeta, hvx, hvy = raster.prepare_render_data(
        raster.hq_states(st, W, H, ug, 3, SC), WB, HB, no_grid,
        honor_flip=True)
    hq_plain = lambda: raster.render_prepared(hmeta, hvx, hvy, no_grid,
                                              WB, HB, 3)
    hq_kern = lambda: raster_cuda.render_prepared_cuda(hmeta, hvx, hvy,
                                                       no_grid, WB, HB)
    hq_t = [timed(hq_plain, 2), timed(hq_kern, 20), timed(hq_kern, 20),
            timed(hq_plain, 2)]
    hq_dev = device_ms(hq_kern, 20, "raster_kernel")
    hq_bytes, hq_ops = k1_work(hmeta, hvx, hvy, WB, HB)
    hq_bound, hq_by = bound(hq_bytes, hq_ops)
    log(f"K1 time per 64 frames of {WB}x{HB} (plain, kernel, kernel, "
        f"plain): {hq_t[0]:.3f}, {hq_t[1]:.3f}, {hq_t[2]:.3f}, "
        f"{hq_t[3]:.3f} ms; kernel's own device time {hq_dev:.4f} ms; bound "
        f"{hq_bound:.4f} ms ({hq_by}: {hq_bytes / 1e6:.1f} MB, "
        f"{hq_ops / 1e9:.3f} GFLOP), {100 * hq_bound / hq_dev:.1f}% of it "
        f"reached")
    if hq_bound > hq_dev:
        fail("K1 at the 'hq' shape reads faster than its bound")
    hq_ds = lambda: raster.downsample(out_hi, SC)
    out_hi = hq_kern()
    log(f"'hq' downsample of 64 frames {WB}x{HB} -> {W}x{H} (two float32 "
        f"matmuls, events): {timed(hq_ds, 5):.3f} ms")
    del out_hi

    # ---- 7. soft, colours, overlay, Shape.draw: card against CPU ----
    def byte_diff(a, b, what, max_err, max_share):
        """Hold u8 results of the card and the CPU to a difference of at
        most `max_err` on at most `max_share` of the bytes."""
        a = a.cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        b = b.cpu() if isinstance(b, torch.Tensor) else torch.from_numpy(b)
        if a.shape != b.shape or a.dtype != torch.uint8 or b.dtype != a.dtype:
            fail(f"{what}: {tuple(a.shape)} {a.dtype} on the card, "
                 f"{tuple(b.shape)} {b.dtype} on the CPU")
        d = (a.int() - b.int()).abs()
        err, share = int(d.max()), float((d > 0).float().mean())
        log(f"{what}, card vs cpu: maxdiff {err} on {share:.2e} of "
            f"{d.numel()} bytes (allowed: {max_err} on {max_share:.0e})")
        if err > max_err or share > max_share:
            fail(f"{what}: the card and the CPU disagree")
        return err

    aa_err = {}
    hand = k1_hq_hand_frames().map(lambda a: a[:, :4])   # 4 live slots
    hand_ug = torch.tensor([False, True, False, True])
    both = lambda fn: [fn(hand.map(lambda a: a.to(d)), hand_ug.to(d))
                       for d in (dev, cpu)]
    # erf on the card and on the CPU may differ in the last place: 1 on
    # 1e-3 of the bytes, as the CPU test allows torch against XLA
    aa_err["soft"] = byte_diff(*both(lambda s, g: raster.render_batch(
        s, W, H, g, antialias_mode="soft", honor_flip=True)),
        "'soft' 4 frames 512x512", 1, 1e-3)
    soft, fast = (raster.render_batch(hand.map(lambda a: a.to(dev)), W, H,
                                      hand_ug.to(dev), antialias_mode=m,
                                      honor_flip=True) for m in ("soft", "fast"))
    if not float((soft != fast).float().mean()) > 1e-4:
        fail("'soft' widened no fill edge")
    # elementwise float32 and selection only: exact
    aa_err["outline_bg"] = byte_diff(*both(lambda s, g: raster.render_general(
        s, W, H, g, honor_flip=True, bg_color=(240.0, 240.0, 200.0),
        outline_color=(200.0, 30.0, 30.0))),
        "outline and background colour, 4 frames 512x512", 0, 0.0)

    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (45, 61, 4)).astype(np.uint8)
    canvas = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    ovs = [overlay.prepare_overlay(torch.from_numpy(rgba).to(d),
                                   target_size=(150, 110), rotate=33.0,
                                   flip="horizontal", tile_to=(260, 200))
           for d in (dev, cpu)]
    ov_err = float((ovs[0].cpu() - ovs[1]).abs().max())
    log(f"prepare_overlay 61x45 -> 150x110, rotated, flipped, tiled to "
        f"260x200, card vs cpu: max abs difference {ov_err:.3e} of 255 "
        f"(allowed 1e-3: the resize is a float32 matmul)")
    if ovs[0].shape != (200, 260, 4) or not ov_err <= 1e-3:
        fail("prepare_overlay: the card and the CPU disagree")
    # the same overlay on both: selection and elementwise float32, exact
    aa_err["blend"] = byte_diff(*[overlay.blend_overlay(
        torch.from_numpy(canvas).to(d), ovs[1].to(d), (500.0, 20.0),
        opacity=0.7) for d in (dev, cpu)],
        "blend_overlay 260x200 across a corner of 512x512", 0, 0.0)
    # each device's own overlay: the matmul's last place may move a byte
    aa_err["overlay"] = byte_diff(*[overlay.blend_overlay(
        torch.from_numpy(canvas).to(d), ov, (500.0, 20.0), opacity=0.7)
        for d, ov in zip((dev, cpu), ovs)],
        "prepare_overlay + blend_overlay", 1, 1e-3)
    tex = rng.integers(0, 256, (40, 40, 3)).astype(np.uint8)
    shape = Shape("heart", 150, True, 3)
    for mode, kw, tol in (
            ("fast", {"texture": tex, "external_mode": "tile",
                      "external_opacity": 0.8}, (1, 1e-3)),
            ("soft", {"flip_mode": "horizontal", "outline": (200, 30, 30)},
             (1, 1e-3)),
            ("hq", {"scale": 2, "texture": tex, "external_rotate": 20.0},
             (1, 1e-3))):
        drawn = [shape.draw(canvas, (480, 260), angle=25.0,
                            color=(40, 80, 200), antialias_mode=mode,
                            device=d, **kw) for d in ("cuda", "cpu")]
        aa_err[f"draw {mode}"] = byte_diff(
            *drawn, f"Shape.draw '{mode}' on 512x512", *tol)
        if not (drawn[0] != canvas).any():
            fail(f"Shape.draw '{mode}' drew nothing")

    # ---- 8. two hosts on one card ----
    TWO_HOST_THRESHOLD = 12
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--device", "cuda", "--n", "64", "--batch_size", "32",
                  "--seed", "0", "--grid_only"]
        cli.main([*common, "--out_dir", f"{tmp}/one"])
        t0 = time.perf_counter()
        for host in ("0", "1"):
            caps = graphs.CAPTURES
            cli.main([*common, "--dedup", "--dedup_threshold",
                      str(TWO_HOST_THRESHOLD), "--num_hosts", "2",
                      "--host_id", host, "--out_dir", f"{tmp}/two"])
            cli_captures[f"RPM two hosts, host {host}"] = \
                graphs.CAPTURES - caps
            merged_there = os.path.exists(f"{tmp}/two/index.json")
            if merged_there != (host == "1"):
                fail(f"after host {host} index.json exists: {merged_there}")
        wall = time.perf_counter() - t0
        with open(f"{tmp}/one/index.json", encoding="utf-8") as f:
            one = json.load(f)
        with open(f"{tmp}/two/index.json", encoding="utf-8") as f:
            two = json.load(f)
        # the reference, from the single run's hashes: each host's greedy
        # pass in its visiting order (leaves as its ids first meet them,
        # ids in order inside a leaf), then the merge's over what is left,
        # by id
        bits = {m["id"]: int(m["grid_phash"], 16) for m in one}
        near = lambda a, b: bin(bits[a] ^ bits[b]).count("1") \
            <= TWO_HOST_THRESHOLD
        dist = sorted((bin(bits[a] ^ bits[b]).count("1"), a, b)
                      for a in bits for b in bits if a < b)
        log(f"two hosts: the 8 nearest pairs of the 64 grids (bits, id, id): "
            f"{dist[:8]}")
        in_host, at_merge = set(), set()
        for host in (0, 1):
            order, kept = {}, []
            for m in one[host::2]:
                order.setdefault(m["rule"], []).append(m["id"])
            for sid in (i for ids in order.values() for i in ids):
                if any(near(sid, k) for k in kept):
                    in_host.add(sid)
                else:
                    kept.append(sid)
        kept = []
        for sid in sorted(set(bits) - in_host):
            if any(near(sid, k) for k in kept):
                at_merge.add(sid)
            else:
                kept.append(sid)
        if [m["id"] for m in two] != list(range(64)) or \
                [m["id"] for m in one] != list(range(64)):
            fail("the merged index does not list ids 0..63 in order")
        for m in two:
            sid, dup = m["id"], bool(m.get("duplicate"))
            if dup != (sid in in_host or sid in at_merge):
                fail(f"two hosts: id {sid} duplicate={dup}, the reference "
                     f"says in_host={sid in in_host} merge={sid in at_merge}")
            if sid not in in_host and m["grid_phash"] != \
                    one[sid]["grid_phash"]:
                fail(f"two hosts: id {sid} has another hash")
            there = os.path.exists(f"{tmp}/two/grids/grid_{sid:06d}.png")
            if there == dup or \
                    os.path.isdir(f"{tmp}/two/samples/sample_{sid:06d}") == dup:
                fail(f"two hosts: id {sid} duplicate={dup} but its files "
                     f"exist: {there}")
        left = sorted(os.listdir(f"{tmp}/two"))
        if left != ["grids", "index.json", "index_host00.json",
                    "index_host01.json", "samples"]:
            fail(f"two hosts left {left}")
    log(f"two hosts on one card: 64 samples grid-only, dedup threshold "
        f"{TWO_HOST_THRESHOLD}: {len(in_host)} duplicates inside a host "
        f"{sorted(in_host)}, {len(at_merge)} at the merge "
        f"{sorted(at_merge)}, flags, hashes and files as the reference "
        f"says; wall {wall:.3f} s for both hosts")
    if not at_merge:
        fail("no duplicate at the merge: the check of its files is empty")

    # ---- 9. K2 against its plain version ----
    k2_err = 0
    for set_name, batch in (("16 generated", mg_generated_batch(16)),
                            ("hand-built", mg_hand_batch())):
        for dpi in (200, 34, 25):
            args = mg_renderer.prepare_scene_batch(
                mg_renderer.scene_batch_to_torch(batch, dev), dpi)
            S = mg_renderer.data_to_pixel_transform(dpi)[3]
            got = renderer_cuda.render_prepared_cuda(*args, S, S)
            ref = mg_renderer.render_prepared(*args, S, S)
            torch.cuda.synchronize()
            n = args[0].shape[0]
            if got.shape != (n, S, S, 3) or ref.shape != got.shape:
                fail(f"K2 shape {tuple(got.shape)} on {set_name} dpi {dpi}")
            err = int((got.int() - ref.int()).abs().max())
            k2_err = max(k2_err, err)
            log(f"K2 vs plain: {set_name} ({n} scenes {S}x{S}, dpi {dpi}): "
                f"maxdiff {err}")
    for S in (1600, 272, 200):
        args = mg_pixel_batch(S, dev)
        got = renderer_cuda.render_prepared_cuda(*args, S, S)
        ref = mg_renderer.render_prepared(*args, S, S)
        torch.cuda.synchronize()
        n = args[0].shape[0]
        if got.shape != (n, S, S, 3) or ref.shape != got.shape:
            fail(f"K2 shape {tuple(got.shape)} on pixel-space scenes at {S}")
        err = int((got.int() - ref.int()).abs().max())
        k2_err = max(k2_err, err)
        white = bool((got[-1] == 255).all())
        log(f"K2 vs plain: pixel-space ({n} scenes {S}x{S}): maxdiff {err}; "
            f"empty scene white: {white}")
        if not white:
            fail("K2 drew into an empty scene")
    if k2_err != 0:
        fail(f"K2 disagrees with its plain version (maxdiff {k2_err})")

    # timing at the main path's shape: 16 scenes of 1600x1600 (dpi 200)
    S = mg_renderer.data_to_pixel_transform(200)[3]
    args = mg_renderer.prepare_scene_batch(
        mg_renderer.scene_batch_to_torch(mg_generated_batch(16), dev), 200)
    k2_plain = lambda: mg_renderer.render_prepared(*args, S, S)
    k2_kern = lambda: renderer_cuda.render_prepared_cuda(*args, S, S)
    k2_t = [timed(k2_plain, 2), timed(k2_kern, 20), timed(k2_kern, 20),
            timed(k2_plain, 2)]
    k2_dev = device_ms(k2_kern, 20, "mg_render_kernel")
    k2_bytes, k2_ops = k2_work(args, S, S)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    k2_old_bytes, k2_old_ops = k2_work_tiled(args[0], args[5], S, S)
    log(f"K2 time per 16 scenes of {S}x{S} (plain, kernel, kernel, plain): "
        f"{k2_t[0]:.3f}, {k2_t[1]:.3f}, {k2_t[2]:.3f}, {k2_t[3]:.3f} ms; "
        f"kernel's own device time {k2_dev:.4f} ms; bound {k2_bound:.4f} ms "
        f"({k2_by}: {k2_bytes / 1e6:.1f} MB, {k2_ops / 1e9:.3f} GFLOP), "
        f"{100 * k2_bound / k2_dev:.1f}% of it reached; the earlier per-tile "
        f"count gave {bound(k2_old_bytes, k2_old_ops)[0]:.4f} ms "
        f"({k2_old_ops / 1e9:.3f} GFLOP)")
    if k2_bound > k2_dev:
        fail("K2 reads faster than its bound: the bound counts too much")

    # ---- 10. mg main path through its CLI ----
    renderer_cuda.LAUNCHES = 0
    n_mg = 64
    with tempfile.TemporaryDirectory() as tmp:
        walls = []
        # the second run warm, with the first run's tiers
        for run in ("first", "again"):
            t0 = time.perf_counter()
            caps = graphs.CAPTURES
            mg_cli.main(["--device", "cuda", "--n", str(n_mg), "--batch_size",
                         "16", "--dpi", "200", "--modes", ",".join(MG_MODES),
                         "--out_dir", os.path.join(tmp, run)])
            walls.append(time.perf_counter() - t0)
            cli_captures[f"mg {run}"] = graphs.CAPTURES - caps
        wall = walls[0]
        k2_launches = renderer_cuda.LAUNCHES
        for run in ("first", "again"):
            out = os.path.join(tmp, run)
            pngs = sorted(os.listdir(os.path.join(out, "images")))
            params = sorted(os.listdir(os.path.join(out, "params")))
            if len(pngs) != n_mg or len(params) != n_mg:
                fail(f"mg CLI wrote {len(pngs)} PNGs and {len(params)} "
                     f"params JSON, want {n_mg} each")
            for name in pngs:
                if read_png(os.path.join(out, "images", name)).shape != \
                        (S, S, 3):
                    fail(f"mg CLI: bad image {name}")
            for name in params:
                with open(os.path.join(out, "params", name),
                          encoding="utf-8") as f:
                    if "qc" not in json.load(f):
                        fail(f"mg CLI: {name} has no qc")
    log(f"mg main path: {n_mg} scenes of {S}x{S}, {len(pngs)} PNGs decoded, "
        f"{len(params)} params JSON parsed a run, wall {wall:.3f} s, "
        f"{n_mg / wall:.3f} scenes/s; the same run again (the process warm, "
        f"its first run's tiers persisted): {walls[1]:.3f} s, "
        f"{n_mg / walls[1]:.3f} scenes/s")
    log(f"renderer_cuda.LAUNCHES after the mg CLI run: {k2_launches}")
    log("CUDA graphs captured per CLI run (utils/graphs.CAPTURES): "
        + ", ".join(f"{k} {v}" for k, v in cli_captures.items()))
    if k2_launches < n_mg // 16:
        fail(f"the mg main path launched K2 {k2_launches} times, want "
             f">= {n_mg // 16}")

    # ---- 11. mg card against CPU ----
    seeds = [1, 2, 3, 4, 1, 2, 7, 8]          # ids 4, 5 repeat ids 0, 1
    modes = [MG_MODES[i % 4] for i in range(8)]
    volatile = ("generation_id", "timestamp")
    stable = lambda r: {k: v for k, v in r.items() if k not in volatile}
    with tempfile.TemporaryDirectory() as tmp:
        recs = {}
        for d in (dev, cpu):
            root = os.path.join(tmp, d.type)
            gen = GeometryGenerator(d)
            out = gen.generate_batches(
                seeds, modes,
                [f"{root}/images/{i}_{m}.png" for i, m in enumerate(modes)],
                [f"{root}/params/{i}_{m}.json" for i, m in enumerate(modes)],
                dpi=50, batch_size=4, dedup=True)
            gen.close()          # QC lands in the records on the pool
            recs[d.type] = [stable(r) for r in out]
        bad = [i for i, (a, b) in enumerate(zip(recs["cuda"], recs["cpu"]))
               if a != b]
        if bad or len(recs["cuda"]) != len(recs["cpu"]):
            fail(f"mg card and CPU records differ at {bad}: "
                 f"{recs['cuda'][bad[0]] if bad else ''} vs "
                 f"{recs['cpu'][bad[0]] if bad else ''}")
        dups = [i for i, r in enumerate(recs["cuda"]) if r.get("duplicate")]
        files = sorted(os.path.relpath(os.path.join(r, f), f"{tmp}/cuda")
                       for r, _, fs in os.walk(f"{tmp}/cuda") for f in fs)
        other = sorted(os.path.relpath(os.path.join(r, f), f"{tmp}/cpu")
                       for r, _, fs in os.walk(f"{tmp}/cpu") for f in fs)
        if files != other:
            fail("mg card and CPU wrote different files")
        for rel in files:
            a, b = f"{tmp}/cuda/{rel}", f"{tmp}/cpu/{rel}"
            if rel.endswith(".png"):
                same = (read_png(a) == read_png(b)).all()
            else:
                with open(a, encoding="utf-8") as fa, \
                        open(b, encoding="utf-8") as fb:
                    same = stable(json.load(fa)) == stable(json.load(fb))
            if not same:
                fail(f"mg card and CPU differ in {rel}")
    log(f"mg card vs cpu: 8 scenes at dpi 50, duplicates {dups}, "
        f"{len(files)} files: equal")

    # ---- 12. mg stage profile: one batch of 16 scenes at 1600x1600 ----
    from reasoning_image_generation_tpu_torch.models.multigraph.check import (
        check_scene_inside, compute_scene_features)
    from reasoning_image_generation_tpu_torch.models.multigraph.scene import (
        build_scene_batch)
    from reasoning_image_generation_tpu_torch.ops import rle
    from reasoning_image_generation_tpu_torch.ops.phash import (
        CorpusDedup, phash)

    def stage(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    rows = []
    g12 = GeometryGenerator(dev)      # its tiers and budget: phases 10, 11
    corpus12 = CorpusDedup(64, dev)
    batches12 = [build_scene_batch(list(range(100 * rep, 100 * rep + 16)),
                                   [MG_MODES[i % 4] for i in range(16)])[0]
                 for rep in range(3)]
    for batch in batches12:
        # the graphs' captures, and the budget the run statistics settle on
        imgs, hashes = g12._render_imgs(batch, 200, hashed=True)
        corpus12.submit(hashes, 16)
        g12._render_finish(g12._render_dispatch(imgs))
    budget12 = g12._pack_budget(S, S)
    g12._pack(imgs, budget=budget12, codec="rle4")
    with tempfile.TemporaryDirectory() as tmp, TimedCopies() as copies:
        for rep in range(3):
            seeds = list(range(100 * rep, 100 * rep + 16))
            r = {}
            (batch, _), r["scene build (host)"] = stage(
                lambda: build_scene_batch(seeds, [MG_MODES[i % 4]
                                                  for i in range(16)]))
            args, r["to device + prep (eager)"] = stage(
                lambda: mg_renderer.prepare_scene_batch(
                    mg_renderer.scene_batch_to_torch(batch, dev), 200))
            imgs, r["K2 render (eager launch)"] = stage(
                lambda: renderer_cuda.render_prepared_cuda(*args, S, S))
            _, r["pHash (eager)"] = stage(lambda: phash(imgs))
            (imgs, hashes), r["upload, prep, K2, pHash (replayed)"] = stage(
                lambda: g12._render_imgs(batch, 200, hashed=True))
            _, r["dedup step (replayed)"] = stage(
                lambda: corpus12.submit(hashes, 16))
            _, r[f"pack rle4 (budget {budget12}; eager)"] = stage(
                lambda: rle.pack_batch_rle4(imgs, budget12))
            _, r[f"pack rle4 (budget {budget12}; replayed)"] = stage(
                lambda: g12._pack(imgs, budget=budget12, codec="rle4"))
            (frames, over, _hw, _x), \
                r["pack, blob (replayed), blob copy, split"] = stage(
                    lambda: g12._render_finish(g12._render_dispatch(imgs)))
            _, r["PNG encode from runs, 16 serial"] = stage(lambda: [
                png.write_png(os.path.join(tmp, f"{i}.png"), over[i])
                if i in over else png.write_png_rle3(
                    os.path.join(tmp, f"{i}.png"), frames, i, S, S)
                for i in range(16)])
            _, r["QC + features, 16 serial"] = stage(lambda: [
                (check_scene_inside(sc), compute_scene_features(sc))
                for sc in ({k: v[i] for k, v in batch.items()}
                           for i in range(16))])
            rows.append(r)
        g12.close()
        prof_gen = GeometryGenerator(dev)
        paths = [f"{tmp}/p/{i}.png" for i in range(64)]
        jsons = [f"{tmp}/p/{i}.json" for i in range(64)]
        modes64 = [MG_MODES[i % 4] for i in range(64)]
        t0 = time.perf_counter()
        prof_gen.generate_batches(list(range(64)), modes64, paths, jsons,
                                  dpi=200, batch_size=16)
        prof_gen.close()
        wall64 = time.perf_counter() - t0
        with torch.profiler.profile(activities=acts) as prof:
            prof_gen = GeometryGenerator(dev)
            prof_gen.generate_batches(list(range(64)), modes64, paths, jsons,
                                      dpi=200, batch_size=16)
            prof_gen.close()
        _n, k_ms, c_ms = device_time(prof)
    med = {k: sorted(r[k] for r in rows)[1] for k in rows[0]}
    for k, v in med.items():
        log(f"mg stage, median of 3 batches of 16 at {S}x{S}: {k}: "
            f"{v * 1e3:.3f} ms")
    blob12 = sorted(copies.rows()[:3], key=lambda r: r[1])[1]
    log(f"mg stage, median of 3 batches: blob copy {blob12[1]:.3f} ms "
        f"(CUDA events, {blob12[0]} bytes, pinned, non-blocking); "
        f"overflowed scenes fetched raw: {len(over)} in the last batch")
    log(f"mg generator, 64 scenes at {S}x{S}, batch 16: wall {wall64:.3f} s "
        f"unprofiled; device busy under the profiler {k_ms + c_ms:.3f} ms "
        f"({100 * (k_ms + c_ms) / 1e3 / wall64:.2f}% of the unprofiled "
        f"wall): kernels {k_ms:.3f} ms, copies and memsets {c_ms:.3f} ms")

    # ---- 13. transfer codecs: card against CPU, bytes and times ----
    from reasoning_image_generation_tpu_torch.io import transfer
    from reasoning_image_generation_tpu_torch.ops.compose import compose_grid
    assign = rate_gen._sample_assignments(range(2000))
    codec_diffs = []
    for leaf in ("平移", "直接叠加"):
        chunk = assign[leaf][:32]
        ids = [e[0] for e in chunk]
        pipe = LeafPipeline(leaf, GenConfig(batch_size=32, seed=0))
        out = pipe(sample_keys(0, ids, dev),
                   torch.tensor([e[2] for e in chunk], device=dev))
        L = pipe.L
        _g, pre = compose_grid(pipe.layout, out["state_imgs"][:, :L - 1],
                               out["option_imgs"], return_pre=True)
        full_in = {k: out[k] for k in ("state_imgs", "option_imgs",
                                       "grid_img")}
        cpu_in = {k: v.cpu() for k, v in full_in.items()}
        pre_cpu = pre.cpu()
        raw_bytes = sum(v.numel() for v in full_in.values())
        for codec in CODECS:
            on_card = pack_as_generator(pipe, full_in, pre, codec)
            on_cpu = pack_as_generator(pipe, cpu_in, pre_cpu, codec)
            bad = {k: diff_leaves(on_card[k], on_cpu[k]) for k in on_card}
            bad = {k: v for k, v in bad.items() if v}
            if bad:
                codec_diffs.append((leaf, codec, bad))
            t_full = events_ms(lambda: pack_as_generator(pipe, full_in, pre,
                                                         codec))
            t_grid = events_ms(lambda: pack_as_generator(
                pipe, {"grid_img": out["grid_img"]}, pre, codec))
            cap_bytes = sum(a.numel() * a.element_size() for v in on_card.values()
                            for a in transfer.tree_leaves(v))
            log(f"codec {codec}, {leaf} batch 32 at {W}x{H} "
                f"({out['state_imgs'].shape[1]} states, "
                f"{out['option_imgs'].shape[1]} options, grids before "
                f"their overlay): card vs cpu "
                f"{'equal' if not bad else f'DIFF {bad}'}; pack on the card "
                f"{t_full:.3f} ms full export, {t_grid:.3f} ms grid-only "
                f"(CUDA events, median of 3); streams at device capacity "
                f"{cap_bytes} bytes (frames raw: {raw_bytes})")
        for grid_only in (False, True):
            for codec in (None,) + CODECS:
                with tempfile.TemporaryDirectory() as tmp, \
                        TimedCopies() as tc:
                    gen = RPMGenerator(GenConfig(
                        out_dir=tmp, seed=0, batch_size=32,
                        grid_only=grid_only, sparse_transfer=bool(codec),
                        transfer_codec=codec or "rle4d"), dev)
                    gen._run_stats.clear()          # no statistics yet
                    walls, got = [], []
                    for _call in range(2):
                        b0, t0 = gen.transfer_bytes, time.perf_counter()
                        gen.generate_ids(ids)
                        walls.append(time.perf_counter() - t0)
                        got.append(gen.transfer_bytes - b0)
                    gen.close()
                    (n1, ms1), (n2, ms2) = tc.rows()[0], tc.rows()[-1]
                extra = ""
                if codec is None:
                    extra = (f"; pageable .cpu() of as many bytes "
                             f"{pageable_ms(torch.empty(n2, dtype=torch.uint8, device=dev)):.3f} ms")
                log(f"bytes per batch, RPM {leaf} batch 32 "
                    f"{'grid-only' if grid_only else 'full export'} "
                    f"{codec or 'raw'}: batch 1 (no statistics) {got[0]} "
                    f"(blob {n1}, copy {ms1:.3f} ms), batch 2 (tiers from "
                    f"batch 1) {got[1]} (blob {n2}, copy {ms2:.3f} ms; "
                    f"pinned, non-blocking, CUDA events){extra}; wall per "
                    f"generate_ids with export {walls[0]:.3f}, "
                    f"{walls[1]:.3f} s")
    # mg: K2's 16 scenes at 1600x1600
    margs = mg_renderer.prepare_scene_batch(
        mg_renderer.scene_batch_to_torch(mg_generated_batch(16), dev), 200)
    mimgs = renderer_cuda.render_prepared_cuda(*margs, S, S)
    mcpu = mimgs.cpu()
    forced = 8192          # below what most scenes need: overflow forced
    for codec in ("rle4", "rle5"):
        fn = getattr(rle, f"pack_batch_{codec}")
        for budget in (rle.default_budget(S, S), forced):
            on_card, on_cpu = fn(mimgs, budget), fn(mcpu, budget)
            bad = diff_leaves(on_card, on_cpu)
            if bad:
                codec_diffs.append(("mg", codec, budget, bad))
            fr = rle.Rle3Frames(tuple(transfer.host_array(a) for a in on_card),
                                budget)
            over = fr.overflow_indices(16)
            raw = transfer.gather_frames(mimgs, over)
            for i in range(16):
                want = mcpu[i].numpy()
                if not np.array_equal(raw[i] if i in raw else
                                      fr.unpack(i, (S, S)), want):
                    fail(f"mg {codec} budget {budget}: scene {i} decodes "
                         f"wrong")
            if budget == forced and not len(over):
                fail("the forced overflow overflowed no scene")
            t = events_ms(lambda: fn(mimgs, budget))
            log(f"codec {codec}, mg 16 scenes at {S}x{S}, budget {budget}: "
                f"card vs cpu {'equal' if not bad else f'DIFF {bad}'}; "
                f"{len(over)} scenes over budget, fetched raw and equal, the "
                f"rest decoded equal; pack on the card {t:.3f} ms (CUDA "
                f"events, median of 3)")
    blob = transfer.coalesce_flat(list(rle.pack_batch_rle4(
        mimgs, rle.default_budget(S, S))))
    if not np.array_equal(transfer.HostCopy(blob).numpy(), blob.cpu().numpy()):
        fail("the pinned blob copy was read before it completed")
    pinned = torch.empty(mimgs.shape, dtype=torch.uint8, pin_memory=True)
    log(f"raw mg batch, 16 scenes at {S}x{S} ({mimgs.numel()} bytes): "
        f"pinned non-blocking copy "
        f"{events_ms(lambda: pinned.copy_(mimgs, non_blocking=True)):.3f} "
        f"ms (CUDA events), pageable .cpu() {pageable_ms(mimgs):.3f} ms "
        f"(host clock); median of 3 each")
    for codec in ("rle4", "rle5"):
        with tempfile.TemporaryDirectory() as tmp, TimedCopies() as tc:
            g = GeometryGenerator(dev, transfer_codec=codec)
            g._run_stats.clear()                    # no statistics yet
            t0 = time.perf_counter()
            g.generate_batches(list(range(48)),
                               [MG_MODES[i % 4] for i in range(48)],
                               [f"{tmp}/{i}.png" for i in range(48)],
                               dpi=200, batch_size=16)
            wall = time.perf_counter() - t0
            g.close()
            learned = g._pack_budget(S, S)
            rows = tc.rows()
        t = events_ms(lambda: getattr(rle, f"pack_batch_{codec}")(mimgs,
                                                                   learned))
        log(f"bytes per batch, mg {codec}, 3 batches of 16 at {S}x{S} from "
            f"no statistics: blobs " + ", ".join(
                f"{n} ({ms:.3f} ms)" for n, ms in rows)
            + f"; transfer_bytes {g.transfer_bytes} in all (raw: "
            f"{3 * mimgs.numel()}); the budget learnt {learned}, pack at it "
            f"{t:.3f} ms; wall {wall:.3f} s")
    if codec_diffs:
        fail(f"codec streams differ between card and CPU: {codec_diffs}")
    log("codecs: every stream equal between card and CPU")

    # ---- 14. device mesh: two handles to the card ----
    rpm_mesh_launches, mg_mesh_launches = phase_14(dev, S)

    # ---- 15. the compiled batch step: CUDA graphs against eager ----
    graph_phase(dev, S)

    # ---- 16. no JAX ----
    check_no_jax()
    stats_dir.cleanup()
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": [{
        "name": "rpm_frame_rasterizer",
        "route": "cuda",
        "source": "reasoning_image_generation_tpu_torch/csrc/raster.cu",
        "replaces": "reasoning_image_generation_tpu/ops/raster_pallas.py:291",
        "launches": k1_launches + rpm_mesh_launches,
        "max_abs_err": k1_err,
        "ms": k1_t[1],
        "device_ms": k1_dev,
        "registers": registers.get("raster.cu"),
        "plain_ms": k1_t[0],
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
    }, {
        "name": "rpm_frame_rasterizer (the 'hq' shape: 64 frames of "
                "1024x1024, strokes 2 to 6)",
        "route": "cuda",
        "source": "reasoning_image_generation_tpu_torch/csrc/raster.cu",
        "replaces": "reasoning_image_generation_tpu/ops/raster_pallas.py:291",
        "launches": hq_launches,
        "max_abs_err": hq_err,
        "ms": hq_t[1],
        "device_ms": hq_dev,
        "registers": registers.get("raster.cu"),
        "plain_ms": hq_t[0],
        "bound_ms": hq_bound,
        "bound_by": hq_by,
        "library_ms": None,
    }, {
        "name": "mg_scene_renderer",
        "route": "cuda",
        "source": "reasoning_image_generation_tpu_torch/csrc/mg_render.cu",
        "replaces": "reasoning_image_generation_tpu/models/multigraph/"
                    "renderer_pallas.py:247",
        "launches": k2_launches + mg_mesh_launches,
        "max_abs_err": k2_err,
        "ms": k2_t[1],
        "device_ms": k2_dev,
        "registers": registers.get("mg_render.cu"),
        "plain_ms": k2_t[0],
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
    }]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
