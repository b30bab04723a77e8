# test_torch_kernel_culls.py — the CUDA rasterizers' culls, as plain tensor code.
"""The two CUDA kernels (csrc/raster.cu, csrc/mg_render.cu) skip work that
cannot change a pixel.  Their rules live as plain tensor code beside the
plain renderers (``raster.tile_culls``, ``renderer.tile_culls``,
``raster.edge_records``), and the plain renderers apply them when handed a
``cull``.  Everything here is exact, no tolerance:

(a) compositing each element, shape and line only at the pixels inside its
    bbox (for the RPM rasterizer in the wrapped coordinates, inside the wrap
    gate) leaves the render unchanged;
(b) for every tile size in use (the kernels' own, and 1x1, with which
    chip_smoke.py counts the work a pixel needs), the nearest edge of every
    pixel with a non-zero stroke is in the near list of that pixel's tile,
    and a render that takes the distance over the near list and the crossing
    count over the rows list equals the unculled render;
(c) the per-edge records have the bits the per-pixel loop computes: a
    distance and crossing field evaluated from the records equals
    ``_poly_field`` bit for bit, zero-length and horizontal edges included.
"""
import os
import stat

import numpy as np
import pytest
import torch

import chip_smoke
from reasoning_image_generation_tpu_torch.models.multigraph import (
    renderer as mg)
from reasoning_image_generation_tpu_torch.ops import (
    cuda_build, raster, raster_cuda)
from reasoning_image_generation_tpu_torch.utils.config import SHAPE_KINDS
from reasoning_image_generation_tpu_torch.utils.state import (
    dicts_to_state, stack)

torch.set_num_threads(1)

K1_TILES = [raster.TILE, (1, 1), (16, 8)]
K2_TILES = [mg.TILE, (1, 1)]


# ---------------------------------------------------------------- K1 inputs

def _random_frames(seed: int, n: int, W: int, H: int):
    """n frames of up to 4 random elements, some of them canvases away."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n):
        els = []
        for _ in range(int(rng.integers(1, 5))):
            el = chip_smoke.k1_elem(
                SHAPE_KINDS[int(rng.integers(len(SHAPE_KINDS)))],
                size=int(rng.integers(6, 70)),
                center=(float(rng.integers(-W, 2 * W)),
                        float(rng.integers(-H, 2 * H))),
                angle=float(rng.integers(0, 360)),
                color=tuple(int(c) for c in rng.integers(0, 256, 3)))
            el["fill"] = bool(rng.integers(2))
            el["stroke_width"] = int(rng.integers(1, 5))
            els.append(el)
        frames.append(dicts_to_state(els, 4))
    return stack(frames)


def _hand_frames():
    el = chip_smoke.k1_elem
    return stack([dicts_to_state(f, 4) for f in (
        # vertices on the tile borders 32 and 64, and 2 and 3 px from them
        [el("square", 32, (48, 48), angle=0.0), el("circle", 20, (100, 20))],
        [el("square", 28, (48, 48), angle=0.0), el("crescent", 30, (90, 60))],
        [el("square", 26, (48, 48), angle=0.0), el("plus", 30, (20, 80))],
        # a heart that wholly contains tiles; a 2 px square
        [el("heart", 120, (64, 48)), el("square", 2, (100, 10), angle=0.0)],
        # two canvases off, and the wrap seam inside a tile
        [el("hexagon", 30, (40 + 2 * 100, 30), angle=30.0),
         el("plus", 24, (60, 20 + 2 * 72), angle=0.0),
         el("star", 30, (98, 70)), el("heart", 30, (50 - 100, 36 - 72))],
        [])])


def _hq_frames():
    """What the 'hq' mode hands the kernel: elements at twice their size,
    strokes of 4 to 12 (bands 3 to 7, reach up to 7.78 px, bbox margins up
    to 14 px), mirrored outlines, one element across an edge and one two
    canvases off."""
    def el(kind, size, center, stroke, flip=(False, False), **kw):
        d = chip_smoke.k1_elem(kind, size=size, center=center, **kw)
        d["stroke_width"] = stroke
        d["flip"] = {"h": flip[0], "v": flip[1]}
        return d
    return stack([dicts_to_state(f, 4) for f in (
        [el("heart", 110, (70, 60), 4, (True, False)),
         el("circle", 60, (130, 100), 6)],
        [el("star", 120, (80, 64), 6, (False, True), angle=13.0),
         el("crescent", 70, (20, 20), 4)],
        [el("plus", 100, (150, 120), 12, angle=30.0),          # across a corner
         el("triangle", 90, (60, 50), 8, (True, True), angle=77.0)],
        [el("hexagon", 80, (60 + 2 * 160, 64), 10, angle=30.0),  # 2 canvases off
         el("square", 64, (64, 64), 5, angle=0.0),
         el("pentagon", 40, (120, 30), 9, (True, False))])])


K1_FLIPPED = {"hq 160x128"}
K1_CASES = {
    "hq 160x128": lambda: (_hq_frames(), 160, 128),
    "hand 128x96": lambda: (_hand_frames(), 128, 96),
    "hand 100x72": lambda: (_hand_frames(), 100, 72),
    "seed 0 64x64": lambda: (_random_frames(0, 6, 64, 64), 64, 64),
    "seed 1 128x64": lambda: (_random_frames(1, 6, 128, 64), 128, 64),
    "seed 2 90x128": lambda: (_random_frames(2, 6, 90, 128), 90, 128),
}


def _k1_prepared(case: str, use_grid: bool):
    st, W, H = K1_CASES[case]()
    ug = torch.full((st.kind.shape[0],), use_grid)
    return (*raster.prepare_render_data(st, W, H, ug,
                                        honor_flip=case in K1_FLIPPED),
            ug, W, H)


# ---------------------------------------------------------------- K2 inputs

K2_SETS = {
    "generated": lambda dpi: _mg_prepared(chip_smoke.mg_generated_batch(8),
                                          dpi),
    "hand": lambda dpi: _mg_prepared(chip_smoke.mg_hand_batch(), dpi),
    "pixel": lambda dpi: chip_smoke.mg_pixel_batch(8 * dpi, "cpu"),
}


def _mg_prepared(batch, dpi: int):
    return mg.prepare_scene_batch(mg.scene_batch_to_torch(batch, "cpu"), dpi)


# ------------------------------------------------------------ (a) bbox culls

@pytest.mark.parametrize("use_grid", [False, True])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_bbox_and_wrap_gate_cull_moves_no_byte(case, use_grid):
    meta, vx, vy, ug, W, H = _k1_prepared(case, use_grid)
    want = raster.render_prepared(meta, vx, vy, ug, W, H, 3)
    cull = raster.tile_culls(meta, vx, vy, W, H, edges=False)
    got = raster.render_prepared(meta, vx, vy, ug, W, H, 3, cull=cull)
    assert torch.equal(got, want)
    if (meta[..., raster.M_VALID] > 0).any():
        live = cull.live[meta[..., raster.M_VALID] > 0]
        assert live.any() and not live.all()       # the cull does cull


@pytest.mark.parametrize("dpi", [25, 34])
@pytest.mark.parametrize("scene_set", sorted(K2_SETS))
def test_k2_bbox_cull_moves_no_byte(scene_set, dpi):
    args = K2_SETS[scene_set](dpi)
    S = 8 * dpi
    want = mg.render_prepared(*args, S, S)
    cull = mg.tile_culls(*args, S, S)
    every = lambda t: torch.ones_like(t)
    bbox_only = cull._replace(
        shape_near=every(cull.shape_near), mask_near=every(cull.mask_near),
        shape_rows=every(cull.shape_rows), mask_rows=every(cull.mask_rows),
        line_near=every(cull.line_near))
    assert torch.equal(mg.render_prepared(*args, S, S, cull=bbox_only), want)
    assert not cull.shape_live.all() and cull.shape_live.any()


# ----------------------------------------------------------- (b) edge culls

def _edge_d2(rec, px, py):
    """Per-edge squared distance [n, H, W, V] from edge records [n, V], with
    the arithmetic of ``_poly_field``."""
    r = {k: v[:, None, None, :] for k, v in rec.items()}
    pxe = px[..., None] - r["ax"]
    pye = py[..., None] - r["ay"]
    t = torch.clamp(raster.fma(pxe, r["ex"], pye * r["ey"]) * r["inv"], 0, 1)
    dx = raster.fma(-t, r["ex"], pxe)
    dy = raster.fma(-t, r["ey"], pye)
    return raster.fma(dx, dx, dy * dy)


def _assert_nearest_listed(d2, stroked, near_px):
    """d2 [n, H, W, V] per edge, stroked [n, H, W] the pixels whose stroke
    is not zero, near_px [n, H, W, V] the tile lists per pixel: every edge
    that attains the min at a stroked pixel is listed."""
    nearest = d2 == d2.amin(-1, keepdim=True)
    missed = nearest & stroked[..., None] & ~near_px
    assert not missed.any(), f"{int(missed.sum())} nearest edges not listed"


@pytest.mark.parametrize("tile", K1_TILES, ids=str)
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_near_and_rows_lists_move_no_byte(case, tile):
    meta, vx, vy, ug, W, H = _k1_prepared(case, case.startswith("hand"))
    want = raster.render_prepared(meta, vx, vy, ug, W, H, 3)
    cull = raster.tile_culls(meta, vx, vy, W, H, tile)
    got = raster.render_prepared(meta, vx, vy, ug, W, H, 3, cull=cull)
    assert torch.equal(got, want)

    # the nearest edge of every stroked live pixel is in its tile's list
    px = torch.arange(W, dtype=torch.float32)
    py = torch.arange(H, dtype=torch.float32)
    checked = 0
    for e in range(meta.shape[1]):
        m = meta[:, e]
        poly = (m[:, raster.M_VALID] > 0) & (m[:, raster.M_CIRCLE] <= 0) & \
            (m[:, raster.M_CRESCENT] <= 0)
        small = m[:, raster.M_SMALL] > 0
        # (outline part, its edges, the frames that have it)
        for part, n_edges, has in ((0, raster.SMALL_V, poly & small),
                                   (0, 64, poly & ~small),
                                   (1, raster.SMALL_V,
                                    poly & (m[:, raster.M_HASP1] > 0))):
            sel = torch.nonzero(has).squeeze(1)
            if sel.numel() == 0:
                continue
            mm = m[sel][:, :, None, None]
            pxw = raster._wrapped(px, mm[:, raster.M_CX], W).expand(-1, H, W)
            pyw = raster._wrapped(py[:, None], mm[:, raster.M_CY], H) \
                .expand(-1, H, W)
            rec = raster.edge_records(vx[sel, e, part], vy[sel, e, part],
                                      n_edges)
            d2 = _edge_d2(rec, pxw, pyw)
            stroked = (raster._stroke(mm[:, raster.M_STROKE],
                                      raster.sqrt_rn(d2.amin(-1))) > 0) & \
                cull.live[sel, e]
            near_px = torch.stack([raster.tiles_to_pixels(
                cull.near[sel, e, :, :, part, k], tile, H, W)
                for k in range(n_edges)], -1)
            _assert_nearest_listed(d2, stroked, near_px)
            checked += int(stroked.sum())
    assert checked > 0 or not (meta[..., raster.M_VALID] > 0).any()


@pytest.mark.parametrize("tile", K2_TILES, ids=str)
@pytest.mark.parametrize("dpi", [25, 34])
@pytest.mark.parametrize("scene_set", sorted(K2_SETS))
def test_k2_near_and_rows_lists_move_no_byte(scene_set, dpi, tile):
    args = K2_SETS[scene_set](dpi)
    meta, svx, svy = args[:3]
    S = 8 * dpi
    want = mg.render_prepared(*args, S, S)
    cull = mg.tile_culls(*args, S, S, tile)
    assert torch.equal(mg.render_prepared(*args, S, S, cull=cull), want)
    assert not cull.shape_near.all() and cull.shape_near.any()

    px = (torch.arange(S, dtype=torch.float32) + 0.5).expand(S, S)
    py = (torch.arange(S, dtype=torch.float32) + 0.5)[:, None].expand(S, S)
    for s in range(mg.MAX_SHAPES):
        sel = torch.nonzero(meta[:, mg.R_VALID, s] > 0).squeeze(1)
        if sel.numel() == 0:
            continue
        d2 = _edge_d2(raster.edge_records(svx[sel, s], svy[sel, s], mg.NV),
                      px, py)
        lw = meta[sel, mg.R_LW, s, None, None]
        stroked = (mg._band(lw, 1.0, raster.sqrt_rn(d2.amin(-1))) > 0) & \
            cull.shape_live[sel, s]
        near_px = torch.stack([raster.tiles_to_pixels(
            cull.shape_near[sel, s, :, :, k], tile, S, S)
            for k in range(mg.NV)], -1)
        _assert_nearest_listed(d2, stroked, near_px)


def test_k2_reach_is_where_the_band_ends():
    """A distance at the reach gives no stroke, the float below it does."""
    lw = torch.tensor([0.5, 1.0, 2.0, 3.3333, 5.5556, 8.0])
    reach = mg.stroke_reach(lw)
    assert (mg._band(lw, 1.0, reach) == 0).all()
    assert (mg._band(lw, 1.0, torch.nextafter(reach, torch.zeros(()))) > 0
            ).all()
    band = torch.tensor([1.0, 2.0, 3.0])
    edge = band + raster.STROKE_FRINGE
    assert (raster._stroke(band, edge) == 0).all()
    assert (raster._stroke(band, torch.nextafter(edge, torch.zeros(()))) > 0
            ).all()


# ---------------------------------------------------------- (c) edge records

def _outlines(seed: int, n: int, V: int):
    """Random outlines with zero-length edges, horizontal edges on a pixel
    row and vertical edges on a pixel column."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-8, 56, (n, V, 2)).astype(np.float32)
    v[:, 1] = v[:, 0]                      # a zero-length edge
    v[:, 3, 1] = v[:, 2, 1] = np.float32(20.0)     # horizontal, on a row
    v[:, 5, 0] = v[:, 4, 0] = np.float32(31.0)     # vertical, on a column
    v[0] = np.round(v[0])                  # integer vertices, as K1's are
    return torch.from_numpy(v[..., 0].copy()), torch.from_numpy(v[..., 1].copy())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_edges", [8, 64])
def test_edge_records_have_the_per_pixel_loops_bits(n_edges, seed):
    vx, vy = _outlines(seed, 3, n_edges)
    H, W = 48, 40
    px = torch.arange(W, dtype=torch.float32).expand(3, H, W)
    py = torch.arange(H, dtype=torch.float32)[:, None].expand(3, H, W)
    d2_want, cross_want = raster._poly_field(px, py, vx, vy, n_edges)

    rec = raster.edge_records(vx, vy, n_edges)
    r = {k: v[:, None, None, :] for k, v in rec.items()}
    d2 = _edge_d2(rec, px, py).amin(-1)
    cond = (r["ay"] > py[..., None]) != (r["by"] > py[..., None])
    xint = raster.fma(py[..., None] - r["ay"], r["slope"], r["ax"])
    cross = (cond & (px[..., None] < xint)).sum(-1)
    assert torch.equal(d2.view(torch.int32), d2_want.view(torch.int32))
    assert torch.equal(cross.to(torch.int32), cross_want)
    assert (rec["ey"] == 0).any() and torch.isfinite(rec["slope"]).all()
    assert torch.isfinite(rec["inv"]).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_seg_near_rect_never_misses(seed):
    """Brute force: a segment with a point within R of the rectangle is
    always reported near."""
    rng = np.random.default_rng(seed)
    n = 4000
    a = torch.from_numpy(rng.uniform(-40, 80, (n, 2)).astype(np.float32))
    b = a + torch.from_numpy(rng.uniform(-30, 30, (n, 2)).astype(np.float32))
    b[:50] = a[:50]                        # zero-length segments
    cx, cy, hw, hh, R = 16.0, 8.0, 15.5, 7.5, 2.0
    near = raster.seg_near_rect(a[:, 0], a[:, 1], b[:, 0], b[:, 1],
                                cx, cy, hw, hh, R)
    t = torch.linspace(0, 1, 257, dtype=torch.float64)[None, :, None]
    p = a[:, None].double() * (1 - t) + b[:, None].double() * t
    dx = (p[..., 0] - cx).abs() - hw
    dy = (p[..., 1] - cy).abs() - hh
    dist = torch.hypot(dx.clamp(min=0), dy.clamp(min=0)).amin(1)
    assert not ((dist <= R) & ~near).any()
    assert (~near).sum() > n // 10         # and it does reject


# ------------------------------------------------------------ the wrappers

@pytest.mark.parametrize("size", [(512, 512, 3), (600, 200, 3), (250, 70, 4)])
def test_grid_lines_are_the_plain_versions(size):
    W, H, gs = size
    g = raster_cuda.grid_lines(W, H, gs)
    assert (g.nx, g.ny) == (gs - 1, gs - 1)
    assert list(g.x)[:g.nx] == [float(round(i * W / gs)) for i in range(1, gs)]
    assert list(g.y)[:g.ny] == [float(round(i * H / gs)) for i in range(1, gs)]
    assert raster_cuda.grid_lines(W, H, gs) is g          # no work per launch
    with pytest.raises(ValueError, match="grid_size"):
        raster_cuda.grid_lines(W, H, raster_cuda.MAX_GRID_LINES + 2)


def test_render_frames_on_cpu_takes_the_plain_path(monkeypatch):
    st, W, H = K1_CASES["seed 0 64x64"]()
    ug = torch.arange(st.kind.shape[0]) % 2 == 1
    before = raster_cuda.LAUNCHES
    monkeypatch.setattr(cuda_build, "build_cuda", lambda name: pytest.fail(
        "a CPU render asked for the CUDA build"))
    got = raster_cuda.render_frames(st, W, H, ug)
    assert torch.equal(got, raster.render_frames(st, W, H, ug))
    assert raster_cuda.LAUNCHES == before
    meta, vx, vy = raster.prepare_render_data(st, W, H, ug)
    with pytest.raises(ValueError, match="CUDA"):
        raster_cuda.render_prepared_cuda(meta, vx, vy, ug, W, H)
    assert raster_cuda.LAUNCHES == before


def test_build_hashes_the_headers_with_the_source(tmp_path, monkeypatch):
    """A change to an included header gives a new library name, so both
    kernels are rebuilt when csrc/poly.cuh changes."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    src, hdr, cc = tmp_path / "k.cu", tmp_path / "h.cuh", tmp_path / "cc.sh"
    src.write_text("source")
    hdr.write_text("one")
    cc.write_text('#!/bin/sh\ncp "$3" "$2"\n')       # cc -o <lib> <source>
    os.chmod(cc, os.stat(cc).st_mode | stat.S_IEXEC)
    first = cuda_build.build(str(src), [str(cc)], deps=[str(hdr)])
    assert cuda_build.build(str(src), [str(cc)], deps=[str(hdr)]) == first
    hdr.write_text("two")
    second = cuda_build.build(str(src), [str(cc)], deps=[str(hdr)])
    assert second != first and os.path.exists(second)
    headers = [f for f in os.listdir(cuda_build.CSRC) if f.endswith(".cuh")]
    assert headers == ["poly.cuh"]
