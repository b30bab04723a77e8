# test_bench_arith.py — the yardstick's arithmetic on synthetic inputs: the
# bounds, the trace reductions, the readers, the comparisons.
import numpy as np
import pytest

from benchlib import compare, readers, roofline, trace


def test_k1_bound_reproduces_the_kernel_table():
    nbytes = roofline.k1_bytes(256, 8, 512, 512)
    assert round(nbytes / 1e6, 1) == 203.6
    ms, by = roofline.bound(nbytes, 0.715e9)
    assert by == "bytes" and round(ms, 4) == 0.0608


def test_k2_bound_reproduces_the_kernel_table():
    nbytes = roofline.k2_bytes(16, 1600, 1600)
    assert round(nbytes / 1e6, 1) == 123.0
    ms, by = roofline.bound(nbytes, 0.378e9)
    assert by == "bytes" and round(ms, 4) == 0.0367


def test_k2_bytes_counts_the_prepared_scene_tensors():
    import torch
    from plainref.models.multigraph.renderer import (prepare_scene_batch,
                                                     scene_batch_to_torch)
    from plainref.models.multigraph.scene import build_scene_batch
    batch, _ = build_scene_batch([1, 2], ["random", "nested"], 1.3)
    meta, svx, svy, mvx, mvy, lin = prepare_scene_batch(
        scene_batch_to_torch(batch, torch.device("cpu")), 200)
    read = (meta.numel() + svx.numel() + svy.numel() + mvx.numel()
            + mvy.numel() + lin.numel()) * 4
    assert roofline.k2_bytes(2, 1600, 1600) == 2 * 1600 * 1600 * 3 + read


def test_k1_bytes_counts_the_prepared_frame_tensors():
    import torch
    from plainref.models.rpm.sampler import sample_prototype
    from plainref.models.rpm.pipeline import sample_keys
    from plainref.ops import raster
    keys = sample_keys(5, [0, 1, 2])
    st = sample_prototype(keys, 512, 512, 8)
    ug = torch.zeros(3, dtype=torch.bool)
    meta, vx, vy = raster.prepare_render_data(st, 512, 512, ug, 3)
    read = (meta.numel() + vx.numel() + vy.numel()) * 4 + 3
    assert roofline.k1_bytes(3, 8, 512, 512) == 3 * 512 * 512 * 3 + read


def test_k1_work_counts_operations_below_the_bytes_bound():
    import torch
    from plainref.models.rpm.sampler import sample_prototype
    from plainref.models.rpm.pipeline import sample_keys
    from plainref.ops import raster
    st = sample_prototype(sample_keys(5, [0, 1]), 64, 64, 8)
    meta, vx, vy = raster.prepare_render_data(
        st, 64, 64, torch.zeros(2, dtype=torch.bool), 3)
    nbytes, ops = roofline.k1_work(meta, vx, vy, 64, 64)
    assert nbytes == roofline.k1_bytes(2, 8, 64, 64)
    assert ops >= 2 * 64 * 64 * roofline.OUT_OPS


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 38)]
    assert trace.union_s(iv) == pytest.approx(30e-6)
    assert trace.gaps(iv, 0, 50) == [(20, 30), (40, 50)]
    assert trace.gaps([], 0, 5) == [(0, 5)]


def synthetic(kernels=4, dropped=None):
    """A stretch of 1 s: `kernels` rasterizer launches of 10 ms, each with
    9 small kernels of 1 ms behind it, and a copy."""
    dev, t = [], 0.0
    for _ in range(kernels):
        dev.append(("raster_kernel(float const*)", t, t + 1e4, True))
        for j in range(9):
            dev.append(("elementwise", t + 1e4 + j * 1e3,
                        t + 1e4 + (j + 1) * 1e3, True))
        dev.append(("Memcpy DtoH (Device -> Pinned)", t + 1.9e4,
                    t + 2e4, False))
        t += 1e5
    host = [("cudaStreamSynchronize", 2e4, 1e5)]
    launched = {"raster_kernel": kernels if dropped is None else dropped}
    kept = {"raster_kernel": kernels}
    return {"device": dev, "host": host, "launched": launched,
            "kept": kept, "dropped": {} if dropped is None else
            {"raster_kernel": (kernels, dropped)},
            "wall_s": 1.0, "lo_us": 0.0, "hi_us": 1e6,
            "k1_bytes": kernels * roofline.k1_bytes(256, 8, 512, 512)}


def test_readers_on_a_synthetic_stretch():
    ctx = {"system": "rpm", "trace": synthetic(), "samples": 128,
           "transfer_bytes": 256e6, "captures": 0, "warmup_s": 3.0}
    # busy 4 x 20 ms of 1 s
    assert readers.idle_share(ctx, "rpm") == pytest.approx(92.0)
    # 203.6 MB at 3.35 TB/s is 0.0608 ms against 10 ms a launch
    want = 100 * roofline.k1_bytes(256, 8, 512, 512) / 3.35e12 / 0.01
    assert readers.kernel_roofline(ctx, "rpm") == pytest.approx(want)
    assert readers.kernels_per_batch(ctx, "rpm") == pytest.approx(10.0)
    assert readers.transfer_mb(ctx, "rpm") == pytest.approx(2.0)
    assert readers.captures(ctx, "rpm") == 0
    # another system's cell, or an untraced run, reads nothing
    assert readers.idle_share(ctx, "mg") is None
    assert readers.kernel_roofline({**ctx, "trace": None}, "rpm") is None


def test_the_window_rate_leaves_out_the_profiled_call():
    ctx = {"system": "mg", "samples": 768, "window_s": 16.0,
           "call_n": [256, 256, 256], "call_s": [8.0, 4.0, 4.0],
           "trace": None}
    assert readers.window_rate(ctx, "mg") == pytest.approx(48.0)
    # traced: the first call and its wall are left out
    assert readers.window_rate({**ctx, "trace": synthetic()},
                               "mg") == pytest.approx(64.0)
    assert readers.window_rate(ctx, "rpm") is None
    assert readers.window_rate({**ctx, "call_n": [256], "samples": 256,
                                "trace": synthetic()}, "mg") is None


def test_a_trace_that_dropped_records_is_not_read():
    ctx = {"system": "rpm", "trace": synthetic(dropped=5)}
    assert readers.idle_share(ctx, "rpm") is None
    assert readers.kernel_roofline(ctx, "rpm") is None


def test_breakdown_names_gaps_by_the_host_event():
    b = trace.breakdown(synthetic())
    assert b["device_ops"][0] == ["raster_kernel(float const*)",
                                  pytest.approx(0.04)]
    assert b["device_ops"][1] == ["elementwise", pytest.approx(0.036)]
    assert len(b["idle_gaps"]) <= 10
    # the longest gap, after the last launch, covers no host event
    assert b["idle_gaps"][0] == ["host, no traced call", pytest.approx(0.68)]
    assert ["cudaStreamSynchronize", pytest.approx(0.08)] in b["idle_gaps"]


def test_every_seed_gets_the_same_mix_of_work():
    from collections import Counter
    from benchlib import common, mg, rpm
    modes = ["random", "nested", "adjacent", "intersecting"]
    items = mg.plan(2 ** 31 + 5, 20, modes, 8)
    assert [i for i, _s, _m in items] == list(range(20))
    assert items[:7] == mg.plan(2 ** 31 + 5, 7, modes, 8)
    for seed in (1, 2 ** 31 + 5):
        calls = mg.plan(seed, 16, modes, 8)
        for k in range(2):
            assert Counter(m for _i, _s, m in calls[8 * k:8 * k + 8]) == \
                {m: 2 for m in modes}
    cell = common.load_cell("rpm_grid_dedup1k")
    leaves, weights = rpm.leaves_of(cell["config_data"])
    assert rpm.quotas(1024, weights) == [114] * 7 + [113] * 2
    mixes = []
    for seed in (3, 2 ** 31 + 9):
        ids, nxt = rpm.call_ids(seed, 10, 100, leaves, weights)
        assert len(set(ids)) == 100 and min(ids) >= 10 and nxt > max(ids)
        groups = rpm.assign(seed, ids, leaves, weights)
        mixes.append(sorted((l, len(e)) for l, e in groups.items()))
        again, _ = rpm.call_ids(seed, nxt, 100, leaves, weights)
        assert not set(again) & set(ids)
    assert mixes[0] == mixes[1]


def test_json_diff_counts_leaves():
    a = {"x": 1, "y": [1, 2, {"z": 1.5}], "t": "now"}
    assert compare.json_diff(a, a) == 0
    b = {"x": 2, "y": [1, 2, {"z": 1.25}], "t": "later", "w": 0}
    assert compare.json_diff(b, a, ("t",)) == 3
    assert compare.json_diff({"x": 1.0}, {"x": 1}) == 1


def test_dedup_replay():
    h = ["00" * 8, "01" + "00" * 7, "ff" * 8, "0f" + "00" * 7]
    metas = [{"grid_phash": h[0]}, {"duplicate": True},
             {"grid_phash": h[2]}, {"grid_phash": h[3]}]
    assert compare.kept_violations(metas, 4) == 1     # h[3] is 4 bits off
    assert compare.kept_violations(metas, 3) == 0
    assert compare.duplicate_violation(h[1], metas[:1], 4) == 0
    assert compare.duplicate_violation("f0" * 8, metas[:1], 4) == 1
    assert compare.hamming_hex(h[0], h[2]) == 64
    assert compare.hamming_hex("", h[0]) == 64


def test_png_diff(tmp_path):
    from reasoning_image_generation_tpu_torch.io.png import write_png
    img = np.random.default_rng(0).integers(0, 255, (20, 30, 3), np.uint8)
    p = str(tmp_path / "a.png")
    write_png(p, img)
    assert compare.png_diff(p, img) == 0
    other = img.copy()
    other[3, 4, 1] ^= 1
    assert compare.png_diff(p, other) == 1
    assert compare.png_diff(str(tmp_path / "none.png"), img) == img.size


def test_k2_work_counts_operations_below_the_bytes_bound():
    import torch
    from plainref.models.multigraph.renderer import (prepare_scene_batch,
                                                     scene_batch_to_torch)
    from plainref.models.multigraph.scene import build_scene_batch
    batch, _ = build_scene_batch([3], ["adjacent"], 1.3)
    args = prepare_scene_batch(scene_batch_to_torch(batch,
                                                    torch.device("cpu")), 8)
    nbytes, ops = roofline.k2_work(args, 64, 64)
    assert nbytes == roofline.k2_bytes(1, 64, 64)
    assert ops >= 64 * 64 * roofline.OUT_OPS
