# test_bench_full_export.py — the full-export cells: a tiny cell of the
# --sparse rle4d configuration on the host, correct against the frozen
# reference and false with one decoded frame off, and the readers of the
# export threads' task kinds and of the raw fallbacks on synthetic spans.
import json
import os
import threading

import pytest

from benchlib import common, export_spans
from conftest import BENCH, LIMITS_RPM, add_cell, run_tiny
from test_bench_arith import synthetic
from test_bench_spans import ctx_of, program, rpm_spans, span

# runs a frame on the device in the tiny cell, half the default of 1024
# at 128x128: about a third of its frames overflow and come raw, and
# tiers are re-frozen (the palette's 255 rows need at least 255)
TINY_BUDGET = 512

NEW_READERS = ["rpm.png_busy_share", "rpm.decode_busy_share",
               "rpm.overflow_frame_share"]


@pytest.fixture
def sparse_tree(tiny_tree):
    """The tiny tree with ``tiny_sparse``: tiny_full's traffic on the
    rle4d configuration at 128x128, batch 4 and a small run budget."""
    with open(os.path.join(BENCH, "configs", "rpm_3x3_512_rle4d.json")) as f:
        cfg = json.load(f)
    assert cfg["settings"]["sparse_transfer"] is True
    assert cfg["settings"]["transfer_codec"] == "rle4d"
    cfg["settings"].update(canvas_size=[128, 128], batch_size=4,
                           rle_budget=TINY_BUDGET)
    add_cell(tiny_tree, "tiny_sparse", "rpm_tiny_rle4d", cfg, "tiny_full",
             {"grid_only": False, "dedup": False, "dedup_threshold": 4,
              "ids_per_call": 8}, LIMITS_RPM, "rpm_full_sparse")
    return tiny_tree


@pytest.fixture
def generators(monkeypatch):
    """Every RPM generator the run closes."""
    from reasoning_image_generation_tpu_torch.models.rpm import generator
    seen, real = [], generator.RPMGenerator.close

    def close(self):
        seen.append(self)
        return real(self)
    monkeypatch.setattr(generator.RPMGenerator, "close", close)
    return seen


def test_the_packed_cell_falls_back_raw_and_is_correct(sparse_tree,
                                                       generators):
    out = run_tiny(sparse_tree, "tiny_sparse")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "peak_device_gib"}
    (gen,) = generators
    assert gen.cfg.sparse_transfer and gen.cfg.transfer_codec == "rle4d"
    assert gen.overflow_frames > 0 and gen.tiers_refrozen > 0


def test_one_decoded_frame_off_by_one_turns_correct_false(sparse_tree,
                                                          monkeypatch):
    """The first frame of the window decoded from its inter-frame delta
    comes out one higher in one channel of one pixel.  The window's one
    call is checked whole (two ids of each leaf, one a call); set-up's
    warm call, whose files are not checked, ends with its index."""
    from reasoning_image_generation_tpu_torch import cli
    from reasoning_image_generation_tpu_torch.ops import rle
    real, lock, hit = rle.Rle3Frames.unpack_delta, threading.Lock(), []
    armed, write_index = [], cli.write_index

    def arm(*a, **k):
        armed.append(True)
        return write_index(*a, **k)

    def unpack_delta(self, *a, **k):
        px = real(self, *a, **k)
        with lock:
            if hit or not armed:
                return px
            hit.append(True)
        px = px.copy()
        px[0, 0, 0] = (int(px[0, 0, 0]) + 1) % 256
        return px
    monkeypatch.setattr(cli, "write_index", arm)
    monkeypatch.setattr(rle.Rle3Frames, "unpack_delta", unpack_delta)
    out = run_tiny(sparse_tree, "tiny_sparse")
    assert hit
    assert out["checks"]["px_mismatch"]["value"] > 0
    assert out["correct"] is False


# the readers on synthetic spans (test_bench_spans.py's stretch of 1 s)

def export_spans_of_a_sparse_call():
    """rpm_spans' call with frame counts on its batches (batch 0: 32
    grids, 128 states, 128 options; batch 1: 32, 192, 128), two raw
    fallbacks under the exports, and its tasks as png_rle3 and
    delta_sample; one more png task that ends outside the stretch."""
    sps = rpm_spans()
    frames = {2: (32, 128, 128), 5: (32, 192, 128)}
    for s in sps:
        if s.id in frames:
            s.attrs.update(zip(export_spans.STREAMS, frames[s.id]))
        if s.id == 10:
            s.attrs["fn"] = "png_rle3"       # 300 ms in the stretch
        if s.id == 13:
            s.attrs["fn"] = "delta_sample"   # 800 ms in the stretch
    sps += [
        span(20, "transfer.overflow", 52_000, 58_000, parent=8, grid=1,
             state=4, opt=0, bytes=1, refrozen=0),
        span(21, "transfer.overflow", 152_000, 153_000, parent=11, grid=0,
             state=2, opt=1, bytes=1, refrozen=1),
        span(22, "export.task", 900_000, 1_100_000, parent=5,
             tid=100 + 300, leaf=False, fn="png", workers=2),
    ]
    return sps


def test_task_shares_by_kind(monkeypatch):
    program(monkeypatch, export_spans_of_a_sparse_call())
    ctx = ctx_of()
    # png_rle3 300 ms + png 100 ms inside the stretch, over 2 workers x 1 s
    assert common.load_reader("rpm.png_busy_share")(ctx) == \
        pytest.approx(20.0)
    assert common.load_reader("rpm.decode_busy_share")(ctx) == \
        pytest.approx(40.0)
    assert export_spans.task_busy_share(ctx, "rpm", ("meta",)) is None


def test_overflow_frame_share_counts_every_stream(monkeypatch):
    program(monkeypatch, export_spans_of_a_sparse_call())
    # 8 frames raw of 32 + 128 + 128 + 32 + 192 + 128 = 640 shipped
    assert common.load_reader("rpm.overflow_frame_share")(ctx_of()) == \
        pytest.approx(1.25)
    sps = [s for s in export_spans_of_a_sparse_call()
           if s.name != "transfer.overflow"]
    program(monkeypatch, sps)
    assert common.load_reader("rpm.overflow_frame_share")(ctx_of()) == 0.0


@pytest.mark.parametrize("name", NEW_READERS)
def test_each_new_reader_reads_none_without_its_spans(monkeypatch, name):
    read = common.load_reader(name)
    program(monkeypatch, export_spans_of_a_sparse_call())
    ctx = ctx_of()
    assert isinstance(read(ctx), float)
    # another system's cell, an untraced run, a trace that dropped records
    assert read({**ctx, "system": "mg"}) is None
    assert read({**ctx, "trace": None}) is None
    assert read({**ctx, "trace": synthetic(dropped=5)}) is None
    # a program that records no spans, or none of the call's
    program(monkeypatch, None)
    assert read(ctx) is None
    program(monkeypatch, [s for s in export_spans_of_a_sparse_call()
                          if s.name != "rpm.call"])
    assert read(ctx) is None
    # a cell with none of its spans: the raw grid-only call of rpm_spans,
    # its tasks meta alone, from a program without frame counts
    sps = rpm_spans()
    for s in sps:
        if s.name == "export.task":
            s.attrs["fn"] = "meta"
    program(monkeypatch, sps)
    assert read(ctx) is None


def test_the_new_cells_report_the_new_readers():
    man = common.manifest()
    for name in NEW_READERS:
        cells = next(m for m in man["per_layer"]
                     if m["name"] == name)["workloads"]
        assert "rpm_full_sparse" in cells
        assert ("rpm_full_export" in cells) == (name == "rpm.png_busy_share")
    for cell in ("rpm_full_export", "rpm_full_sparse"):
        names = {m["name"] for m in common.cell_metrics(man, cell,
                                                        "per_layer")}
        assert {"k1_roofline", "rpm.transfer_mb_per_sample",
                "rpm.pool_busy_share", "graphs.warmup_s"} <= names
        # the packed cell's traced call takes 33-56 s on an H100, so its
        # 51 s window may hold no other call for the window's rate
        assert ("rpm.window_samples_per_s" in names) == \
            (cell == "rpm_full_export")
