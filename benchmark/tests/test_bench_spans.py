# test_bench_spans.py — the readers of the program's spans
# (benchlib/spans.py, metrics/*_share.py, metrics/*.batch_to_disk_s.py) on
# synthetic spans and device intervals, and on a card the spans the
# program records under the stretch's profiler.
import os
import threading
from types import SimpleNamespace

import pytest

from benchlib import common, spans

from test_bench_arith import synthetic

MAIN, WORKER = 100, 200


def span(id_, name, start_us, end_us, parent=None, tid=MAIN, leaf=True,
         **attrs):
    return SimpleNamespace(id=id_, name=name, parent=parent, tid=tid,
                           start_ns=start_us * 1e3,
                           end_ns=None if end_us is None else end_us * 1e3,
                           attrs=attrs, leaf=leaf)


def program(monkeypatch, sps):
    monkeypatch.setattr(spans, "program_spans", lambda: sps)


def ctx_of(system="rpm", **tr):
    return {"system": system, "trace": {**synthetic(), **tr}}


def rpm_spans():
    """One call over the synthetic stretch of 1 s (device busy 0-20 ms of
    each of the first four 100 ms): two batches, each a dispatch with a
    pin inside it and an export with a copy wait inside it, two tasks on
    two workers, the last running past the stretch; a drain at the end."""
    return [
        span(1, "rpm.call", 0, 900_000, leaf=False),
        span(2, "rpm.batch", 10_000, 400_000, parent=1, leaf=False,
             batch=0),
        span(3, "rpm.dispatch", 10_000, 30_000, parent=2),
        span(4, "host.pin", 12_000, 17_000, parent=3),
        span(5, "rpm.batch", 30_000, 1_200_000, parent=1, leaf=False,
             batch=1),
        span(6, "rpm.dispatch", 30_000, 50_000, parent=5),
        span(7, "host.pin", 40_000, 45_000, parent=6),
        span(8, "rpm.export", 50_000, 150_000, parent=2),
        span(9, "transfer.wait", 50_000, 60_000, parent=8),
        span(10, "export.task", 100_000, 400_000, parent=2, tid=WORKER,
             leaf=False, fn="png", workers=2),
        span(11, "rpm.export", 150_000, 250_000, parent=5),
        span(12, "transfer.wait", 150_000, 155_000, parent=11),
        span(13, "export.task", 200_000, 1_200_000, parent=5,
             tid=WORKER + 1, leaf=False, fn="meta", workers=2),
        span(14, "export.drain", 800_000, 900_000, parent=1),
        # a span still open, and one of another session: not read
        span(15, "rpm.dispatch", 950_000, None, parent=1),
        span(16, "rpm.dispatch", -50_000, -10_000),
    ]


def test_self_time_leaves_out_children_and_other_threads(monkeypatch):
    program(monkeypatch, rpm_spans())
    ctx = ctx_of()
    # dispatch 2 x 20 ms less pins 2 x 5 ms, of a 1 s wall
    assert spans.self_share(ctx, "rpm", "rpm.dispatch") == \
        pytest.approx(3.0)
    assert spans.self_share(ctx, "rpm", "host.pin") == pytest.approx(1.0)
    assert spans.self_share(ctx, "rpm", "transfer.wait") == \
        pytest.approx(1.5)
    # export 2 x 100 ms less the waits; the tasks are another thread's
    assert spans.self_share(ctx, "rpm", "rpm.export") == \
        pytest.approx(18.5)
    assert spans.self_share(ctx, "rpm", "export.drain") == \
        pytest.approx(10.0)
    assert spans.self_share(ctx, "rpm", "mg.scene_build") == 0.0


def test_children_that_overlap_count_once(monkeypatch):
    program(monkeypatch, [
        span(1, "rpm.call", 0, 1_000_000, leaf=False),
        span(2, "rpm.export", 0, 100_000, parent=1),
        span(3, "transfer.wait", 10_000, 40_000, parent=2),
        span(4, "export.drain", 30_000, 50_000, parent=2)])
    # 100 ms less the union 10-50 ms
    assert spans.self_share(ctx_of(), "rpm", "rpm.export") == \
        pytest.approx(6.0)


def test_spans_are_clipped_to_the_stretch(monkeypatch):
    program(monkeypatch, [
        span(1, "mg.call", -100_000, 600_000, leaf=False),
        span(2, "mg.scene_build", -100_000, 100_000, parent=1),
        span(3, "mg.scene_build", 900_000, 1_300_000, parent=1),
        span(4, "mg.batch", -100_000, 200_000, parent=1, leaf=False),
        span(5, "mg.batch", 500_000, 2_500_000, parent=1, leaf=False)])
    ctx = ctx_of("mg")
    # 100 ms inside from the first, 100 ms from the second
    assert spans.self_share(ctx, "mg", "mg.scene_build") == \
        pytest.approx(20.0)
    # only the batch dispatched in the stretch, whole
    assert spans.batch_to_disk_s(ctx, "mg") == pytest.approx(2.0)


def test_pool_busy_share_divides_by_the_programs_workers(monkeypatch):
    sps = rpm_spans()
    program(monkeypatch, sps)
    # 300 ms + 800 ms inside the stretch, over 2 workers x 1 s
    assert spans.pool_busy_share(ctx_of(), "rpm") == pytest.approx(55.0)
    for s in sps:
        if s.name == "export.task":
            s.attrs["workers"] = 8
    assert spans.pool_busy_share(ctx_of(), "rpm") == pytest.approx(13.75)
    program(monkeypatch, [s for s in sps if s.name != "export.task"])
    assert spans.pool_busy_share(ctx_of(), "rpm") is None


def test_idle_attribution_counts_overlapping_stage_spans_once(monkeypatch):
    # device busy [0, 20 ms) of the first four 100 ms: idle 920 ms
    program(monkeypatch, [
        span(1, "rpm.call", 0, 1_000_000, leaf=False),
        span(2, "rpm.batch", 0, 1_000_000, parent=1, leaf=False),
        # 10-70 ms, with a child and an overlapping sibling: 20-70 idle
        span(3, "rpm.export", 10_000, 70_000, parent=2),
        span(4, "transfer.wait", 30_000, 50_000, parent=3),
        span(5, "export.drain", 60_000, 90_000, parent=1),
        # a worker's span and an envelope cover nothing
        span(6, "export.task", 100_000, 1_000_000, parent=2, tid=WORKER,
             leaf=False, workers=1),
    ])
    # attributed 20-90 ms of the first gap: 70 of 920 ms
    assert spans.idle_unattributed_share(ctx_of(), "rpm") == \
        pytest.approx(100 * 850 / 920)
    program(monkeypatch, [span(1, "rpm.call", 0, 1_000_000, leaf=False),
                          span(2, "rpm.dispatch", 0, 1_000_000, parent=1)])
    assert spans.idle_unattributed_share(ctx_of(), "rpm") == \
        pytest.approx(0.0)


def test_batch_to_disk_is_the_median_batch(monkeypatch):
    program(monkeypatch, rpm_spans())
    # 0.39 s and 1.17 s: an even count takes the mean of the middle two
    assert spans.batch_to_disk_s(ctx_of(), "rpm") == pytest.approx(0.78)


def test_merge_and_overlap():
    assert spans.merge([(5, 9), (0, 3), (2, 4), (9, 10), (7, 7)]) == \
        [(0, 4), (5, 10)]
    assert spans.overlap([(0, 4), (5, 10)], [(3, 6), (8, 20)]) == 4


READERS = ["rpm.dispatch_share", "rpm.pin_share", "rpm.copy_wait_share",
           "rpm.export_share", "rpm.drain_wait_share", "rpm.pool_busy_share",
           "rpm.idle_unattributed_share", "rpm.batch_to_disk_s",
           "mg.dispatch_share", "mg.pin_share", "mg.copy_wait_share",
           "mg.export_share", "mg.scene_build_share", "mg.pool_busy_share",
           "mg.idle_unattributed_share", "mg.batch_to_disk_s"]


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_its_system_and_nothing_else(monkeypatch, name):
    system = name.split(".")[0]
    sps = rpm_spans()
    for s in sps:
        s.name = s.name.replace("rpm.", f"{system}.")
    if system == "mg":
        sps.append(span(20, "mg.scene_build", 300_000, 310_000, parent=1))
    program(monkeypatch, sps)
    read = common.load_reader(name)
    ctx = ctx_of(system)
    assert isinstance(read(ctx), float)
    # another system's cell, an untraced run, a trace that dropped records
    assert read({**ctx, "system": "mg" if system == "rpm" else "rpm"}) \
        is None
    assert read({**ctx, "trace": None}) is None
    assert read({**ctx, "trace": synthetic(dropped=5)}) is None
    # a program that records no spans, or none of this system's calls
    program(monkeypatch, None)
    assert read(ctx) is None
    program(monkeypatch, [s for s in sps if not s.name.endswith(".call")])
    assert read(ctx) is None


def test_an_older_program_without_spans_reads_none(monkeypatch):
    from reasoning_image_generation_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert spans.program_spans() is None
    assert spans.self_share(ctx_of(), "rpm", "rpm.dispatch") is None


def test_the_card_records_pins_and_copy_waits_on_the_profilers_clock(
        card, tmp_path, monkeypatch):
    """A tiny RPM call on the card inside the stretch: ``host.pin`` under
    ``rpm.dispatch``, ``transfer.wait`` under ``rpm.export``, each
    mirrored stage on its host range within 1 ms and on no device event,
    the stage spans inside the stretch's bounds, and every reader of the
    RPM cell reads a number."""
    import torch
    from benchlib import trace
    from reasoning_image_generation_tpu_torch.models.rpm.generator import (
        RPMGenerator)
    from reasoning_image_generation_tpu_torch.ops import raster_cuda
    from reasoning_image_generation_tpu_torch.utils import profiling
    from reasoning_image_generation_tpu_torch.utils.config import GenConfig
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "stats"))
    gen = RPMGenerator(GenConfig(out_dir=str(tmp_path / "out"), batch_size=4,
                                 canvas_size=(128, 128), seed=3,
                                 grid_only=True), card, io_workers=2)
    ids = list(range(12))
    gen.generate_ids(ids, dedup=True)           # captures every graph
    n = len(profiling.spans())
    stretch = trace.Stretch({"raster_kernel": raster_cuda})
    with stretch:
        gen.generate_ids(list(range(12, 24)), dedup=True)
    mirrored = {}
    for e in stretch._prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            mirrored.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    summary = stretch.reduce()
    gen.close()
    sps = profiling.spans()[n:]
    by = {}
    for s in sps:
        by.setdefault(s.name, []).append(s)
    ids_of = {s.id: s for s in sps}
    assert {ids_of[s.parent].name for s in by["host.pin"]} == \
        {"rpm.dispatch"}
    assert {ids_of[s.parent].name for s in by["transfer.wait"]} == \
        {"rpm.export"}
    assert all(s.attrs["bytes"] > 0 for s in by["host.pin"])
    main = threading.get_native_id()
    for name in ("rpm.dispatch", "host.pin", "transfer.wait", "rpm.export",
                 "export.drain"):
        mine = sorted((s.start_ns, s.end_ns) for s in by[name]
                      if s.tid == main)
        theirs = sorted(mirrored[name])
        assert len(mine) == len(theirs) > 0, name
        for (s0, s1), (e0, e1) in zip(mine, theirs):
            assert abs(s0 - e0) < 1e6 and abs(s1 - e1) < 1e6, name
        assert summary["lo_us"] * 1e3 - 1e6 < mine[0][0]
        assert mine[-1][1] < summary["hi_us"] * 1e3 + 1e6
    names = {s.name for s in sps}
    assert not [d for d in summary["device"] if d[0] in names]
    ctx = {"system": "rpm", "trace": summary}
    assert not summary["dropped"]
    for name in READERS[:8]:
        v = common.load_reader(name)(ctx)
        assert isinstance(v, float) and v >= 0, name
    assert os.path.isdir(str(tmp_path / "out"))
