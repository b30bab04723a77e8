# test_torch_spans.py — the port's program spans (utils/profiling.py).
"""Spans are recorded exactly while a ``torch.profiler`` session is active,
on the profiler's clock; the generators open the stages they are
documented to open, with their parents and batch ordinals, the export
tasks on the pool's threads under their batch; main-thread stage spans
are mirrored as profiler ranges; ``trace(dir)`` writes the
spans into its Chrome trace.  ``host.pin`` and ``transfer.wait`` are
opened only where a card pins memory and waits on an event: the
benchmark's ``benchmark/tests/test_bench_spans.py`` checks them on a
card."""
import json
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from reasoning_image_generation_tpu_torch.io.writer import ExportPool
from reasoning_image_generation_tpu_torch.models.multigraph.generator import (
    GeometryGenerator)
from reasoning_image_generation_tpu_torch.models.rpm.generator import (
    RPMGenerator)
from reasoning_image_generation_tpu_torch.utils import profiling
from reasoning_image_generation_tpu_torch.utils.config import GenConfig

from .test_torch_generator import _json, _tree, leaf_ids

torch.set_num_threads(1)

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


def profile():
    return torch.profiler.profile(activities=CPU_ONLY)


def new_spans(fn):
    """fn() -> the spans recorded while it ran."""
    n = len(profiling.spans())
    fn()
    return profiling.spans()[n:]


def test_recording_follows_torch_flag():
    """``recording`` is torch's process-wide flag: False outside a session,
    True inside it on the main thread and on a worker thread."""
    assert profiling.recording() is False
    assert profiling.recording() == autograd_profiler._is_profiler_enabled
    seen = []
    with profile():
        assert profiling.recording() is True
        assert profiling.recording() == \
            autograd_profiler._is_profiler_enabled
        t = threading.Thread(target=lambda: seen.append(
            profiling.recording()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen == [True]
    assert profiling.recording() is False


def test_spans_recorded_only_under_the_profiler():
    def outside():
        with profiling.span("outside", bytes=1):
            pass
        assert profiling.begin("outside.batch") is None
        assert profiling.hold() is None
    assert new_spans(outside) == []
    # off, every span site hands back the same no-op context
    assert profiling.span("a") is profiling.span("b", leaf=False, x=1)
    assert profiling.within(None) is profiling.span("a")

    def inside():
        with profile():
            with profiling.span("inside", leaf=False, n=2):
                with profiling.span("inside.leaf", bytes=3):
                    pass
    outer, inner = new_spans(inside)
    assert (outer.name, outer.attrs, outer.leaf) == ("inside", {"n": 2},
                                                     False)
    assert (inner.name, inner.parent, inner.attrs) == ("inside.leaf",
                                                       outer.id, {"bytes": 3})
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert outer.tid == inner.tid == threading.get_native_id()


def test_a_span_opened_while_recording_is_kept_after_the_session():
    def run():
        with profile():
            batch = profiling.begin("late.batch", batch=0)
        profiling.release(batch)
    (batch,) = new_spans(run)
    assert batch.end_ns is not None and batch.end_ns >= batch.start_ns


def test_batch_closes_at_its_last_release_on_any_thread():
    """An envelope closes at the latest of its releases, once each hold
    is released; tasks released on many threads at once never close it
    early or leave it open.  A short switch interval makes the threads
    interleave inside ``release``."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(), ThreadPoolExecutor(max_workers=16) as pool:
            for _ in range(20):
                batch = profiling.begin("stress.batch")
                with profiling.within(batch):
                    held = [profiling.hold() for _ in range(64)]
                assert all(h is batch for h in held)
                list(pool.map(profiling.release, held, timeout=60))
                assert batch.end_ns is None   # the opener still holds it
                profiling.release(batch)
                assert batch.end_ns == max(batch._ends)
                assert len(batch._ends) == 65
    finally:
        sys.setswitchinterval(old)


def test_export_tasks_run_under_their_batch_on_the_workers():
    pool = ExportPool(workers=3)

    def run():
        with profile():
            batch = profiling.begin("t.batch", batch=7)
            with profiling.within(batch), profiling.span("t.export"):
                futs = [pool.submit_task(sum, [i, 1], kind="meta")
                        for i in range(5)]
            profiling.release(batch)
            pool.drain()
        assert [f.result() for f in futs] == [1, 2, 3, 4, 5]
    sps = new_spans(run)
    pool.close()
    batch = next(s for s in sps if s.name == "t.batch")
    tasks = [s for s in sps if s.name == "export.task"]
    drain = next(s for s in sps if s.name == "export.drain")
    assert len(tasks) == 5
    assert {s.parent for s in tasks} == {batch.id}
    assert {s.attrs["fn"] for s in tasks} == {"meta"}
    assert {s.attrs["workers"] for s in tasks} == {3}
    assert threading.get_native_id() not in {s.tid for s in tasks}
    assert batch.end_ns >= max(s.end_ns for s in tasks)
    assert drain.parent is None and drain.leaf


def _spans_by_name(sps):
    out = {}
    for s in sps:
        out.setdefault(s.name, []).append(s)
    return out


def _check_tree(by, system):
    """The call, its batches (ordinals 0..), the batches' stages and
    export tasks, each under its parent; every span closed."""
    main = threading.get_native_id()
    (call,) = by[f"{system}.call"]
    batches = by[f"{system}.batch"]
    ids = {b.id for b in batches}
    assert [b.attrs["batch"] for b in batches] == list(range(len(batches)))
    assert {b.parent for b in batches} == {call.id}
    for name in (f"{system}.dispatch", f"{system}.export"):
        assert sorted(s.parent for s in by[name]) == sorted(ids), name
        assert {s.tid for s in by[name]} == {main}
        assert all(s.leaf for s in by[name])
    tasks = by["export.task"]
    assert {s.parent for s in tasks} <= ids
    assert main not in {s.tid for s in tasks}
    for b in batches:
        mine = [t for t in tasks if t.parent == b.id]
        assert b.end_ns >= max([t.end_ns for t in mine], default=b.start_ns)
    for s in sum(by.values(), []):
        assert s.end_ns is not None and s.end_ns >= s.start_ns, s.name
    return call, batches, tasks


def test_rpm_generate_ids_records_its_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "stats"))
    gen = RPMGenerator(GenConfig(out_dir=str(tmp_path / "out"),
                                 batch_size=2, canvas_size=(64, 64), seed=0),
                       torch.device("cpu"), io_workers=2)
    ids = [0, 1, 2, 3, 4]

    def run():
        with profile():
            gen.generate_ids(ids)
    by = _spans_by_name(new_spans(run))
    gen.close()
    call, batches, tasks = _check_tree(by, "rpm")
    assert call.attrs == {"n": len(ids)}
    assert sum(b.attrs["n_real"] for b in batches) == len(ids)
    # frames shipped by stream: full export ships every state and option
    for b in batches:
        n, L = b.attrs["n_real"], gen._pipelines[b.attrs["leaf"]].L
        assert (b.attrs["grid"], b.attrs["state"], b.attrs["opt"]) == \
            (n, n * L, n * gen.cfg.num_options)
    assert {b.attrs["leaf"] for b in batches} == {
        p[-1] for p in (e[1] for g in gen._sample_assignments(ids).values()
                        for e in g)}
    assert {t.attrs["fn"] for t in tasks} == {"png", "meta"}
    assert sum(t.attrs["fn"] == "meta" for t in tasks) == len(ids)
    (drain,) = by["export.drain"]
    assert drain.parent == call.id
    assert set(by) == {"rpm.call", "rpm.batch", "rpm.dispatch",
                       "rpm.export", "export.task", "export.drain"}


def test_mg_generate_batches_records_its_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "stats"))
    gen = GeometryGenerator(torch.device("cpu"), io_workers=2)
    seeds, modes = [1, 2, 3], ["adjacent", "nested", "random"]
    out = tmp_path / "mg"

    def run():
        with profile():
            gen.generate_batches(seeds, modes,
                                 [str(out / f"{i}.png") for i in seeds],
                                 [str(out / f"{i}.json") for i in seeds],
                                 dpi=25, batch_size=2)
        gen.close()          # the last batch's files finish after the call
    by = _spans_by_name(new_spans(run))
    call, batches, tasks = _check_tree(by, "mg")
    assert [b.attrs for b in batches] == [
        {"batch": 0, "mode": "adjacent,nested", "n_real": 2},
        {"batch": 1, "mode": "random", "n_real": 1}]
    assert sorted(s.parent for s in by["mg.scene_build"]) == \
        [b.id for b in batches]
    assert sorted(t.attrs["fn"] for t in tasks) == ["png_rle3"] * 3 + \
        ["qc"] * 3
    # the pool drains at close, after the session: no export.drain
    assert set(by) == {"mg.call", "mg.batch", "mg.scene_build",
                       "mg.dispatch", "mg.export", "export.task"}


def test_mirrored_spans_lie_on_their_profiler_ranges():
    """A main-thread stage span and its profiler range agree within 1 ms,
    on one clock; the range is of the operator kind, not a user
    annotation (which the profiler would also lay over the device's
    timeline); envelopes and worker spans are not mirrored."""
    pool = ExportPool(workers=2)
    n = len(profiling.spans())
    with profile() as prof:
        with profiling.span("m.call", leaf=False):
            batch = profiling.begin("m.batch")
            with profiling.within(batch):
                for i in range(3):
                    with profiling.span("m.stage", i=i):
                        torch.ones(64).sum()
                        with profiling.span("m.inner"):
                            torch.ones(8).sum()
                pool.submit(sum, [1, 2])
            profiling.release(batch)
            pool.drain()
    sps = profiling.spans()[n:]
    pool.close()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in ("m.stage", "m.inner", "export.drain"):
        mine = sorted((s.start_ns, s.end_ns) for s in sps if s.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) > 0, name
        for (s0, s1), (e0, e1) in zip(mine, theirs):
            assert abs(s0 - e0) < 1e6 and abs(s1 - e1) < 1e6, name
            assert s0 <= e0 and e1 <= s1, name
    for name in ("m.call", "m.batch", "export.task"):
        assert name not in events
    kinds = {e.name(): e.is_user_annotation()
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("m.")}
    assert kinds == {"m.stage": False, "m.inner": False}


def test_trace_writes_the_program_spans_worker_threads_included(tmp_path):
    pool = ExportPool(workers=2)
    with profiling.trace(str(tmp_path / "prof")):
        batch = profiling.begin("w.batch", batch=0)
        with profiling.within(batch), profiling.span("w.stage"):
            pool.submit(sum, [1, 2], kind="png")
        profiling.release(batch)
        pool.drain()
    pool.close()
    (path,) = (tmp_path / "prof").glob("trace_*.json")
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    ours = {e["name"]: e for e in doc["traceEvents"]
            if e.get("cat") == "program"}
    assert set(ours) == {"w.batch", "w.stage", "export.task",
                         "export.drain"}
    task, batch_ev = ours["export.task"], ours["w.batch"]
    assert task["ph"] == "X" and task["args"]["fn"] == "png"
    assert task["args"]["parent"] == batch_ev["args"]["span"]
    assert task["tid"] != threading.get_native_id()
    assert ours["w.stage"]["tid"] == threading.get_native_id()
    # on the profiler's time base: the mirrored stage on its own range
    (rf,) = [e for e in doc["traceEvents"]
             if e["name"] == "w.stage" and e.get("cat") != "program"]
    assert abs(rf["ts"] - ours["w.stage"]["ts"]) < 1000


@pytest.mark.parametrize("site", ["span", "begin", "within"])
def test_a_span_site_without_recording_adds_nothing(site):
    def run():
        for _ in range(1000):
            if site == "span":
                with profiling.span("x", bytes=1):
                    pass
            elif site == "begin":
                profiling.release(profiling.begin("x", batch=0))
            else:
                with profiling.within(profiling.begin("x")):
                    assert profiling.hold() is None
    assert new_spans(run) == []


def _files(root: str) -> dict:
    """Every file under `root` by relative path: PNGs as their bytes,
    JSON with the output directory and the wall-clock fields taken out."""
    out = {}
    for rel in _tree(root):
        path = os.path.join(root, rel)
        if rel.endswith(".png"):
            with open(path, "rb") as f:
                out[rel] = f.read()
        else:
            out[rel] = _json(path, root)
    return out


def test_rpm_overflow_spans_count_the_raw_fallbacks(tmp_path, monkeypatch):
    """--sparse rle4d with frozen tiers of one run a frame: frames over
    them are fetched raw in ``transfer.overflow`` spans under
    ``rpm.export``, whose frames and re-freezes add up to the generator's
    ``overflow_frames`` and ``tiers_refrozen``, whose bytes are those
    frames', beside the batches' frames shipped; the tree is the raw
    transfer's byte for byte; and with no session nothing is recorded."""
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "stats"))
    leaf = "翻转(镜像)"
    ids = leaf_ids(leaf, per_mode=2)

    def gen_of(name, **kw):
        cfg = GenConfig(out_dir=str(tmp_path / name), seed=0, batch_size=1,
                        canvas_size=(128, 128), use_mesh=False, **kw)
        gen = RPMGenerator(cfg, torch.device("cpu"), io_workers=2)
        if kw:
            gen._run_stats.update({f"{leaf}:grid_img_packed:T": 1.0,
                                   f"{leaf}:state_imgs_packed:T": 1.0})
        return gen

    def run(gen):
        gen.generate_ids(ids)
        gen.close()
    raw = gen_of("raw")
    quiet = gen_of("quiet", sparse_transfer=True, transfer_codec="rle4d")
    assert new_spans(lambda: (run(raw), run(quiet))) == []
    assert quiet.overflow_frames > 0
    gen = gen_of("out", sparse_transfer=True, transfer_codec="rle4d")

    def traced():
        with profile():
            run(gen)
    by = _spans_by_name(new_spans(traced))
    over = by["transfer.overflow"]
    assert gen.overflow_frames > 0 and gen.tiers_refrozen >= 1
    assert sum(s.attrs[n] for s in over for n in ("grid", "state", "opt")) \
        == gen.overflow_frames
    assert sum(s.attrs["refrozen"] for s in over) == gen.tiers_refrozen
    pipe = gen._pipelines[leaf]
    frame = 128 * 128 * 3
    assert [s.attrs["bytes"] for s in over] == [
        s.attrs["grid"] * pipe.layout.grid_h * 128 * 3
        + (s.attrs["state"] + s.attrs["opt"]) * frame for s in over]
    exports = {s.id for s in by["rpm.export"]}
    assert all(s.parent in exports and s.leaf for s in over)
    assert {s.tid for s in over} == {threading.get_native_id()}
    batches = by["rpm.batch"]
    assert [sum(b.attrs[n] for b in batches) for n in ("grid", "state",
                                                       "opt")] == \
        [len(ids), len(ids) * pipe.L, len(ids) * gen.cfg.num_options]
    want = _files(str(tmp_path / "raw"))
    assert _files(str(tmp_path / "out")) == want
    assert _files(str(tmp_path / "quiet")) == want
