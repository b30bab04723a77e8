# test_bench_harness.py — the harness end to end on the host, at tiny
# sizes: cells added from files alone, the guards, and the check seeing
# each fault the cells can have.
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, run_tiny


@pytest.mark.parametrize("cell", ["tiny_grid", "tiny_full", "tiny_mg"])
def test_a_cell_added_from_files_alone_runs_and_is_correct(tiny_tree, cell):
    out = run_tiny(tiny_tree, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "peak_device_gib"}
    assert list(out)[-1] == "checks"


def test_the_jax_package_and_its_benchmark_files_are_refused(tiny_tree,
                                                            monkeypatch):
    from benchlib import common
    assert common.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "reasoning_image_generation_tpu_torch"
                        ".fake", sys)
    assert common.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert common.forbidden_loaded() == ["jaxlib.xla_client"]
    with pytest.raises(common.BenchError, match="jaxlib"):
        run_tiny(tiny_tree, "tiny_mg")
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    guard = common.OpenGuard()
    with open(os.path.join(ROOT, "bench.py"), "rb"):
        pass
    assert guard.seen and guard.seen[0].endswith("bench.py")


def no_result(cwd):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "rpm_grid_dedup1k", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=cwd, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    return p


def test_no_card_no_result():
    p = no_result(ROOT)
    assert "torch.cuda.is_available() is false" in p.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    no_result(str(tmp_path))


# faults planted under the timed path; each must turn `correct` false

def stale_rpm(monkeypatch):
    """The leaf step hands back its first batch's state for every batch."""
    from reasoning_image_generation_tpu_torch.models.rpm import pipeline
    real, first = pipeline.LeafPipeline.step, {}

    def step(self, keys, use_grid):
        if self.leaf not in first:
            first[self.leaf] = real(self, keys, use_grid)
        return first[self.leaf]
    monkeypatch.setattr(pipeline.LeafPipeline, "step", step)


def half_rpm(monkeypatch):
    """Half of each batch is left out of the export."""
    from reasoning_image_generation_tpu_torch.models.rpm import generator
    real = generator.RPMGenerator._export_batch

    def export(self, leaf, pipe, chunk, sent, metas):
        return real(self, leaf, pipe, chunk[:max(1, len(chunk) // 2)],
                    sent, metas)
    monkeypatch.setattr(generator.RPMGenerator, "_export_batch", export)


def altered_rpm(monkeypatch):
    """A patch of every frame is changed where K1 makes it (large enough
    to survive the grid's downscale)."""
    from reasoning_image_generation_tpu_torch.ops import raster_cuda
    real = raster_cuda.render_frames

    def render(*a, **k):
        out = real(*a, **k).clone()
        out[:, 8:24, 8:24, 0] ^= 255
        return out
    monkeypatch.setattr(raster_cuda, "render_frames", render)


def stale_mg(monkeypatch):
    from reasoning_image_generation_tpu_torch.models.multigraph import (
        generator)
    real, first = generator.render_scene_tensors, []

    def render(scene, dpi):
        if not first:
            first.append(real(scene, dpi))
        return first[0]
    monkeypatch.setattr(generator, "render_scene_tensors", render)


def half_mg(monkeypatch):
    from reasoning_image_generation_tpu_torch.models.multigraph import (
        generator)
    real = generator.GeometryGenerator._dispatch_batch

    def dispatch(self, seeds, modes, save_paths, params_save_paths, dpi):
        n = len(seeds) // 2
        save_paths = list(save_paths[:n]) + [None] * (len(seeds) - n)
        params = list(params_save_paths[:n]) + [None] * (len(seeds) - n)
        return real(self, seeds, modes, save_paths, params, dpi)
    monkeypatch.setattr(generator.GeometryGenerator, "_dispatch_batch",
                        dispatch)


def altered_mg(monkeypatch):
    from reasoning_image_generation_tpu_torch.models.multigraph import (
        generator)
    real = generator.render_scene_tensors

    def render(scene, dpi):
        out = real(scene, dpi).clone()
        out[:, 30, 30, 1] ^= 1
        return out
    monkeypatch.setattr(generator, "render_scene_tensors", render)


@pytest.mark.parametrize("cell,fault", [
    ("tiny_grid", stale_rpm), ("tiny_grid", half_rpm),
    ("tiny_grid", altered_rpm), ("tiny_full", altered_rpm),
    ("tiny_mg", stale_mg), ("tiny_mg", half_mg), ("tiny_mg", altered_mg)],
    ids=lambda x: getattr(x, "__name__", x))
def test_each_fault_turns_correct_false(tiny_tree, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_tree, cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
