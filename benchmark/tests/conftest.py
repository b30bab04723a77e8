# conftest.py — the benchmark's own tests: paths, the card fixture and a
# copy of the benchmark with tiny cells that run on the host.
"""Run with ``python -m pytest benchmark/tests -q`` from the root of the
repository.  Tests that need a card take the ``card`` fixture, which skips
without one; the rest run on the host."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# the harness pins each math library to one thread for its run; a test
# process keeps the pool it starts with
torch.set_num_threads(torch.get_num_threads())

LIMITS_RPM = {"missing": 0, "keep_violations": 0, "px_mismatch": 0,
              "json_mismatch": 0, "phash_bits": 0}
LIMITS_MG = {"missing": 0, "px_mismatch": 0, "json_mismatch": 0}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def add_cell(root: str, name: str, config: str, config_data: dict,
             traffic: str, traffic_data: dict, limits: dict,
             like: str) -> None:
    """A cell from files alone: its configuration, traffic mix and cell
    files under ``<root>/benchmark``, and its entry in the manifest, which
    reports the metrics that the cell `like` reports."""
    b = os.path.join(root, "benchmark")
    for sub, fname, data in (("configs", config, config_data),
                             ("traffic", traffic, traffic_data)):
        with open(os.path.join(b, sub, f"{fname}.json"), "w") as f:
            json.dump(data, f)
    with open(os.path.join(b, "workloads", f"{name}.json"), "w") as f:
        json.dump({"config": config, "traffic": traffic, "chips": 1,
                   "limits": limits, "why": "a test's tiny cell"}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    man["workloads"].append({"name": name, "config": config,
                             "traffic": traffic, "chips": 1,
                             "why": "a test's tiny cell"})
    for m in man["end_to_end"] + man["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(man, f)


@pytest.fixture
def tiny_tree(tmp_path, monkeypatch):
    """A copy of the benchmark with three tiny cells: RPM grid-only with
    the dedup and RPM full export on 128x128 canvases, and mg at 96 px."""
    root = str(tmp_path / "root")
    os.makedirs(root)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    with open(os.path.join(BENCH, "configs", "rpm_3x3_512.json")) as f:
        rpm = json.load(f)
    rpm["settings"].update(canvas_size=[128, 128], batch_size=4)
    with open(os.path.join(BENCH, "configs", "mg_1600_dpi200.json")) as f:
        mg = json.load(f)
    mg["settings"].update(dpi=12, canvas_px=96, batch_size=4)
    add_cell(root, "tiny_grid", "rpm_tiny", rpm, "tiny_grid",
             {"grid_only": True, "dedup": True, "dedup_threshold": 4,
              "ids_per_call": 12}, LIMITS_RPM, "rpm_grid_dedup1k")
    add_cell(root, "tiny_full", "rpm_tiny", rpm, "tiny_full",
             {"grid_only": False, "dedup": False, "dedup_threshold": 4,
              "ids_per_call": 8}, LIMITS_RPM, "rpm_grid_dedup1k")
    add_cell(root, "tiny_mg", "mg_tiny", mg, "tiny_mg",
             {"modes": ["random", "nested", "adjacent", "intersecting"],
              "scenes_per_call": 8}, LIMITS_MG, "mg_four_modes")
    from benchlib import common
    for var in common.THREAD_VARS + ("RIG_TORCH_CACHE", "USE_FLAX"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    return root


def run_tiny(root: str, cell: str, seed: int = 2 ** 31 + 11,
             seconds: float = 0.5) -> dict:
    """One run of a tiny cell on the host, through the harness's main."""
    import run
    return run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     str(seconds), "--trace", "0"], device_name="cpu",
                    base=os.path.join(root, "benchmark"), manifest_root=root)
