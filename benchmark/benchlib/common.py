# common.py — what every cell's run shares: its files, its pinned state,
# the card check, the guards and the result line.
"""The benchmark is driven by data.  A cell is ``workloads/<cell>.json``
(its configuration's and traffic mix's names, its cards, the limits of its
check and why); a traffic mix is ``traffic/<traffic>.json`` (the
parameters its system's runner reads); a configuration is
``configs/<config>.json`` (its source, settings, what was assumed and
what was reduced, and the ``system`` whose runner runs it:
``benchlib/<system>.py``);
a per-layer metric is ``metrics/<metric>.py`` with a ``read(ctx)``.  All
are found by name, so a later cell, configuration or metric is new files
and new entries in ``BENCHMARK.json``, and no edit.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

# modules that no process of the benchmark may hold, compared by the part
# of the name before the first dot (the port's own name begins with the
# last one's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "reasoning_image_generation_tpu")

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


class BenchError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str, base: str = HERE) -> dict:
    """The cell `name`, with its traffic mix's parameters under
    ``traffic`` and its configuration under ``config_data``."""
    path = os.path.join(base, "workloads", f"{name}.json")
    if not os.path.isfile(path):
        raise BenchError(f"no cell {name!r}: {path} is not there")
    cell = load_json(path)
    cell["name"] = name
    cell["traffic_name"] = cell["traffic"]
    cell["traffic"] = load_json(
        os.path.join(base, "traffic", f"{cell['traffic']}.json"))
    cell["config_data"] = load_json(
        os.path.join(base, "configs", f"{cell['config']}.json"))
    return cell


def manifest(base: str = ROOT) -> dict:
    return load_json(os.path.join(base, "BENCHMARK.json"))


def cell_metrics(man: dict, cell: str, kind: str) -> list:
    """The entries of `kind` ('end_to_end' or 'per_layer') that `cell`
    reports: those without ``workloads`` and those that list it."""
    return [m for m in man[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(metric: str, base: str = HERE):
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(base, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN_MODULES)


class OpenGuard:
    """Records every file the process opens whose name is ``bench.py`` or
    ``BENCH_*.json``: the JAX package's benchmark and its results, which
    this benchmark never reads (an audit hook sees every ``open``)."""

    def __init__(self):
        self.seen = []
        sys.addaudithook(self._hook)

    def _hook(self, event, args):
        if event != "open" or not args or not isinstance(args[0], str):
            return
        base = os.path.basename(args[0])
        if base == "bench.py" or (base.startswith("BENCH_")
                                  and base.endswith(".json")):
            self.seen.append(args[0])


def pin_environment() -> str:
    """Every cache of the program in fixed directories of the checkout,
    one thread to each math library, and the per-run state (the transfer tiers' run statistics, the
    outputs) in a fresh directory under the run's TMPDIR, so that every
    run starts from the same state -> that directory."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one thread to each math library: the program's own threads (8 export
    # workers, the main thread) are the host's load, without a pool of
    # OpenMP or BLAS threads spinning under each of them
    for var in THREAD_VARS:
        os.environ[var] = "1"
    run_dir = tempfile.mkdtemp(prefix="rig_bench_")
    os.environ["RIG_TORCH_CACHE"] = os.path.join(run_dir, "runstats")
    return run_dir


def check_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: this benchmark "
                         "measures the card and does not fall back")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} are visible")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def io_written() -> dict:
    """Bytes this process has written: to the block layer, and through
    write calls (``/proc/self/io``)."""
    try:
        with open("/proc/self/io", encoding="ascii") as f:
            rows = dict(line.split(":") for line in f if ":" in line)
        return {"write_bytes": int(rows["write_bytes"]),
                "wchar": int(rows["wchar"])}
    except (OSError, KeyError, ValueError):
        return {}


def tree_bytes(path: str) -> int:
    total = 0
    for d, _sub, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(d, f))
            except OSError:
                pass
    return total


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
