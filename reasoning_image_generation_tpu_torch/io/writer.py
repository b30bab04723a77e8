# writer.py — threaded host-side export pool.
"""Asynchronous file export: PNG encodes, JSON writes and host tasks
(metadata, QC) run on a thread pool, so export overlaps the next batch's
device work.  ``drain`` waits for everything submitted and re-raises the
first worker exception.
"""
from __future__ import annotations

import functools
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils import profiling
from .png import write_png, write_png_rle, write_png_rle3


def ensure_dir(p: str) -> None:
    os.makedirs(p, exist_ok=True)


def write_json(path: str, obj, pretty: bool = False) -> None:
    """`obj` as JSON: compact, or indent=2 with `pretty`; non-ASCII text
    as it is."""
    data = json.dumps(obj, ensure_ascii=False, indent=2 if pretty else None,
                      separators=None if pretty else (",", ":"))
    with open(path, "w", encoding="utf-8") as f:
        f.write(data)


class ExportPool:
    """Export tasks on `workers` threads.  While the program's spans are
    recorded (utils/profiling.py) each task runs in an ``export.task`` span
    (attributes ``fn``, the task's kind: png, png_rle, png_rle3, json,
    meta, delta_sample or qc; and ``workers``), the child of the batch
    span current at its submission, which it holds open until it ends; and
    ``drain`` is an ``export.drain`` span, the host blocked on the
    workers."""

    def __init__(self, workers: int = 8, use_threads: bool = True):
        # use_threads=False writes synchronously (the reference's
        # --use_threads/--workers toggles)
        self.workers = workers if use_threads else 0
        self._pool = (ThreadPoolExecutor(max_workers=workers)
                      if use_threads else None)
        self._futures = []

    def submit_png(self, path: str, img: np.ndarray):
        self.submit(write_png, path, np.asarray(img), kind="png")

    def submit_png_rle(self, path: str, lengths, colors, count: int, h: int,
                       w: int, overlay=None):
        """PNG from a v2 run stream; the arrays may be views into a
        transfer blob, which the pending task keeps alive."""
        self.submit(write_png_rle, path, lengths, colors, count, h, w,
                    overlay, kind="png_rle")

    def submit_png_rle3(self, path: str, frames, i: int, h: int, w: int,
                        overlay=None):
        """PNG from frame i of a compacted transfer (ops/rle.Rle3Frames)."""
        self.submit(write_png_rle3, path, frames, i, h, w, overlay,
                    kind="png_rle3")

    def submit_json(self, path: str, obj, pretty: bool = False):
        """``write_json`` on the pool: compact separators by default
        (json's C encoder), indent=2 with `pretty` (the reference's format,
        reference src/generator.py:596)."""
        self.submit(write_json, path, obj, pretty, kind="json")

    def submit(self, fn, *args, kind: str = "task"):
        """Run a host task on the pool; its result is not kept."""
        self.submit_task(fn, *args, kind=kind)

    def submit_task(self, fn, *args, kind: str = "task"):
        """Run a host task on the pool and return its Future (or, without
        threads, its result).  `kind` names it in its span."""
        if profiling.recording():
            args = (profiling.hold(), fn, args)
            fn = functools.partial(profiling.run_held, fn=kind,
                                   workers=self.workers)
        if self._pool is None:
            return fn(*args)
        f = self._pool.submit(fn, *args)
        self._futures.append(f)
        return f

    def drain(self):
        with profiling.span("export.drain"):
            for f in self._futures:
                f.result()
        self._futures.clear()

    def close(self):
        self.drain()
        if self._pool is not None:
            self._pool.shutdown()
