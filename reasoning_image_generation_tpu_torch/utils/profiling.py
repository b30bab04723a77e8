# profiling.py — the program's spans and the Chrome trace exporter.
"""Spans: what the host does, stage by stage, on the profiler's clock.

A span is a named interval of one thread: its id, its parent's id, the
thread's native id, a start and an end in ns from ``time.time_ns()`` (the
clock ``torch.profiler`` stamps its events with, so a span and the device
events of one session line up), and a few attributes (batch ordinal, leaf
or mode, real samples, bytes).  Spans are recorded exactly while a
``torch.profiler`` session is active in the process (``recording``): the
operator's ``trace(dir)`` and any profiler a caller opens both turn them
on, and nothing else does.  With no session a span site reads that flag
and hands back a shared no-op context.  A span opened
while recording is kept when it closes, even after the session ended.
Every span is kept in one list (``spans()``), appended to under the GIL.

Three forms:

- ``span(name, **attrs)``: a ``with`` block on the current thread, the
  child of the innermost span open there.  Stage spans of the main thread
  (``leaf``, the default) are also opened as profiler ranges, so the
  profiler's own trace names the host stage under each device idle gap.
  The ranges are of the operator kind (``_RecordFunctionFast``), not
  ``record_function``'s user annotations: the profiler lays a user
  annotation over the device's timeline too, where it would read as
  device time.  Envelopes (``leaf=False``: ``rpm.call``, ``mg.call``) are
  not mirrored, as they would cover every gap; nor are spans of other
  threads, whose ranges the profiler does not keep.
- ``begin(name, **attrs)`` / ``within(sp)`` / ``release(sp)``: a batch's
  envelope (``rpm.batch``, ``mg.batch``), opened at its dispatch and
  closed when the last of its holds is released: the opener's, and one
  per export task submitted while it was current (``hold``).  The last
  release may come on any thread.
- ``run_held(sp, task, args, **attrs)``: an export task, ``task(*args)``
  in an ``export.task`` span whose parent is the batch it was submitted
  under, on the worker thread that runs it; it releases that batch's
  hold.

``trace(dir)``: a ``torch.profiler`` context that writes a Chrome trace
(CPU and, on a card, CUDA activity) into `dir` when the block ends, with
the spans of the block, worker threads' included, as complete events on
their own threads; a no-op when `dir` is falsy.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

_SPANS: list = []
_IDS = itertools.count(1)
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """True while a ``torch.profiler`` session is active in this process,
    on every thread: torch's process-wide flag (the thread-local
    ``torch.autograd._profiler_enabled()`` reads False on other threads)."""
    return _autograd_profiler._is_profiler_enabled


def spans() -> list:
    """Every span recorded in this process, in the order they opened; one
    still open has ``end_ns`` None."""
    return list(_SPANS)


class Span:
    __slots__ = ("name", "id", "parent", "tid", "start_ns", "end_ns",
                 "attrs", "leaf", "_holds", "_ends", "_mirror")

    def __init__(self, name: str, parent, attrs: dict, leaf: bool):
        self.name = name
        self.id = next(_IDS)
        self.parent = parent
        self.tid = threading.get_native_id()
        self.attrs = attrs
        self.leaf = leaf
        self.end_ns = None
        self._holds = 0
        self._ends = None
        self._mirror = None
        self.start_ns = time.time_ns()
        _SPANS.append(self)


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


def _top_id(stack: list):
    return stack[-1].id if stack else None


class _Scope:
    __slots__ = ("name", "attrs", "leaf", "span")

    def __init__(self, name: str, attrs: dict, leaf: bool):
        self.name, self.attrs, self.leaf = name, attrs, leaf

    def __enter__(self):
        stack = _stack()
        sp = self.span = Span(self.name, _top_id(stack), self.attrs,
                              self.leaf)
        if self.leaf and threading.current_thread() is \
                threading.main_thread():
            sp._mirror = _RecordFunctionFast(self.name)
            sp._mirror.__enter__()
        stack.append(sp)
        return sp

    def __exit__(self, *exc):
        sp = self.span
        _stack().pop()
        if sp._mirror is not None:
            sp._mirror.__exit__(None, None, None)
            sp._mirror = None
        sp.end_ns = time.time_ns()
        return False


def span(name: str, leaf: bool = True, **attrs):
    """A ``with`` block recorded as a span while ``recording()``."""
    if not recording():
        return _OFF
    return _Scope(name, attrs, leaf)


def begin(name: str, **attrs) -> Optional[Span]:
    """Open an envelope the opener holds (None without recording): the
    child of the innermost span of this thread, on no thread's stack."""
    if not recording():
        return None
    sp = Span(name, _top_id(_stack()), attrs, False)
    sp._holds, sp._ends = 1, []
    return sp


class _Within:
    __slots__ = ("span",)

    def __init__(self, sp):
        self.span = sp

    def __enter__(self):
        _stack().append(self.span)

    def __exit__(self, *exc):
        _stack().pop()
        return False


def within(sp: Optional[Span]):
    """Make the envelope `sp` the current span of this thread for the
    block: spans opened there are its children, and tasks submitted there
    hold it."""
    return _OFF if sp is None else _Within(sp)


def hold() -> Optional[Span]:
    """One more hold on the innermost envelope of this thread (None if
    there is none).  Only the thread that has it current adds holds."""
    for sp in reversed(_stack()):
        if sp._ends is not None:
            sp._holds += 1
            return sp
    return None


def release(sp: Optional[Span]) -> None:
    """Release one hold on `sp`; the last closes it at the latest release
    stamp.  ``list.append`` is atomic under the GIL.  Holds are added only
    on the opener's thread and before it releases its own, so until then
    the releases stay below `_holds`, and from then on `_holds` is final.
    Two threads that both see the last release write the same stamp."""
    if sp is None:
        return
    sp._ends.append(time.time_ns())
    if len(sp._ends) == sp._holds:
        sp.end_ns = max(sp._ends)


def run_held(batch: Optional[Span], task, args, **attrs):
    """``task(*args)`` recorded as an ``export.task`` span, the child of
    `batch`, whose hold it releases when it ends."""
    sp = Span("export.task", batch.id if batch is not None else None,
              attrs, False)
    try:
        return task(*args)
    finally:
        sp.end_ns = time.time_ns()
        release(batch)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block and write ``<log_dir>/trace_<pid>_<ms>.json``
    (open it in chrome://tracing or Perfetto), the block's spans included;
    no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    import torch
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in _SPANS
                      if s.start_ns >= t0 and s.end_ns is not None])


def _add_spans(path: str, sps: list) -> None:
    """Append `sps` to the Chrome trace at `path` as complete events, on
    its time base (``baseTimeNanoseconds``, µs)."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    doc.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "program", "name": s.name, "pid": pid,
         "tid": s.tid, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {**s.attrs, "span": s.id, "parent": s.parent}}
        for s in sps)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
