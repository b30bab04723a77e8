# graphs.py — batch steps captured once as CUDA graphs and replayed.
"""The port's counterpart of the JAX package's ``jax.jit`` with
``utils/aot.py``: the JAX package compiles each per-batch program once per
key and runs the executable for every batch.  The port's batch steps are
eager PyTorch, thousands of small kernels launched one by one from
Python, so ``StepGraphs`` captures a step once per key into a
``torch.cuda.CUDAGraph`` and replays it for every batch.  The key is the
device, the inputs' tree, shapes and dtypes, and the step's non-tensor
arguments (``static``, the counterpart of JAX's ``static_argnames``:
sizes, budgets, thresholds, codecs):

- at the first call for a key, static input tensors are made on the
  device and the inputs copied into them.  The step runs eagerly
  ``WARM_RUNS`` times on the device's capture stream.  That builds and
  loads the nvcc libraries, fills the per-device constants
  (``device.constant``) and gives cuBLAS its workspace on that stream, so
  the compose and pHash matmuls capture.  Then the step is captured into a
  graph;
- at every call, the inputs are copied into the static inputs (``copy_``:
  a replay never returns an earlier batch), the graph is replayed on the
  current stream and the outputs are cloned out of the graph's memory.  A
  caller may hold one batch's outputs while the next batch replays: the
  RPM generator's one-deep pipeline does, and two shards of a mesh on one
  card replay one graph back to back.

One memory pool per card.  Every graph of a device captures into that
device's one pool (``torch.cuda.graph_pool_handle``, kept per device) on
that device's one capture stream, so a later capture reuses what an
earlier one freed and the pool holds about one step's peak plus the
static outputs, not the sum of every step's peak.  That is safe, in any
replay order, because:

- static inputs, and any state that outlives a replay (the dedup corpus,
  the constants), are allocated outside the pool: the inputs before the
  capture, the state by the caller from a replay's cloned outputs;
- a replay's outputs are cloned on the replaying stream before any other
  graph of that device replays (``_replay`` does it), so what a step
  leaves in the pool is read only before the next replay writes it;
- all of a device's replays run on one stream, the current one, the two
  shards of a mesh on one card included.

A step's output leaf that is not a tensor (``io/transfer.Static``: a
blob's layout, worked out from shapes) is a value of the key: the
capture's is handed back by every replay.  Host inputs (CPU tensors) are
pinned, each in a ``host.pin`` span (utils/profiling.py), and copied
without waiting for the device; inputs already on the device are copied
there.  A graph has no on-disk form, so nothing here
stands for utils/aot.py's executable cache.  On the CPU the step runs as
it is.  On a card nothing falls back: a capture or a replay that fails
raises.

Counts.  ``CAPTURES`` counts the graphs captured in this process.  A
kernel wrapper counts its launches in a module-level ``LAUNCHES``; the
modules handed in as ``counters`` are kept true to what the card ran: the
warm runs count, a capture adds nothing, and every replay adds the
launches captured in its graph.
"""
from __future__ import annotations

import gc
from typing import NamedTuple

import torch

from ..io.transfer import tree_flatten, tree_unflatten
from . import profiling

WARM_RUNS = 2
CAPTURES = 0

# per card: the graphs' one memory pool and the one stream they capture on
_POOLS: dict = {}
_CAPTURE_STREAMS: dict = {}


class Captured(NamedTuple):
    """One key's graph: its static inputs and outputs (flat, with the
    outputs' tree), and the launches of each counter captured in it."""
    graph: "torch.cuda.CUDAGraph"
    inputs: list
    outputs: list
    treedef: object
    launches: tuple


def pool(dev: torch.device):
    """The memory pool every graph of card `dev` captures into."""
    if dev not in _POOLS:
        with torch.cuda.device(dev):
            _POOLS[dev] = torch.cuda.graph_pool_handle()
    return _POOLS[dev]


def _capture_stream(dev: torch.device) -> "torch.cuda.Stream":
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]


def _device(leaves, device) -> torch.device:
    dev = torch.device(device) if device is not None else leaves[0].device
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class StepGraphs:
    """``fn(*args, **static)`` (args and result: trees of tensors, as
    io/transfer.tree_flatten walks them; `static`: hashable non-tensor
    arguments) captured once per key and replayed; see the module's
    docstring."""

    def __init__(self, fn, counters=()):
        self.fn = fn
        self.counters = tuple(counters)
        self._captured: dict = {}

    def __call__(self, *args, device=None, **static):
        """The step's outputs for `args` on `device` (default: where the
        first input lies).  On a CPU device the inputs are moved there and
        the step runs eagerly."""
        leaves, treedef = tree_flatten(args)
        dev = _device(leaves, device)
        if dev.type != "cuda":
            return self.fn(*tree_unflatten(treedef,
                                           [a.to(dev) for a in leaves]),
                           **static)
        key = (dev, treedef, tuple((tuple(a.shape), a.dtype) for a in leaves),
               tuple(sorted(static.items())))
        with torch.cuda.device(dev):
            c = self._captured.get(key)
            if c is None:
                c = self._captured[key] = self._capture(dev, leaves, treedef,
                                                        static)
            return self._replay(c, leaves)

    @staticmethod
    def _load(inputs, leaves) -> None:
        for s, a in zip(inputs, leaves):
            if a.device.type == "cpu" and not a.is_pinned():
                with profiling.span("host.pin", bytes=a.nbytes):
                    a = a.pin_memory()
            s.copy_(a, non_blocking=True)

    def _capture(self, dev, leaves, treedef, static) -> Captured:
        global CAPTURES
        inputs = [torch.empty(a.shape, dtype=a.dtype, device=dev)
                  for a in leaves]
        self._load(inputs, leaves)
        args = tree_unflatten(treedef, inputs)
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(WARM_RUNS):
                self.fn(*args, **static)
        torch.cuda.current_stream(dev).wait_stream(stream)
        before = [m.LAUNCHES for m in self.counters]
        graph = torch.cuda.CUDAGraph()
        # capture_begin/end, not the torch.cuda.graph context: that
        # synchronises the device and empties the allocator's device and
        # pinned host caches at every capture, so a key captured mid-run (a
        # tier that moved) would stall the one-deep pipeline and allocate
        # the batch's buffers anew.  The garbage collector is off meanwhile:
        # a graph that died in a reference cycle (a LeafPipeline and its
        # StepGraphs) must not be destroyed while a stream captures, which
        # invalidates the capture
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool(dev),
                                    capture_error_mode="thread_local")
                try:
                    out = self.fn(*args, **static)
                finally:
                    graph.capture_end()
        finally:
            if gc_on:
                gc.enable()
            launches = tuple(m.LAUNCHES - b
                             for m, b in zip(self.counters, before))
            for m, b in zip(self.counters, before):
                m.LAUNCHES = b
        CAPTURES += 1
        outputs, out_def = tree_flatten(out)
        return Captured(graph, inputs, outputs, out_def, launches)

    def _replay(self, c: Captured, leaves):
        self._load(c.inputs, leaves)
        c.graph.replay()
        for m, n in zip(self.counters, c.launches):
            m.LAUNCHES += n
        return tree_unflatten(c.treedef, [
            o.clone() if isinstance(o, torch.Tensor) else o
            for o in c.outputs])
