# graphs.py — a batch step captured once as a CUDA graph and replayed.
"""The port's counterpart of the JAX package's ``jax.jit`` with
``utils/aot.py``: the JAX package compiles a batch function once per
(leaf, batch size) and runs the executable for every batch.  The port's
batch steps are eager PyTorch, thousands of small kernels launched one by
one from Python, so ``StepGraphs`` captures a step once per key (the
device and its inputs' shapes and dtypes) into a ``torch.cuda.CUDAGraph``
and replays it for every batch:

- at the first call for a key, static input tensors are made on the
  device and the inputs copied into them.  The step runs eagerly
  ``WARM_RUNS`` times on the stream the capture will use.  That builds and
  loads the nvcc libraries, fills the per-device constants
  (``device.constant``) and gives cuBLAS its workspace on that stream, so
  the compose and pHash matmuls capture.  Then the step is captured into a
  graph with a private memory pool;
- at every call, the inputs are copied into the static inputs (``copy_``:
  a replay never returns an earlier batch), the graph is replayed on the
  current stream and the outputs are cloned out of its pool.  A caller may
  hold one batch's outputs while the next batch replays: the RPM
  generator's one-deep pipeline does, and two shards of a mesh on one
  card replay one graph back to back.

Host inputs (CPU tensors) are pinned and copied without waiting for the
device; inputs already on the device are copied there.  A graph has no
on-disk form, so nothing here stands for utils/aot.py's executable cache.
On the CPU the step runs as it is.  On a card nothing falls back: a
capture or a replay that fails raises.

Launch counts.  A kernel wrapper counts its launches in a module-level
``LAUNCHES``; the modules handed in as ``counters`` are kept true to what
the card ran: the warm runs count, a capture adds nothing, and every
replay adds the launches captured in its graph.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..io.transfer import tree_flatten, tree_unflatten

WARM_RUNS = 2


class Captured(NamedTuple):
    """One key's graph: its static inputs and outputs (flat, with the
    outputs' tree), and the launches of each counter captured in it."""
    graph: "torch.cuda.CUDAGraph"
    inputs: list
    outputs: list
    treedef: object
    launches: tuple


def _device(leaves, device) -> torch.device:
    dev = torch.device(device) if device is not None else leaves[0].device
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class StepGraphs:
    """``fn(*args)`` (args and result: trees of tensors, as
    io/transfer.tree_flatten walks them) captured once per key and
    replayed; see the module's docstring."""

    def __init__(self, fn, counters=()):
        self.fn = fn
        self.counters = tuple(counters)
        self._captured: dict = {}
        self._streams: dict = {}

    def __call__(self, *args, device=None):
        """The step's outputs for `args` on `device` (default: where the
        first input lies).  On a CPU device the inputs are moved there and
        the step runs eagerly."""
        leaves, treedef = tree_flatten(args)
        dev = _device(leaves, device)
        if dev.type != "cuda":
            return self.fn(*tree_unflatten(treedef,
                                           [a.to(dev) for a in leaves]))
        key = (dev, tuple((tuple(a.shape), a.dtype) for a in leaves))
        with torch.cuda.device(dev):
            c = self._captured.get(key)
            if c is None:
                c = self._captured[key] = self._capture(dev, leaves, treedef)
            return self._replay(c, leaves)

    @staticmethod
    def _load(inputs, leaves) -> None:
        for s, a in zip(inputs, leaves):
            if a.device.type == "cpu" and not a.is_pinned():
                a = a.pin_memory()
            s.copy_(a, non_blocking=True)

    def _capture(self, dev, leaves, treedef) -> Captured:
        inputs = [torch.empty(a.shape, dtype=a.dtype, device=dev)
                  for a in leaves]
        self._load(inputs, leaves)
        args = tree_unflatten(treedef, inputs)
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(WARM_RUNS):
                self.fn(*args)
        torch.cuda.current_stream(dev).wait_stream(stream)
        before = [m.LAUNCHES for m in self.counters]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                out = self.fn(*args)
        finally:
            launches = tuple(m.LAUNCHES - b
                             for m, b in zip(self.counters, before))
            for m, b in zip(self.counters, before):
                m.LAUNCHES = b
        outputs, out_def = tree_flatten(out)
        return Captured(graph, inputs, outputs, out_def, launches)

    def _replay(self, c: Captured, leaves):
        self._load(c.inputs, leaves)
        c.graph.replay()
        for m, n in zip(self.counters, c.launches):
            m.LAUNCHES += n
        return tree_unflatten(c.treedef, [o.clone() for o in c.outputs])
