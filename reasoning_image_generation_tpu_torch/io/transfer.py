# transfer.py — device-to-host transfer helpers shared by both pipelines.
"""One coalesced copy per batch, as the JAX package's io/transfer.py makes
it: a batch's output tree is fused on the device into ONE u8 blob, the copy
to the host starts at dispatch (``HostCopy``: a non-blocking copy into
pinned host memory and a recorded CUDA event; on the CPU a plain copy),
and the host splits the blob back into the tree.  Frames whose packed
runs overflowed their budget are fetched raw, all of one tensor's in one
gathered copy.

The port has no pytrees.  ``tree_flatten`` flattens in
``jax.tree.flatten``'s order: dict keys sorted, tuple and list items in
order (NamedTuples such as ``ElementState`` in their declared field order),
tensors and arrays as leaves.  The transfer tiers index leaves by that
order.

Dtypes on the wire are the leaves' own, with two readings on the host:
bool travels as u8 and comes back as bool, and int16 is the carrier of
the codecs' u16 streams (ops/rle.py) and comes back as uint16.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling

_HOST_DTYPE = {torch.bool: np.dtype(bool), torch.uint8: np.dtype(np.uint8),
               torch.int16: np.dtype(np.uint16),
               torch.int32: np.dtype(np.int32),
               torch.int64: np.dtype(np.int64),
               torch.float32: np.dtype(np.float32),
               torch.float64: np.dtype(np.float64)}


def host_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype a tensor's bytes are read as on the host."""
    return _HOST_DTYPE[t.dtype]


def host_array(t: torch.Tensor) -> np.ndarray:
    """One tensor on the host, in its host dtype (int16 as uint16)."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


# ---- trees ----------------------------------------------------------------

def tree_flatten(tree):
    """-> (leaves, treedef) in jax.tree.flatten's order; the treedef is
    hashable (utils/graphs.py keys its graphs by it)."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        leaves, defs = [], []
        for k in keys:
            lv, d = tree_flatten(tree[k])
            leaves += lv
            defs.append(d)
        return leaves, ("dict", keys, tuple(defs))
    if isinstance(tree, (tuple, list)):
        leaves, defs = [], []
        for v in tree:
            lv, d = tree_flatten(v)
            leaves += lv
            defs.append(d)
        return leaves, ("tuple", type(tree), tuple(defs))
    return [tree], None


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, meta, defs = d
        if kind == "dict":
            return {k: build(sd) for k, sd in zip(meta, defs)}
        items = [build(sd) for sd in defs]
        return meta(*items) if hasattr(meta, "_fields") else meta(items)

    return build(treedef)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


class Static:
    """A tree leaf that holds host data, not a tensor: a step's output
    worked out from shapes alone (a blob's layout), which utils/graphs.py
    hands back as it was captured at every replay."""
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


# ---- coalescing on the device ---------------------------------------------

def _bytes(a: torch.Tensor, rows: bool) -> torch.Tensor:
    """A leaf's bytes, ``[B, bytes]`` when `rows` else 1-D: bool widened
    to u8, other dtypes bitcast (little-endian on the CPU and the card)."""
    if a.dtype == torch.bool:
        a = a.to(torch.uint8)
    a = a.reshape(a.shape[0], -1) if rows else a.reshape(-1)
    if a.dtype == torch.uint8:
        return a
    if not a.is_contiguous() or a.stride(-1) != 1:
        # (a size-1 axis may keep any stride; the bitcast needs 1)
        a = a.new_empty(a.shape).copy_(a)
    return a.view(torch.uint8)


def _shrink(a: torch.Tensor, s):
    if s is None:
        return a
    axis, ns = s
    axis %= a.dim()
    return a.narrow(axis, 0, min(ns, a.shape[axis]))


def coalesce(leaves) -> torch.Tensor:
    """Fuse per-batch leaves (each with the leading batch axis) into ONE
    u8 ``[B, bytes]`` blob."""
    return coalesce_shrunk(leaves, (None,) * len(leaves))


def coalesce_shrunk(leaves, sizes) -> torch.Tensor:
    """`coalesce` with per-leaf truncation: `sizes` holds, per leaf, None
    (travels whole) or (axis, new_size).  The host picks sizes from the
    run counts of earlier batches (transfer_tier); a frame whose runs a
    truncation cut is fetched raw."""
    return torch.cat([_bytes(_shrink(a, s), True)
                      for a, s in zip(leaves, sizes)], 1)


def coalesce_flat(leaves) -> torch.Tensor:
    """ONE 1-D u8 blob of every leaf's bytes (for the batch-compacted
    streams, which have no batch axis)."""
    return coalesce_flat_shrunk(leaves, (None,) * len(leaves))


def coalesce_flat_shrunk(leaves, sizes) -> torch.Tensor:
    return torch.cat([_bytes(_shrink(a, s), False)
                      for a, s in zip(leaves, sizes)])


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 leaves cross as int32, the JAX package's integer width (its
    x64 is off): every integer the pipelines output fits."""
    return t.to(torch.int32) if t.dtype == torch.int64 else t


def blob_step(tree, *, sizes, flat: bool):
    """A batch's output tree as ONE u8 blob on the device: every leaf
    narrowed (``narrow``) and cut to its `sizes` entry, then fused by
    ``coalesce_flat_shrunk`` (`flat`: the batch-compacted streams) or
    ``coalesce_shrunk``.  -> (blob, ``Static((treedef, specs))``, what
    ``split_flat`` or ``split_blob`` needs on the host).  The generators
    replay it as a CUDA graph per (tree, shapes, sizes, device)."""
    leaves, treedef = tree_flatten(tree)
    leaves = [narrow(a) for a in leaves]
    blob = (coalesce_flat_shrunk if flat else coalesce_shrunk)(leaves, sizes)
    return blob, Static((treedef, shrunk_specs(leaves, sizes)))


def transfer_tier(max_seen, capacity: int):
    """Transfer size of a packed stream: 1.2x the largest count seen so far
    plus 64, rounded up to a multiple of 512; None when no stats exist yet
    or nothing would be saved.  Monotone in max_seen."""
    if max_seen is None:
        return None
    t = -(-(int(max_seen * 1.2) + 64) // 512) * 512
    return t if t < capacity else None


# the stream axes of the compacted rle3/rle4/rle5 tuples (ops/rle.py), by
# arity, and the absolute slack of each stream's tier: run totals
# concentrate over a batch's frames, so 1.2x covers them; palette, escape
# and extension totals are bursty (one frame of 300 colours adds hundreds
# of escapes to a near-zero average)
_STREAMS = {7: "TTPE", 9: "TTPEX", 11: "BSTPEX"}
_SLACK = {"B": 64, "S": 1024, "T": 0, "P": 1024, "E": 4096, "X": 1024}


def compact_sizes(packed, stat) -> tuple:
    """`sizes` of one compacted tuple: each stream axis cut to the tier of
    ``stat(name)`` (the largest per-frame average seen for stream 'T',
    'P', 'E', 'X', 'B' or 'S'; None when unknown) times the frames, plus
    the stream's slack; the per-frame counts travel whole."""
    names = _STREAMS[len(packed)]
    F = int(np.prod(tuple(packed[len(names)].shape), dtype=np.int64))
    sizes = []
    for name, a in zip(names, packed):
        st = stat(name)
        t = transfer_tier(None if st is None else st * F + _SLACK[name],
                          int(a.shape[0]))
        sizes.append(None if t is None else (0, t))
    return tuple(sizes) + (None,) * (len(packed) - len(names))


def stream_totals(packed, cap: int):
    """Host side of `compact_sizes`: ({stream: total over the batch},
    frames) of one compacted tuple; the bitmask counts the bytes of the
    runs that were packed (at most `cap` a frame)."""
    base = len(_STREAMS[len(packed)])
    cnt, nc, ec = (np.asarray(v) for v in packed[base:base + 3])
    tot = {"T": cnt.sum(), "P": np.minimum(nc, 255).sum(), "E": ec.sum()}
    if len(packed) > 7:
        tot["X"] = np.asarray(packed[base + 3]).sum()
    if len(packed) == 11:
        tot["B"] = ((np.minimum(cnt, cap) + 7) // 8).sum()
        tot["S"] = np.asarray(packed[10]).sum()
    return {k: int(v) for k, v in tot.items()}, max(cnt.size, 1)


def blob_specs(tree):
    """(leaves, treedef, per-leaf (shape, host dtype))."""
    leaves, treedef = tree_flatten(tree)
    return leaves, treedef, [(tuple(a.shape), host_dtype(a)) for a in leaves]


def shrunk_specs(leaves, sizes):
    """Per-leaf (shape, host dtype) after the `sizes` truncation."""
    specs = []
    for a, s in zip(leaves, sizes):
        shape = list(a.shape)
        if s is not None:
            axis, ns = s
            axis %= len(shape)
            shape[axis] = min(ns, shape[axis])
        specs.append((tuple(shape), host_dtype(a)))
    return specs


# ---- the copy -------------------------------------------------------------

class HostCopy:
    """A blob on its way to the host.  On a card the copy goes into pinned
    memory without blocking and an event is recorded behind it; `numpy()`
    waits on that event before the buffer is read.  On the CPU it is a
    plain copy.  While the program's spans are recorded
    (utils/profiling.py), allocating the pinned buffer is a ``host.pin``
    span and the wait in `numpy()` a ``transfer.wait`` span: the host
    blocked on the card."""

    def __init__(self, blob: torch.Tensor):
        if blob.device.type == "cuda":
            with profiling.span("host.pin", bytes=blob.nbytes):
                self._host = torch.empty(blob.shape, dtype=blob.dtype,
                                         pin_memory=True)
            self._host.copy_(blob, non_blocking=True)
            # behind the copy, on the stream of the blob's card
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(blob.device))
        else:
            self._host = blob.clone()
            self._event = None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            with profiling.span("transfer.wait"):
                self._event.synchronize()
            self._event = None
        return self._host.numpy()


def _view(raw: np.ndarray, dtype: np.dtype, shape) -> np.ndarray:
    store = np.dtype(np.uint8) if dtype == np.bool_ else dtype
    arr = raw.view(store).reshape(shape)
    return arr.astype(bool) if dtype == np.bool_ else arr


def split_flat(blob_np: np.ndarray, treedef, specs):
    """Invert `coalesce_flat`; leaves are views into the blob."""
    out, off = [], 0
    for shape, dtype in specs:
        store = np.dtype(np.uint8) if dtype == np.bool_ else np.dtype(dtype)
        nb = int(np.prod(shape, dtype=np.int64)) * store.itemsize
        out.append(_view(blob_np[off:off + nb], dtype, shape))
        off += nb
    return tree_unflatten(treedef, out)


def split_blob(blob_np: np.ndarray, treedef, specs):
    """Invert `coalesce`: one host u8 ``[B, bytes]`` array -> the tree."""
    n = blob_np.shape[0]
    out, off = [], 0
    for shape, dtype in specs:
        store = np.dtype(np.uint8) if dtype == np.bool_ else np.dtype(dtype)
        per = int(np.prod(shape[1:], dtype=np.int64)) * store.itemsize
        chunk = np.ascontiguousarray(blob_np[:, off:off + per])
        out.append(_view(chunk, dtype, (n,) + tuple(shape[1:])))
        off += per
    return tree_unflatten(treedef, out)


def gather_frames(raw_dev: torch.Tensor, indices) -> dict:
    """The listed flat frame indices of an image tensor ``[..., h, w, 3]``
    in ONE gathered copy -> {flat index: u8 ``[h, w, 3]``}."""
    indices = np.asarray(indices, np.int64).reshape(-1)
    if indices.size == 0:
        return {}
    flat = raw_dev.reshape((-1,) + tuple(raw_dev.shape[-3:]))
    sel = flat.index_select(
        0, torch.from_numpy(indices).to(flat.device)).cpu().numpy()
    return {int(i): sel[j] for j, i in enumerate(indices)}


class HostBufferRing:
    """Reusable host buffers: up to `slots` per (shape, dtype), handed out
    round robin.  `wrapped` tells the caller that a buffer handed out
    before is reused, so the export pool reading it must be drained
    first."""

    def __init__(self, slots: int = 3):
        self.slots = slots
        self._bufs: dict = {}
        self._idx: dict = {}

    def acquire(self, shape, dtype=np.uint8):
        key = (tuple(int(s) for s in shape), np.dtype(dtype).str)
        lst = self._bufs.setdefault(key, [])
        if len(lst) < self.slots:
            lst.append(np.empty(shape, dtype))
            return lst[-1], False
        i = self._idx.get(key, 0)
        self._idx[key] = (i + 1) % self.slots
        return lst[i], True


def overflow_pixels(packed, raw_dev, n_valid: int) -> dict:
    """Raw pixels of the first n_valid frames whose run count exceeds the
    transferred capacity of a per-frame (lengths or starts, colours,
    counts) tuple, in one gathered copy -> {flat frame index: pixels}."""
    lengths, _colors, counts = packed
    cap = lengths.shape[-1]
    cnt = np.asarray(counts).reshape(-1)
    over = np.nonzero(cnt > cap)[0]
    return gather_frames(raw_dev, over[over < n_valid])


def unpack_images(packed, raw_dev, codec: str = "rle",
                  out: np.ndarray | None = None) -> np.ndarray:
    """A frame tensor from a per-frame codec ('rle', 'rle2' or 'sparse')
    on the host; frames over budget come raw, in one gathered copy.  Pass
    a HostBufferRing buffer as `out` to skip a fresh allocation."""
    if codec == "rle2":
        from ..ops.rle import unpack_frame_rle2 as unpack_frame
    elif codec == "rle":
        from ..ops.rle import unpack_frame_rle as unpack_frame
    else:
        from ..ops.sparse import unpack_frame
    mask, vals, count = (np.asarray(packed[0]), np.asarray(packed[1]),
                         np.asarray(packed[2]))
    shape = tuple(raw_dev.shape)
    H, W = shape[-3], shape[-2]
    lead = shape[:-3]
    out = np.empty(shape, np.uint8) if out is None else out
    assert out.shape == shape and out.dtype == np.uint8
    m2 = mask.reshape((-1,) + mask.shape[len(lead):])
    v2 = vals.reshape((-1,) + vals.shape[len(lead):])
    c2 = count.reshape(-1)
    o2 = out.reshape((-1,) + shape[-3:])
    capacity = v2.shape[1]
    over = np.nonzero(c2 > capacity)[0]
    for i, px in gather_frames(raw_dev, over).items():
        o2[i] = px
    for i in range(o2.shape[0]):
        if c2[i] <= capacity:
            o2[i] = unpack_frame(m2[i], v2[i], int(c2[i]), (H, W))
    return out
