# mesh.py — device-mesh data parallelism and host sharding.
"""Scaling out, as the JAX package's parallel/mesh.py does it, on torch.

Within a host, a generator splits each batch over a 1-D mesh of devices
(``make_mesh``, ``shard_batch``, ``gather_batch``): every pipeline stage
is elementwise over the batch, so each device runs its shard alone, and
the only traffic between devices is the gather of the shards' outputs
onto the first device (where JAX's jit boundary gathers them) and the
corpus dedup's gather of 8-byte pHashes (``sharded_dedup_mask``).  A
mesh is an explicit list of torch devices, and a device may repeat: two
handles to ``cuda:0`` (or to ``cpu``) run every line of the shard, gather
and collective code on one card.

Across hosts, ``host_shard_ids`` gives each independent process a strided
shard of the sample ids (``cli.py --num_hosts/--host_id``); the merge
dedups across hosts from the pHash in every meta, so no collective is
needed.  ``distributed_init`` and ``make_hybrid_mesh`` build the
``("host", "data")`` mesh of a ``torch.distributed`` world, over which
``sharded_dedup_mask`` gathers with ``all_gather_into_tensor``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..io.transfer import tree_flatten, tree_unflatten
from ..ops.phash import dedup_keep_mask, dedup_keep_mask_vs_corpus


@dataclass(frozen=True)
class Mesh:
    """Devices in mesh order, with the mesh's axis names and shape.

    ``devices`` are this process's devices, the process's row of the mesh;
    ``process_index`` is that row on a ``("host", "data")`` mesh (0 on a
    1-D one).  ``size`` counts the devices of every process, as JAX's
    ``Mesh.size`` does."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    process_index: int = 0

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def _local_devices(n_devices=None, devices=None) -> tuple:
    """The devices given (the first n_devices of them), or cuda:0..n-1."""
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cards == 0:
            raise RuntimeError("no CUDA device is visible: pass devices= to "
                               "build a mesh elsewhere")
        n = n_devices or n_cards
        if n > n_cards:
            raise ValueError(f"{n} devices asked for, {n_cards} visible")
        return tuple(torch.device("cuda", i) for i in range(n))
    devs = tuple(torch.device(d) for d in devices)
    devs = devs[:n_devices] if n_devices else devs
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def make_mesh(n_devices: int | None = None, devices=None,
              axis: str = "data") -> Mesh:
    """1-D mesh over `devices` (which may repeat a device), or over
    cuda:0..n_devices-1 of this process; raises when no card is visible
    and no devices are given."""
    devs = _local_devices(n_devices, devices)
    return Mesh(devs, (axis,), {axis: len(devs)})


def auto_mesh(device, batch_size: int | None = None) -> Mesh | None:
    """The mesh a generator on `device` builds by itself: none on the CPU;
    on a card, the visible cards in index order starting from `device`
    (wrapping round to cuda:0), as many as the largest count that divides
    `batch_size` (all of them when it is None); none when that is one."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    n_cards = torch.cuda.device_count()
    n = n_cards if batch_size is None else max(
        d for d in range(1, n_cards + 1) if batch_size % d == 0)
    if n <= 1:
        return None
    first = (torch.cuda.current_device() if device.index is None
             else device.index)
    return make_mesh(devices=[torch.device("cuda", (first + i) % n_cards)
                              for i in range(n)])


def home_device(mesh, device) -> torch.device:
    """Where a generator on `mesh` (or on none) gathers its batches: the
    generator's `device`, which must be the mesh's first ('cuda' names
    the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if mesh is not None and mesh.devices[0] != device:
        raise ValueError(f"the mesh starts at {mesh.devices[0]}, the "
                         f"generator's device is {device}")
    return device


def shard_batch(mesh: Mesh, tree) -> list:
    """Split every leaf of `tree` (tensors or arrays, batch first) on dim 0
    into one equal part per device of `mesh` -> a list of trees, part i on
    ``mesh.devices[i]``.  In a world of several processes each process
    splits its own rows over its own devices.  The leading dim must divide
    evenly, as under JAX's NamedSharding."""
    leaves, treedef = tree_flatten(tree)
    n = len(mesh.devices)
    parts = [[] for _ in range(n)]
    for a in leaves:
        a = torch.as_tensor(a)
        if a.shape[0] % n:
            raise ValueError(f"a leading dim of {a.shape[0]} does not split "
                             f"over {n} devices")
        for i, (piece, dev) in enumerate(zip(a.chunk(n), mesh.devices)):
            parts[i].append(piece.to(dev))
    return [tree_unflatten(treedef, p) for p in parts]


def gather_batch(mesh: Mesh, trees: list):
    """The inverse of ``shard_batch``: per-device trees of one structure ->
    one tree on ``mesh.devices[0]``, every leaf concatenated on dim 0 in
    mesh order."""
    flat = [tree_flatten(t) for t in trees]
    home = mesh.devices[0]
    leaves = [torch.cat([a.to(home) for a in parts])
              for parts in zip(*(lv for lv, _ in flat))]
    return tree_unflatten(flat[0][1], leaves)


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str = "nccl") -> None:
    """Join a ``torch.distributed`` world of `num_processes`, whose rank 0
    listens at `coordinator_address` ("host:port").  Does nothing for a
    single process.  Nothing chooses the backend but the caller."""
    if not num_processes or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a world of several processes needs "
                         "coordinator_address and process_id")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def world() -> tuple:
    """(process count, this process's rank) of the torch.distributed world,
    (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_hybrid_mesh(devices=None, host_axis: str = "host",
                     data_axis: str = "data") -> Mesh:
    """2-D (processes x local devices) mesh: row r holds process r's
    devices (`devices`, or cuda:0..n-1), so a gather over `data_axis`
    alone never leaves the process.  One process gives shape (1, n)."""
    devs = _local_devices(None, devices)
    n_proc, rank = world()
    return Mesh(devs, (host_axis, data_axis),
                {host_axis: n_proc, data_axis: len(devs)}, rank)


def host_shard_ids(ids, process_index: int, process_count: int) -> list:
    """The ids of host `process_index` of `process_count`: every
    process_count-th id, starting at process_index.  Deterministic in the
    order of `ids`, so the hosts need no coordination.  Both arguments are
    required: nothing here knows a process's rank by itself."""
    if process_count < 1 or not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} is not in "
                         f"[0, {process_count})")
    return list(ids)[process_index::process_count]


def sharded_dedup_mask(mesh: Mesh, shards, threshold: int = 4, axis="data",
                       corpus: torch.Tensor | None = None,
                       corpus_count=None) -> list:
    """Global dedup keep mask of hashes that lie on the mesh's devices.

    `shards` holds one u8 ``[N/n, 8]`` tensor per device of this process,
    in mesh order.  They are gathered in that order onto
    ``mesh.devices[0]``; when `axis` is ``("host", "data")`` and a
    ``torch.distributed`` world is up (of any size, 1 included), the
    gather also crosses the processes (``all_gather_into_tensor``), rows
    in rank order, so the flat order is JAX's ``_axis_index_flat``.  The
    greedy pass (``dedup_keep_mask``, or ``dedup_keep_mask_vs_corpus`` against
    the first `corpus_count` rows of `corpus`) runs once per process on
    the gathered hashes, and each device gets its slice back.  -> a list
    of bool ``[N/n]`` keep masks, one per device, on that device."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if axes not in (mesh.axis_names[-1:], mesh.axis_names[-2:]):
        raise ValueError(f"axis {axis!r}: the mesh's last axis, or its two "
                         f"axes {mesh.axis_names}")
    if len(shards) != len(mesh.devices):
        raise ValueError(f"{len(shards)} shards for {len(mesh.devices)} "
                         "devices")
    home = mesh.devices[0]
    n_local = shards[0].shape[0]
    hashes = torch.cat([s.to(home) for s in shards])
    first = 0
    if len(axes) == 2 and dist.is_available() and dist.is_initialized():
        n_proc = mesh.shape[axes[0]]
        if n_proc != dist.get_world_size():
            raise ValueError(f"the mesh has {n_proc} processes, the world "
                             f"{dist.get_world_size()}")
        rows = torch.empty((n_proc * hashes.shape[0],) + hashes.shape[1:],
                           dtype=hashes.dtype, device=home)
        dist.all_gather_into_tensor(rows, hashes)
        first = mesh.process_index * hashes.shape[0]
        hashes = rows
    if corpus is None:
        keep = dedup_keep_mask(hashes, threshold)
    else:
        count = (corpus_count.to(home)
                 if isinstance(corpus_count, torch.Tensor)
                 else int(corpus_count or 0))
        keep = dedup_keep_mask_vs_corpus(corpus.to(home), count, hashes,
                                         threshold)
    return [keep[first + i * n_local:first + (i + 1) * n_local].to(d)
            for i, d in enumerate(mesh.devices)]
