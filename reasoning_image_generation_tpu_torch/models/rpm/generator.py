# generator.py — host orchestration: leaf grouping, batching, export.
"""Batch generator for the RPM sequence-puzzle pipeline on torch devices.

The JAX package's models/rpm/generator.py: per-sample leaf
and use_grid choices on the host (Python ``Random`` seeded
``seed + sample_id``), ids grouped by rule leaf, one batched
``LeafPipeline`` call per chunk, and a one-deep software pipeline: batch
k+1 is dispatched before batch k is exported.  On a card a batch is a
few CUDA graph replays, as the JAX package's batch is a few compiled
programs (utils/graphs.py): the keys' ``fold_in``, the leaf's batch step
(pipeline.py), the compaction of ``--sparse``, the dedup step
(ops/phash.py ``CorpusDedup``) and the blob; nothing else is launched but
the inputs' copies, the outputs' clones and the copies to the host.
Each batch crosses to the host as ONE coalesced blob (io/transfer.py)
that holds everything but the raw images a codec replaces, and the dedup
keep mask crosses beside it.  Without a codec or a mesh the blob depends
on shapes alone, and the leaf's own graph writes it
(``LeafPipeline.blob``): the batch's frames are temporaries of that graph,
and no blob graph holds a copy of them.  With
``sparse_transfer`` the frames travel packed (``transfer_codec``, ops/rle.py
and ops/sparse.py; the rle3..rle5d family compacted on the device into
streams shrunk to tiers learnt from persisted run statistics), PNGs are
written from the run streams, and frames over budget are fetched raw in
one gathered copy per tensor.  PNG/JSON export runs on
``io/writer.ExportPool``.

On a device mesh (parallel/mesh.py; ``mesh=``, or ``GenConfig.use_mesh``
over several cards) each batch's keys are split over the devices, each
device runs the pipeline on its shard (K1 once a shard), and the outputs
are gathered on the mesh's first device for the compaction, the dedup
keep mask (``sharded_dedup_mask`` of the per-shard pHashes), the blob step
and the copies.

Output layout is the JAX package's:
  out/samples/sample_%06d/{state_i.png, option_j.png, proto_true_next.png,
                           query.png, meta.json, coco.json}
  out/grids/grid_%06d.png
  out/index.json (written by cli.py)
"""
from __future__ import annotations

import json
import logging
import os
import random
import time
import traceback
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from ...device import constant, upload
from ...io import transfer
from ...io.png import write_png
from ...io.transfer import HostBufferRing, gather_frames
from ...io.writer import ExportPool, ensure_dir, write_json
from ...ops import prng_cuda, rle
from ...ops.phash import CorpusDedup
from ...parallel import mesh as mesh_lib
from ...utils import graphs, prng, profiling
from ...utils.cache import load_run_stats, save_run_stats
from ...utils.config import GenConfig, category_leaves
from .metadata import build_coco, build_sample_meta
from .pipeline import LeafPipeline

logger = logging.getLogger(__name__)

# codecs whose run streams are compacted on the device into one flat blob
# (tuple arity names the wire format: 7 rle3, 9 rle4, 11 rle5)
_COMPACT_CODECS = ("rle3", "rle3d", "rle4", "rle4d", "rle5", "rle5d")

# a stream whose frames overflow its frozen tier in this many consecutive
# batches gets its tier raised mid-run (instead of raw fetches for the rest
# of the run)
TIER_REFREEZE_AFTER = 2

# overflow_reasons() stream names -> packed-output keys
_STREAM_PKEY = {"grid": "grid_img_packed", "state": "state_imgs_packed",
                "opt": "option_imgs_packed"}


def _resolve_meta(m):
    """metas[] values are dicts or pool Futures of dicts."""
    return m.result() if hasattr(m, "result") else m


def _tree_map(fn, tree):
    leaves, treedef = transfer.tree_flatten(tree)
    return transfer.tree_unflatten(treedef, [fn(a) for a in leaves])


def _widen(a: np.ndarray) -> np.ndarray:
    """The host side of ``transfer.narrow``: the port's integers are
    int64."""
    return a.astype(np.int64) if a.dtype == np.int32 else a


def _compact_step(packed: dict, *, codec: str) -> dict:
    """Every per-frame packed stream of a batch compacted on the device
    (ops/rle.py ``compact_<codec>``, `codec` 'rle3', 'rle4' or 'rle5';
    delta streams, four arrays, through its 'd' form)."""
    plain = getattr(rle, f"compact_{codec}")
    delta = getattr(rle, f"compact_{codec}d")
    return {k: (delta if len(v) == 4 else plain)(*v)
            for k, v in packed.items()}


def _meta_task(sid, leaf, path, out_dir, sample_dir, grid_path, states_np,
               options_np, params_np, b, perm, correct, use_grid, grid_size,
               canvas_size, layout, seed, phash_hex, grid_only, export_json,
               export_coco, pretty):
    """Pool task: slice sample b out of the batch trees, build meta (and
    coco) and write the JSONs.  Failures become the error-record shape."""
    try:
        meta = build_sample_meta(
            sid, leaf, path, out_dir, sample_dir, grid_path,
            states_np.map(lambda a: a[b]), options_np.map(lambda a: a[b]),
            perm, correct, type(params_np)(*(a[b] for a in params_np)),
            use_grid, grid_size, canvas_size, layout, seed, (seed or 0) + sid,
            grid_only=grid_only)
        meta["grid_phash"] = phash_hex
        if export_json:
            write_json(os.path.join(sample_dir, "meta.json"), meta, pretty)
        if export_coco:
            coco = build_coco(sid, leaf, grid_path, out_dir, layout.grid_h,
                              meta["cells_meta"])
            write_json(os.path.join(sample_dir, "coco.json"), coco, pretty)
        return meta
    except Exception as e:  # pragma: no cover - defensive
        logger.error("meta build failed for sample %d: %s", sid, e)
        return {"index": int(sid), "error": True,
                "error_type": str(type(e)), "error_message": str(e)}


def _write_delta_sample(s_fr, o_fr, over_state, over_opt, b: int, L: int,
                        O: int, fh: int, fw: int, sample_dir: str,
                        perm) -> None:
    """Pool task: decode one sample's delta-coded frames and write their
    PNGs.  State t decodes against decoded state t-1 (state 0 is a
    keyframe; a raw overflow fetch stands in exactly), options against
    state L-1, the bases the pipeline packed against."""
    prev = np.zeros((fh, fw, 3), np.uint8)   # a keyframe reads no base
    for t in range(L):
        fi = b * L + t
        px = (over_state[fi] if fi in over_state
              else s_fr.unpack_delta(fi, prev, (fh, fw)))
        write_png(os.path.join(sample_dir, f"state_{t}.png"), px)
        prev = px
    for pos in range(O):
        fi = b * O + pos
        src = int(perm[pos])
        name = "proto_true_next.png" if src == 0 else f"option_{src}.png"
        px = (over_opt[fi] if fi in over_opt
              else o_fr.unpack_delta(fi, prev, (fh, fw)))
        write_png(os.path.join(sample_dir, name), px)


class RPMGenerator:
    def __init__(self, config: GenConfig, device: torch.device,
                 show_labels: bool = True, show_border: bool = True,
                 io_workers: int = 8, use_threads: bool = True, mesh=None):
        self.cfg = config
        if mesh is None:
            mesh = self._maybe_make_mesh(torch.device(device))
        if mesh is not None and config.batch_size % len(mesh.devices):
            raise ValueError(f"batch_size {config.batch_size} does not split "
                             f"over {len(mesh.devices)} devices")
        self.mesh = mesh
        self.device = mesh_lib.home_device(mesh, device)
        self.out_dir = config.out_dir
        self.samples_dir = os.path.join(self.out_dir, "samples")
        self.grids_dir = os.path.join(self.out_dir, "grids")
        ensure_dir(self.samples_dir)
        ensure_dir(self.grids_dir)
        self.show_labels = show_labels
        self.show_border = show_border
        self._pipelines: Dict[str, LeafPipeline] = {}
        self._pool = ExportPool(workers=io_workers, use_threads=use_threads)
        self._leaves = category_leaves(config.categories)
        self._bufs = HostBufferRing()
        self._corpus = None
        # the rest of each batch, replayed as CUDA graphs on a card
        # (utils/graphs.py): the keys' fold_in, the compaction of --sparse
        # and the blob; the dedup step replays in CorpusDedup
        self._keys = graphs.StepGraphs(prng.fold_in, counters=(prng_cuda,))
        self._compact = graphs.StepGraphs(_compact_step)
        self._coalesce = graphs.StepGraphs(transfer.blob_step)
        # the leaf's graph writes the blob where no stream is packed (cut
        # to tiers that move) and no mesh gathers shards before the blob
        self._leaf_blob = mesh is None and not config.sparse_transfer
        # largest counts seen per packed stream, per codec (tiers only
        # grow, so a codec with smaller streams must not inherit another's)
        W, H = config.canvas_size
        codec = config.transfer_codec
        suffix = "" if codec == "rle3" else f"_{codec}"
        self._stats_name = f"rpm_{W}x{H}_g{config.grid_size}{suffix}"
        self._run_stats: Dict[str, float] = load_run_stats(self._stats_name)
        # tiers freeze at generate_ids entry; the stats go on updating for
        # the next call and process
        self._tier_stats: Dict[str, float] = dict(self._run_stats)
        # bytes moved from the device to the host: blobs and raw fallbacks
        self.transfer_bytes: int = 0
        # frames that exceeded their (shrunk) codec capacity and came raw
        self.overflow_frames: int = 0
        self.tiers_refrozen: int = 0
        self._overflow_streak: Dict[str, int] = {}
        self._batch_ordinal: int = 0
        self.overflow_events: list = []  # (batch ordinal, {stream: frames})

    def _maybe_make_mesh(self, device: torch.device):
        """The 1-D data mesh over this host's cards (JAX
        models/rpm/generator.py ``_maybe_make_mesh``): none when
        ``use_mesh`` is False or one card (or the CPU) is in use; else
        ``auto_mesh``: the largest card count that divides the batch,
        starting from `device`.  Hosts scale out as
        independent processes over disjoint id shards (``--num_hosts``)
        with the dedup at the merge, so a multi-process world is refused
        rather than left to deadlock in the first collective."""
        if self.cfg.use_mesh is False:
            return None
        if mesh_lib.world()[0] > 1:
            raise NotImplementedError(
                "RPMGenerator does not run under a multi-process "
                "torch.distributed world: launch one independent process "
                "per host with --num_hosts/--host_id instead — disjoint id "
                "shards, merge-time cross-host dedup.")
        return mesh_lib.auto_mesh(device, self.cfg.batch_size)

    def _sample_assignments(self, sample_ids) -> Dict[str, List]:
        weights = [self.cfg.category_weights.get(l[-1], 1.0)
                   for l in self._leaves]
        groups: Dict[str, List] = defaultdict(list)
        for sid in sample_ids:
            rng = random.Random((self.cfg.seed or 0) + sid)
            path = rng.choices(self._leaves, weights=weights, k=1)[0]
            use_grid = rng.choice([False, True])
            groups[path[-1]].append((sid, path, use_grid))
        return groups

    def _pipeline(self, leaf: str) -> LeafPipeline:
        if leaf not in self._pipelines:
            self._pipelines[leaf] = LeafPipeline(
                leaf, self.cfg, show_labels=self.show_labels,
                show_border=self.show_border)
        return self._pipelines[leaf]

    def generate(self, n: int, progress: bool = False, dedup: bool = False,
                 dedup_threshold: int = 4, resume: bool = False) -> List[dict]:
        return self.generate_ids(list(range(n)), progress=progress,
                                 dedup=dedup, dedup_threshold=dedup_threshold,
                                 resume=resume)

    def generate_sample(self, sample_id: int, category_path=None,
                        show_labels: bool = True, show_border: bool = True):
        """One sample -> its meta dict, or None if its export failed.
        `category_path` pins the rule leaf: the sample's weighted leaf draw
        is consumed and then overruled, so its use_grid coin is the one
        ``generate_ids`` would toss.  `show_labels` and `show_border` are
        accepted and not read: labels and borders are the generator's (they
        are baked into its layouts).  The batch is padded to the batch size
        as everywhere; batches are the production path."""
        if category_path is None:
            metas = self.generate_ids([sample_id])
            meta = metas[0] if metas else None
            return None if (meta and meta.get("error")) else meta
        leaf = category_path[-1]
        rng = random.Random((self.cfg.seed or 0) + sample_id)
        rng.choices(self._leaves, k=1)
        use_grid = rng.choice([False, True])
        metas: Dict[int, dict] = {}
        self._corpus = None
        self._flush(self._dispatch(
            leaf, self._pipeline(leaf),
            [(sample_id, list(category_path), use_grid)]), metas)
        self._pool.drain()
        meta = _resolve_meta(metas.get(sample_id))
        return None if (meta and meta.get("error")) else meta

    def _batches(self, sample_ids):
        """(pipeline, keys, use_grid, real samples) of every padded batch
        the ids make, leaf by leaf."""
        B = self.cfg.batch_size
        for leaf, entries in self._sample_assignments(sample_ids).items():
            pipe = self._pipeline(leaf)
            for start in range(0, len(entries), B):
                chunk = entries[start:start + B]
                yield (pipe, *self._batch_inputs(chunk), len(chunk))

    def _batch_inputs(self, chunk):
        """Keys and use_grid of a chunk padded to the batch size (each key
        comes from its id alone, so padding never changes a sample)."""
        ids = [e[0] for e in chunk]
        pad = self.cfg.batch_size - len(ids)
        use_grid = upload([e[2] for e in chunk] + [False] * pad, torch.bool,
                          self.device)
        ids = upload(ids + [ids[-1]] * pad, torch.int64, self.device)
        seed = self.cfg.seed or 0
        base = constant(("key", seed), self.device, lambda: prng.key(seed))
        return self._keys(base, ids), use_grid

    def _run(self, pipe: LeafPipeline, keys, use_grid):
        """One padded batch through its pipeline -> (outputs, pHashes).
        Where the leaf's graph writes the blob (``_leaf_blob``) the outputs
        are the blob and its layout.  On a mesh each device runs its
        shard, and the outputs are gathered on the first device, where
        JAX's jit boundary gathers them; the pHashes stay on their shards
        for the dedup's gather."""
        if self._leaf_blob:
            blob, layout, hashes = pipe.blob(
                keys, use_grid,
                flat=self.cfg.transfer_codec in _COMPACT_CODECS)
            return (blob, layout), hashes
        if self.mesh is None:
            out = pipe(keys, use_grid)
            return out, out["grid_phash"]
        outs = [pipe(k, u) for k, u in
                mesh_lib.shard_batch(self.mesh, (keys, use_grid))]
        return (mesh_lib.gather_batch(self.mesh, outs),
                [o["grid_phash"] for o in outs])

    def _sync(self):
        devs = self.mesh.devices if self.mesh is not None else (self.device,)
        for d in set(devs):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def warmup(self, sample_ids: List[int]) -> None:
        """Run every pipeline the ids would use once, without copying
        anything to the host and without export.  On a card this captures
        the CUDA graph of every (leaf, batch size, device) the ids use, as
        the JAX package's warmup compiles them, and builds and loads the
        rasterizer kernel on the way, so a caller can keep both out of a
        timed window."""
        for pipe, keys, use_grid, _n in self._batches(sample_ids):
            self._run(pipe, keys, use_grid)
        self._sync()

    def measure_device_rate(self, sample_ids: List[int], iters: int = 10,
                            blocking: bool = False) -> float:
        """Samples/s of the pipelines alone (no copy to the host, no
        export): per batch, `iters` calls queued back to back and one
        synchronisation at the end, or one after every call when
        `blocking`.  Full batches are preferred (the padding of a ragged
        last batch would be billed as dead time); call ``warmup`` first."""
        jobs = []
        by_pipe: Dict[int, list] = defaultdict(list)
        for job in self._batches(sample_ids):
            by_pipe[id(job[0])].append(job)
        for leaf_jobs in by_pipe.values():
            full = [j for j in leaf_jobs if j[3] == self.cfg.batch_size]
            jobs.extend(full if full else leaf_jobs[:1])
        total_samples, total_time = 0, 0.0
        for pipe, keys, use_grid, n_real in jobs:
            self._run(pipe, keys, use_grid)
            self._sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                self._run(pipe, keys, use_grid)
                if blocking:
                    self._sync()
            self._sync()
            total_time += time.perf_counter() - t0
            total_samples += n_real * iters
        return total_samples / total_time if total_time > 0 else 0.0

    def _load_existing_meta(self, sid: int):
        """Resume: a sample with a readable meta.json is reused."""
        path = os.path.join(self.samples_dir, f"sample_{sid:06d}", "meta.json")
        if os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    return json.load(f)
            except (OSError, json.JSONDecodeError):
                return None
        return None

    def generate_ids(self, sample_ids: List[int], progress: bool = False,
                     dedup: bool = False, dedup_threshold: int = 4,
                     resume: bool = False) -> List[dict]:
        metas: Dict[int, dict] = {}
        if resume:
            remaining = []
            for sid in sample_ids:
                meta = self._load_existing_meta(sid)
                if meta is not None:
                    metas[sid] = meta
                else:
                    remaining.append(sid)
            sample_ids = remaining
        with profiling.span("rpm.call", leaf=False, n=len(sample_ids)):
            self._corpus = (CorpusDedup(len(sample_ids), self.device,
                                        threshold=dedup_threshold,
                                        mesh=self.mesh)
                            if dedup else None)
            self._tier_stats = dict(self._run_stats)
            groups = self._sample_assignments(sample_ids)
            t0 = time.time()
            done = 0
            B = self.cfg.batch_size
            pending, k = None, 0
            for leaf, entries in groups.items():
                pipe = self._pipeline(leaf)
                for start in range(0, len(entries), B):
                    chunk = entries[start:start + B]
                    # a batch's span lasts from its dispatch to its last
                    # file, and counts the frames it ships by stream, of
                    # which transfer.overflow fetches some again raw
                    n = len(chunk)
                    batch = profiling.begin(
                        "rpm.batch", batch=k, leaf=leaf, n_real=n, grid=n,
                        state=0 if self.cfg.grid_only else n * pipe.L,
                        opt=0 if self.cfg.grid_only
                        else n * self.cfg.num_options,
                        blob="leaf" if self._leaf_blob else "step")
                    k += 1
                    # batch k+1 is on the device before batch k is exported
                    with profiling.within(batch):
                        st = self._dispatch(leaf, pipe, chunk)
                    if pending is not None:
                        done += self._flush(pending[0], metas, pending[1])
                        if progress:
                            logger.info(
                                "generated %d samples (%.2f samples/s)",
                                done, done / max(time.time() - t0, 1e-9))
                    pending = st, batch
            if pending is not None:
                done += self._flush(pending[0], metas, pending[1])
                if progress:
                    logger.info("generated %d samples (%.2f samples/s)", done,
                                done / max(time.time() - t0, 1e-9))
            self._pool.drain()
        return [_resolve_meta(metas[i]) for i in sorted(metas)]

    def _dispatch(self, leaf: str, pipe: LeafPipeline, chunk):
        """Run one chunk's pipeline (padded to the batch size), start the
        copy of its blob, submit its dedup and start the copy of the keep
        mask; the raw images a codec replaces stay on the device for the
        overflow fallback.  Nothing here waits for the device.  An
        ``rpm.dispatch`` span while spans are recorded."""
        with profiling.span("rpm.dispatch"):
            keys, use_grid = self._batch_inputs(chunk)
            out, hashes = self._run(pipe, keys, use_grid)
            n_real = len(chunk)
            if self._leaf_blob:
                (blob, layout), raw = out, {}
            else:
                blob, layout, raw = self._blob(leaf, out)
            copy = transfer.HostCopy(blob)
            keep = (transfer.HostCopy(self._corpus.submit(hashes, n_real)[1])
                    if self._corpus is not None else None)
            treedef, specs = layout.value
            return leaf, pipe, chunk, (copy, keep, treedef, specs, raw,
                                      n_real)

    def _blob(self, leaf: str, out: dict):
        """A batch's outputs through the blob step: its run streams
        compacted, cut to their tiers and fused -> (blob, layout, the raw
        images the packed streams replace)."""
        skip = set()
        if "state_imgs_packed" in out:
            skip |= {"state_imgs", "option_imgs"}
        if "grid_img_packed" in out:
            skip.add("grid_img")
        tree = {k: v for k, v in out.items() if k not in skip}
        codec = self.cfg.transfer_codec
        flat_blob = codec in _COMPACT_CODECS
        packed = {k: v for k, v in tree.items() if k.endswith("_packed")}
        if flat_blob and packed:
            tree.update(self._compact(packed, codec=codec.rstrip("d")))
        blob, layout = self._coalesce(
            tree, sizes=self._shrink_sizes(leaf, tree), flat=flat_blob)
        return blob, layout, {k: out[k] for k in skip}

    def _flush(self, pending, metas, batch_span=None) -> int:
        """Export one dispatched batch; a failure becomes per-sample error
        records in the index instead of aborting the run (reference
        src/cli.py:25-34).  The export is an ``rpm.export`` span under the
        batch's span `batch_span`, whose opener's hold it then releases."""
        leaf, pipe, chunk, sent = pending
        try:
            with profiling.within(batch_span), profiling.span("rpm.export"):
                self._export_batch(leaf, pipe, chunk, sent, metas)
        except Exception as e:
            tb = traceback.format_exc()
            logger.error("batch export failed (%s): %s", leaf, e)
            for sid, path, _ug in chunk:
                metas[sid] = {
                    "index": int(sid), "error": True,
                    "error_type": str(type(e)), "error_message": str(e),
                    "traceback": tb,
                }
        finally:
            profiling.release(batch_span)
        return len(chunk)

    def _shrink_sizes(self, leaf: str, tree) -> tuple:
        """Per-leaf truncation for coalesce_shrunk, in tree_flatten order.
        Compacted streams shrink each stream axis to the tier that covers
        the largest per-frame average this leaf has shown
        (transfer.compact_sizes); per-frame rle/rle2 buffers shrink their
        run axis to the largest count.  Everything else travels whole.  A
        frame that exceeds a shrunk capacity is fetched raw."""
        codec = self.cfg.transfer_codec
        sizes = []
        for key in sorted(tree):
            val = tree[key]
            n_leaves = len(transfer.tree_leaves(val))
            packed = key.endswith("_packed")
            if packed and n_leaves in (7, 9, 11) and codec in _COMPACT_CODECS:
                sizes += transfer.compact_sizes(
                    val, lambda name: self._tier_stats.get(
                        f"{leaf}:{key}:{name}"))
                continue
            if not (packed and codec in ("rle", "rle2")):
                sizes += [None] * n_leaves
                continue
            cap = int(val[0].shape[-1])
            t = transfer.transfer_tier(self._tier_stats.get(f"{leaf}:{key}"),
                                       cap)
            if t is None:
                sizes += [None] * n_leaves
            elif codec == "rle2":
                sizes += [(-1, t), (-2, t), None]
            else:
                sizes += [(-1, t), (-1, t), None]
        return tuple(sizes)

    def _update_run_stats(self, leaf: str, out, pipe: LeafPipeline) -> None:
        for key in ("state_imgs_packed", "option_imgs_packed",
                    "grid_img_packed"):
            if key not in out:
                continue
            cap = (pipe.grid_budget if key == "grid_img_packed"
                   else pipe.frame_budget)
            val = out[key]
            if len(val) in (7, 9, 11):           # per-frame averages
                totals, F = transfer.stream_totals(val, cap)
                for suf, tot in totals.items():
                    k = f"{leaf}:{key}:{suf}"
                    self._run_stats[k] = max(self._run_stats.get(k, 0.0),
                                             tot / F)
            else:
                k = f"{leaf}:{key}"
                self._run_stats[k] = max(self._run_stats.get(k, 0),
                                         int(np.asarray(val[2]).max()))

    def _note_overflow(self, leaf: str, why: dict) -> None:
        """Self-healing tiers: `why` is the per-stream overflow attribution
        ({'grid'/'state'/'opt': {'T'/'E'/'P'/'X'/'B'/'S': frames}}).  A
        stream that overflows TIER_REFREEZE_AFTER consecutive batches gets
        its frozen stat raised to the larger of its observed demand and
        1.5 times the old one."""
        hit = set()
        for name, reasons in why.items():
            pkey = _STREAM_PKEY[name]
            for suf, n in reasons.items():
                if n <= 0:
                    continue
                skey = f"{leaf}:{pkey}:{suf}"
                hit.add(skey)
                streak = self._overflow_streak.get(skey, 0) + 1
                self._overflow_streak[skey] = streak
                if streak < TIER_REFREEZE_AFTER:
                    continue
                old = self._tier_stats.get(skey)
                if old is None:
                    # the stream travelled whole: the device budget itself
                    # overflowed, which no tier can fix
                    continue
                new = max(self._run_stats.get(skey, 0.0), old * 1.5)
                self._tier_stats[skey] = new
                self._run_stats[skey] = max(self._run_stats.get(skey, 0.0),
                                            new)
                self._overflow_streak[skey] = 0
                self.tiers_refrozen += 1
                logger.info("tier_refrozen %s: %.1f -> %.1f avg/frame "
                            "(batch %d)", skey, old, new,
                            self._batch_ordinal)
        # a clean batch breaks a stream's streak
        self._clear_overflow_streaks(leaf, keep=hit)

    def _clear_overflow_streaks(self, leaf: str, keep=()) -> None:
        for k in self._overflow_streak:
            if k.startswith(f"{leaf}:") and k not in keep:
                self._overflow_streak[k] = 0

    def _export_batch(self, leaf: str, pipe: LeafPipeline, chunk, sent,
                      metas):
        self._batch_ordinal += 1
        copy, keep_copy, treedef, specs, raw, n_real = sent
        blob_np = copy.numpy()
        self.transfer_bytes += blob_np.nbytes
        keep = np.ones(n_real, bool)
        if keep_copy is not None:
            keep_np = keep_copy.numpy()
            self.transfer_bytes += keep_np.nbytes
            keep = keep_np[:n_real]
        full = (transfer.split_flat if blob_np.ndim == 1
                else transfer.split_blob)(blob_np, treedef, specs)
        # images keep the full batch (stable ring-buffer shapes); the rest
        # is cut to the real samples
        out = {k: (v if k.endswith("_packed")
                   else _tree_map(lambda a: _widen(a[:n_real]), v))
               for k, v in full.items()}
        out.update(raw)
        self._update_run_stats(leaf, out, pipe)
        L = pipe.L
        O = self.cfg.num_options
        layout = pipe.layout
        grid_only = self.cfg.grid_only
        codec = self.cfg.transfer_codec
        states_np, options_np, params_np = (out["states"], out["options"],
                                            out["params"])
        # rle2 writes PNGs straight from the per-frame run streams; the
        # compacted codecs from per-frame views into their streams
        direct = codec == "rle2" and "grid_img_packed" in out
        direct3 = (codec in _COMPACT_CODECS and "grid_img_packed" in out
                   and len(out["grid_img_packed"]) in (7, 9, 11))
        delta3 = direct3 and codec in ("rle3d", "rle4d", "rle5d")
        over_grid = over_state = over_opt = None
        if direct3:
            g_fr = rle.Rle3Frames(out["grid_img_packed"], pipe.grid_budget)
            streams = {"grid": (g_fr, n_real, out["grid_img"])}
            s_fr = o_fr = None
            if not grid_only:
                s_fr = rle.Rle3Frames(out["state_imgs_packed"],
                                      pipe.frame_budget, delta=delta3)
                o_fr = rle.Rle3Frames(out["option_imgs_packed"],
                                      pipe.frame_budget, delta=delta3)
                streams["state"] = (s_fr, n_real * L, out["state_imgs"])
                streams["opt"] = (o_fr, n_real * O, out["option_imgs"])
            over = self._fetch_overflow(leaf, streams)
            over_grid = over["grid"]
            over_state, over_opt = over.get("state"), over.get("opt")
        elif direct:
            over_grid = transfer.overflow_pixels(
                out["grid_img_packed"], out["grid_img"], n_real)
            if not grid_only:
                over_state = transfer.overflow_pixels(
                    out["state_imgs_packed"], out["state_imgs"], n_real * L)
                over_opt = transfer.overflow_pixels(
                    out["option_imgs_packed"], out["option_imgs"], n_real * O)
            self._count_overflow(over_grid, over_state, over_opt)
        else:
            grid_imgs, state_imgs, option_imgs = self._decode_images(
                out, codec, n_real)
        perms, correct = out["perm"], out["correct_index"]
        phashes = out["grid_phash"]
        gh, gw = out["grid_img"].shape[-3], out["grid_img"].shape[-2]
        if not grid_only:
            fh, fw = (out["state_imgs"].shape[-3],
                      out["state_imgs"].shape[-2])
        if direct:
            g_ln, g_co, g_cnt = out["grid_img_packed"]
            g_cap = g_ln.shape[-1]
            if not grid_only:
                s_ln, s_co, s_cnt = out["state_imgs_packed"]
                o_ln, o_co, o_cnt = out["option_imgs_packed"]
        overlay = (layout.overlay_rgb_u8, layout.overlay_a8)

        for b, (sid, path, use_grid) in enumerate(chunk):
            if not keep[b]:
                metas[sid] = {"id": int(sid), "category_path": list(path),
                              "rule": leaf, "duplicate": True}
                continue
            sample_dir = os.path.join(self.samples_dir, f"sample_{sid:06d}")
            ensure_dir(sample_dir)
            grid_path = os.path.join(self.grids_dir, f"grid_{sid:06d}.png")
            perm = perms[b]
            if not grid_only and delta3:
                # one task decodes the sample's state chain and options
                self._pool.submit(_write_delta_sample, s_fr, o_fr,
                                  over_state, over_opt, b, L, O, fh, fw,
                                  sample_dir, perm, kind="delta_sample")
            elif not grid_only:
                # distractor files keep their pre-shuffle index j
                names = [f"state_{t}.png" for t in range(L)] + [
                    "proto_true_next.png" if int(src) == 0
                    else f"option_{int(src)}.png" for src in perm[:O]]
                for j, name in enumerate(names):
                    fpath = os.path.join(sample_dir, name)
                    st = j < L
                    fi = b * L + j if st else b * O + (j - L)
                    if direct3:
                        over = over_state if st else over_opt
                        if fi in over:
                            self._pool.submit_png(fpath, over[fi])
                        else:
                            self._pool.submit_png_rle3(
                                fpath, s_fr if st else o_fr, fi, fh, fw)
                    elif direct:
                        ln, co, cnt = ((s_ln, s_co, s_cnt) if st
                                       else (o_ln, o_co, o_cnt))
                        ix = (b, j) if st else (b, j - L)
                        if int(cnt[ix]) > ln.shape[-1]:
                            self._pool.submit_png(
                                fpath, (over_state if st else over_opt)[fi])
                        else:
                            self._pool.submit_png_rle(
                                fpath, ln[ix], co[ix], int(cnt[ix]), fh, fw)
                    else:
                        self._pool.submit_png(
                            fpath, state_imgs[b, j] if st
                            else option_imgs[b, j - L])
            if not grid_only:
                self._pool.submit_png(os.path.join(sample_dir, "query.png"),
                                      layout.query_patch)
            if direct3 and b not in over_grid:
                # the pre-overlay canvas, the overlay blended on the host
                self._pool.submit_png_rle3(grid_path, g_fr, b, gh, gw,
                                           overlay=overlay)
            elif direct and int(g_cnt[b]) <= g_cap:
                self._pool.submit_png_rle(grid_path, g_ln[b], g_co[b],
                                          int(g_cnt[b]), gh, gw,
                                          overlay=overlay)
            else:
                # raw fallback frames are the full grid, overlay blended on
                # the device with the same integer formula
                self._pool.submit_png(grid_path, over_grid[b]
                                      if (direct or direct3) else grid_imgs[b])
            metas[sid] = self._pool.submit_task(
                _meta_task, sid, leaf, path, self.out_dir, sample_dir,
                grid_path, states_np, options_np, params_np, b, perm,
                int(correct[b]), bool(use_grid), self.cfg.grid_size,
                self.cfg.canvas_size, layout, self.cfg.seed,
                bytes(phashes[b]).hex(), grid_only, self.cfg.export_json,
                self.cfg.export_coco, self.cfg.pretty_json, kind="meta")

    def _fetch_overflow(self, leaf: str, streams: dict) -> dict:
        """`streams` {'grid'/'state'/'opt': (Rle3Frames, frames, raw device
        images)} -> {stream: {flat frame index: pixels}} of the frames
        over their shrunk capacity, fetched raw in one gathered copy a
        stream; counted, logged and fed to the self-healing tiers.  When
        one overflows, a ``transfer.overflow`` span while spans are
        recorded: the frames of each stream, the bytes and the tiers
        re-frozen."""
        idx = {n: fr.overflow_indices(f)
               for n, (fr, f, _raw) in streams.items()}
        if not any(i.size for i in idx.values()):
            self._clear_overflow_streaks(leaf)
            return {n: {} for n in streams}
        bytes0, refrozen0 = self.transfer_bytes, self.tiers_refrozen
        with profiling.span("transfer.overflow") as sp:
            over = {n: gather_frames(raw, idx[n])
                    for n, (_fr, _f, raw) in streams.items()}
            self._count_overflow(*over.values())
            why = {n: fr.overflow_reasons(f)
                   for n, (fr, f, _raw) in streams.items()}
            counts = {n: len(m) for n, m in over.items() if m}
            logger.info("overflow fallback %s: %s", counts,
                        {n: w for n, w in why.items() if w})
            self.overflow_events.append((self._batch_ordinal, counts))
            self._note_overflow(leaf, why)
            if sp is not None:
                sp.attrs.update(
                    {n: len(m) for n, m in over.items()},
                    bytes=self.transfer_bytes - bytes0,
                    refrozen=self.tiers_refrozen - refrozen0)
        return over

    def _count_overflow(self, *fetched) -> None:
        for m in fetched:
            if m:
                self.transfer_bytes += sum(a.nbytes for a in m.values())
                self.overflow_frames += len(m)

    def _decode_images(self, out, codec: str, n_real: int):
        """Host images (grid, states, options) of a batch whose frames
        crossed raw or through a per-frame codec ('rle', 'sparse'), the
        packed ones decoded into ring buffers (a fresh large buffer pays
        its page faults every batch).  A buffer that comes round again may
        still back PNG writes: the pool is drained first."""
        keys = ("grid_img", "state_imgs", "option_imgs")
        bufs, wrapped = {}, False
        for k in keys:
            if f"{k}_packed" in out:
                bufs[k], w = self._bufs.acquire(tuple(out[k].shape))
                wrapped |= w
        if wrapped:
            self._pool.drain()
        return tuple(transfer.unpack_images(out[f"{k}_packed"], out[k], codec,
                                            out=bufs[k])[:n_real]
                     if k in bufs else out.get(k) for k in keys)

    def close(self):
        save_run_stats(self._stats_name, self._run_stats)
        self._pool.close()
