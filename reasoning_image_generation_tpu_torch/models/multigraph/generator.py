# generator.py — multigraph host orchestration (batch + reference API).
"""GeometryGenerator: the single-image class-identification pipeline on
torch devices.

The JAX package's models/multigraph/generator.py:
``generate(mode, save_path, params_save_path, dpi, seed)`` returns a
GenerationRecord-shaped dict and writes a PNG and a params JSON with the
ShapeParameters field vocabulary (reference
multigraph_generation/parameter.py:11-30).  ``generate_batch`` builds N
scenes on the host, renders them in one call on the device (the plain
version on the CPU), packs them with ``transfer_codec`` ('rle4', the
default, or 'rle5'; ops/rle.py) and starts the copy of ONE blob that also
carries the dedup keep mask.  On a card that is a few CUDA graph
replays, as the JAX package's batch is a few compiled programs
(utils/graphs.py): the render (prep, K2 and, in a dedup run, the pHash),
the dedup step (ops/phash.py ``CorpusDedup``), the pack and the blob.
The host writes each PNG straight from the run streams
(``submit_png_rle3``) and fetches the frames that overflowed their budget
raw in one gathered copy.  The run buffer and the transfer tiers are
sized from run statistics persisted per codec and canvas
(utils/cache.py).
``generate_batches`` pipelines all of that one batch deep.  On a device
mesh (parallel/mesh.py; ``mesh=``, or every card when there are several)
each device renders and hashes its shard of a batch the mesh divides, and
the dedup keep mask (``sharded_dedup_mask``), the pack and the copy run on
the gathered batch.
"""
from __future__ import annotations

import os
import uuid
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np
import torch

from ...io import transfer
from ...io.writer import ExportPool, ensure_dir, write_json
from ...ops import rle
from ...ops.phash import CorpusDedup, phash
from ...parallel import mesh as mesh_lib
from ...utils import graphs, profiling
from ...utils.cache import load_run_stats, save_run_stats
from . import renderer_cuda
from .check import check_scene_inside, compute_scene_features
from .renderer import render_scene_tensors
from .scene import BOUNDS, build_scene_batch

_PARAM_FIELDS_DEFAULTS = {
    "rotation": 0.0, "edge_color": None, "line_width": None,
    "line_style": None, "fill_color": None, "alpha": None,
    "has_gradient": False, "gradient_colors": None,
    "has_mask": False, "mask_type": None,
    "has_decoration": False, "decoration_style": None,
}


def _render_step(scene, *, dpi: int, hashed: bool) -> Dict:
    """A scene batch's images (prep and K2) and, with `hashed`, their
    pHashes."""
    imgs = render_scene_tensors(scene, dpi)
    return {"imgs": imgs, "hashes": phash(imgs)} if hashed else {"imgs": imgs}


def _pack_step(imgs, *, budget: int, codec: str):
    """The batch's frames packed by ``transfer_codec`` 'rle4' or 'rle5'
    (ops/rle.py), `budget` runs a frame."""
    pack = rle.pack_batch_rle5 if codec == "rle5" else rle.pack_batch_rle4
    return pack(imgs, budget)


def _shape_params_dict(meta: Dict) -> Dict:
    """ShapeParameters.__dict__-shaped record (parameter.py:11-30)."""
    out = {
        "shape_id": meta.get("shape_id", ""),
        "shape_type": meta.get("shape_type", ""),
        "center": list(meta.get("center", (0.0, 0.0))),
        "bbox": list(meta.get("bbox", (0, 0, 0, 0))),
        "size": meta.get("size"),
    }
    for k, v in _PARAM_FIELDS_DEFAULTS.items():
        out[k] = meta.get(k, v)
    extra = {k: v for k, v in meta.items()
             if k not in out and k not in ("shape_id", "shape_type")}
    out["extra_params"] = _jsonable(extra)
    out["decoration_artists"] = []
    return _jsonable(out)


class GenerationRecord(dict):
    """Dict with attribute access: JSON-serializable like our records,
    attribute-addressable like the reference's dataclass
    (multigraph_generation/generator.py:43-53)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _finalize_record(rec: Dict, scene: Dict, bounds, dpi: int,
                     params_save_path: Optional[str]) -> None:
    """Pool task: fill in QC (and pair features for multi-shape scenes),
    then write the params JSON (compact, as the JAX package writes it)."""
    rec["qc"] = check_scene_inside(scene, bounds, dpi=dpi)
    if rec["shape_count"] > 1:
        rec["geos_features"] = _jsonable(compute_scene_features(scene))
    if params_save_path:
        d = os.path.dirname(params_save_path)
        if d:
            ensure_dir(d)
        write_json(params_save_path, rec)


class GeometryGenerator:
    def __init__(self, device: torch.device, bounds=BOUNDS,
                 global_scale: float = 1.3, io_workers: int = 8,
                 transfer_codec: str = "rle4", mesh=None):
        if transfer_codec not in ("rle4", "rle5"):
            raise ValueError(f"transfer_codec {transfer_codec!r}: rle4 or "
                             f"rle5")
        if mesh is None:
            # every card, as JAX models/multigraph/generator.py does
            mesh = mesh_lib.auto_mesh(device)
        self.mesh = mesh
        self.device = mesh_lib.home_device(mesh, device)
        self.transfer_codec = transfer_codec
        self.bounds = bounds
        self.global_scale = float(global_scale)
        self._pool = ExportPool(workers=io_workers)
        # largest counts seen per stream and canvas: the pack budget and
        # the transfer tiers (persisted, so a fresh process starts warm)
        self._run_stats: Dict[str, float] = load_run_stats("mg")
        # device->host bytes actually copied (blob and raw fallbacks)
        self.transfer_bytes: int = 0
        self.generation_history: List[Dict] = []
        # corpus pHash dedup, armed per generate_batches(dedup=True) run
        self._corpus = None
        # each batch's device work, replayed as CUDA graphs on a card
        # (utils/graphs.py): the render (with the pHash of a dedup run),
        # the pack and the blob; the dedup step replays in CorpusDedup
        self._render = graphs.StepGraphs(_render_step,
                                         counters=(renderer_cuda,))
        self._pack = graphs.StepGraphs(_pack_step)
        self._coalesce = graphs.StepGraphs(transfer.blob_step)

    def generate(self, mode: str = "random", save_path: Optional[str] = None,
                 params_save_path: Optional[str] = None, dpi: int = 200,
                 seed: Optional[int] = None,
                 center_on_canvas: bool = True) -> Dict:
        recs = self.generate_batch([seed if seed is not None else 0], [mode],
                                   [save_path], [params_save_path], dpi=dpi)
        # the reference API is synchronous: QC runs on the pool, so the
        # record is complete only after a drain
        self._pool.drain()
        return recs[0]

    def generate_batch(self, seeds, modes, save_paths=None,
                       params_save_paths=None, dpi: int = 200) -> List[Dict]:
        return self._finish_batch(self._dispatch_batch(
            seeds, modes, save_paths, params_save_paths, dpi))

    def generate_batches(self, seeds, modes, save_paths=None,
                         params_save_paths=None, dpi: int = 200,
                         batch_size: int = 16, progress=None,
                         dedup: bool = False,
                         dedup_threshold: int = 4) -> List[Dict]:
        """One-deep software pipeline: batch k+1's scene build and render
        are launched before batch k is copied to the host and exported.
        ``progress(done)`` is called after each finished batch.

        With ``dedup=True`` every rendered scene is pHashed on the device
        and filtered against the run's corpus (ops/phash.py::CorpusDedup);
        near-duplicates get a ``duplicate: True`` record and no PNG/JSON."""
        n = len(seeds)
        with profiling.span("mg.call", leaf=False, n=n):
            self._corpus = (CorpusDedup(n, self.device,
                                        threshold=dedup_threshold,
                                        mesh=self.mesh)
                            if dedup else None)
            save_paths = save_paths or [None] * n
            params_save_paths = params_save_paths or [None] * n
            records: List[Dict] = []
            pending = None
            for lo in range(0, n, batch_size):
                hi = min(lo + batch_size, n)
                # a batch's span lasts from its dispatch to its last file
                batch = profiling.begin(
                    "mg.batch", batch=lo // batch_size,
                    mode=",".join(sorted(set(modes[lo:hi]))), n_real=hi - lo)
                with profiling.within(batch):
                    st = self._dispatch_batch(
                        seeds[lo:hi], modes[lo:hi], save_paths[lo:hi],
                        params_save_paths[lo:hi], dpi)
                if pending is not None:
                    records.extend(self._finish_batch(*pending))
                    if progress:
                        progress(len(records))
                pending = st, batch
            if pending is not None:
                records.extend(self._finish_batch(*pending))
                if progress:
                    progress(len(records))
            self._corpus = None  # scope the corpus to this run
        return records

    def _render_imgs(self, batch, dpi: int, hashed: bool = False):
        """Render a scene batch -> (images on the generator's device, their
        pHashes or None).  The prep and K2 (``render_scene_tensors``), and
        with `hashed` the pHash, replay one CUDA graph per (dpi, scenes,
        hashed, device), the key of the JAX package's ``mg-render-…``
        executables (utils/graphs.py); the scenes go up from pinned memory
        into the graph's inputs.  On a mesh that divides the batch each
        device renders and hashes its shard (K2 once a shard), the images
        are gathered and the hashes stay on their shards, for
        ``CorpusDedup``'s gather; a batch the mesh does not divide renders
        unsharded."""
        host = {k: torch.as_tensor(v) for k, v in batch.items()}
        n = len(next(iter(host.values())))
        if self.mesh is None or n % len(self.mesh.devices):
            out = self._render(host, device=self.device, dpi=dpi,
                               hashed=hashed)
            return out["imgs"], out.get("hashes")
        nd = len(self.mesh.devices)
        shards = [self._render({k: v.chunk(nd)[i] for k, v in host.items()},
                               device=d, dpi=dpi, hashed=hashed)
                  for i, d in enumerate(self.mesh.devices)]
        imgs = mesh_lib.gather_batch(self.mesh, [o["imgs"] for o in shards])
        return imgs, ([o["hashes"] for o in shards] if hashed else None)

    def _pack_budget(self, H: int, W: int) -> int:
        """Runs a scene may hold on the device (not the transfer tier): the
        palette's sort, top-k and scatters scale with this buffer, and mg
        outline scenes need a fraction of default_budget.  Twice the largest
        single-scene count seen ('M' stat) plus 1024, a power of two, at
        least 4096 and at most default_budget; a scene that overflows is
        fetched raw."""
        cap = rle.default_budget(H, W)
        st = self._run_stats.get(f"{self._skey_prefix()}:{H}x{W}:M")
        if not st:
            return cap
        want = int(st) * 2 + 1024
        return min(max(1 << (want - 1).bit_length(), 4096), cap)

    def _skey_prefix(self) -> str:
        return "mg5" if self.transfer_codec == "rle5" else "mg4"

    def _render_dispatch(self, imgs: torch.Tensor, extra=None) -> Dict:
        """Pack the batch, coalesce it (with `extra`, e.g. the keep mask)
        into one blob shrunk to the tiers, and start its copy to the host;
        -> the pending state for ``_render_finish``.  Nothing here waits
        for the device."""
        H, W = int(imgs.shape[-3]), int(imgs.shape[-2])
        budget = self._pack_budget(H, W)
        packed = self._pack(imgs, budget=budget, codec=self.transfer_codec)
        tree = packed if extra is None else (packed, extra)
        skey = f"{self._skey_prefix()}:{H}x{W}"
        sizes = transfer.compact_sizes(
            packed, lambda name: self._run_stats.get(f"{skey}:{name}"))
        # extras ship whole
        sizes += (None,) * (len(transfer.tree_leaves(tree)) - len(sizes))
        blob, layout = self._coalesce(tree, sizes=sizes, flat=True)
        treedef, specs = layout.value
        return {"copy": transfer.HostCopy(blob), "treedef": treedef,
                "specs": specs, "skey": skey, "imgs": imgs, "hw": (H, W),
                "budget": budget, "has_extra": extra is not None}

    def _render_finish(self, st: Dict):
        """Wait for the blob and build the host views: the frames' streams,
        the raw overflow frames, the blob-carried extras; and update the
        run statistics."""
        blob = st["copy"].numpy()
        self.transfer_bytes += blob.nbytes
        tree = transfer.split_flat(blob, st["treedef"], st["specs"])
        packed, extra = tree if st["has_extra"] else (tree, None)
        frames = rle.Rle3Frames(packed, st["budget"])
        skey = st["skey"]
        totals, F = transfer.stream_totals(packed, st["budget"])
        for suf, tot in totals.items():
            k = f"{skey}:{suf}"
            self._run_stats[k] = max(self._run_stats.get(k, 0.0), tot / F)
        # the largest single-scene count (cnt is the count before the cap)
        mk = f"{skey}:M"
        self._run_stats[mk] = max(self._run_stats.get(mk, 0),
                                  int(frames.cnt.max()))
        over = transfer.gather_frames(st["imgs"], frames.overflow_indices(F))
        self.transfer_bytes += sum(a.nbytes for a in over.values())
        return frames, over, st["hw"], extra

    def _dispatch_batch(self, seeds, modes, save_paths, params_save_paths,
                        dpi: int) -> Dict:
        n = len(seeds)
        with profiling.span("mg.scene_build"):
            batch, metas = build_scene_batch(seeds, modes, self.global_scale)
        with profiling.span("mg.dispatch"):
            imgs, hashes = self._render_imgs(batch, dpi,
                                             hashed=self._corpus is not None)
            extra = None
            if self._corpus is not None:
                # the keep mask rides inside the blob
                extra = {"keep": self._corpus.submit(hashes, n)[1]}
            st = self._render_dispatch(imgs, extra)
        st.update(seeds=seeds, modes=modes, dpi=dpi,
                  save_paths=save_paths or [None] * n,
                  params_save_paths=params_save_paths or [None] * n,
                  batch=batch, metas=metas)
        return st

    def _finish_batch(self, st: Dict, batch_span=None) -> List[Dict]:
        """Wait for the batch's blob and submit its files and QC: an
        ``mg.export`` span under the batch's span `batch_span`, whose
        opener's hold it then releases (it stays open until the export
        tasks the batch submitted end)."""
        try:
            with profiling.within(batch_span), profiling.span("mg.export"):
                return self._export_batch(st)
        finally:
            profiling.release(batch_span)

    def _export_batch(self, st: Dict) -> List[Dict]:
        seeds, modes = st["seeds"], st["modes"]
        save_paths, params_save_paths = (st["save_paths"],
                                         st["params_save_paths"])
        batch, metas, dpi = st["batch"], st["metas"], st["dpi"]
        n = len(seeds)
        frames, over, (H, W), extra = self._render_finish(st)
        keep = (extra["keep"][:n].astype(bool) if extra is not None
                else np.ones(n, bool))

        records = []
        for i in range(n):
            rec = GenerationRecord({
                "generation_id": str(uuid.uuid4()),
                "timestamp": datetime.now().isoformat(),
                "seed": int(seeds[i]),
                "mode": modes[i],
                "shape_count": metas[i]["shape_count"],
                "bounds": list(self.bounds),
                "global_scale": self.global_scale,
                "shapes": [_shape_params_dict(m) for m in metas[i]["shapes"]],
            })
            if not keep[i]:
                # near-duplicate of an earlier scene: record, don't export
                rec["duplicate"] = True
                self.generation_history.append(rec)
                records.append(rec)
                continue
            if save_paths[i]:
                d = os.path.dirname(save_paths[i])
                if d:
                    ensure_dir(d)
                if i in over:
                    self._pool.submit_png(save_paths[i], over[i])
                else:
                    # the C encoder writes straight from the run stream
                    self._pool.submit_png_rle3(save_paths[i], frames, i, H, W)
            scene_i = {k: v[i] for k, v in batch.items()}
            self._pool.submit(_finalize_record, rec, scene_i, self.bounds,
                              dpi, params_save_paths[i], kind="qc")
            self.generation_history.append(rec)
            records.append(rec)
        return records

    def close(self):
        save_run_stats("mg", self._run_stats)
        self._pool.close()
