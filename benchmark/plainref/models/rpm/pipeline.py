# pipeline.py — per-leaf batched sample generation.
"""One rule leaf's batch of RPM samples, end to end on one device:

  sample_prototype -> the leaf's rule steps (a Python loop over L-1 steps)
  -> K distractor candidates per option slot + structural-hash dedup ->
  option shuffle -> frame render (ops/raster_cuda.render_frames) ->
  grid composition -> grid pHash -> with ``sparse_transfer``, the frames
  and the grid packed for the copy to the host (ops/rle.py, ops/sparse.py)

The JAX package's models/rpm/pipeline.py with the batch written out: every
function takes keys ``[B, 2]`` and use_grid bool ``[B]``.  ``LeafPipeline.step``
is that batch function, run eagerly; ``LeafPipeline.__call__`` replays it
as a CUDA graph on a card (utils/graphs.py), where the JAX package runs its
jitted executable.
"""
from __future__ import annotations

import numpy as np
import torch

from ...device import upload
from ...ops import raster
from ...ops.compose import GridLayout, build_layout, compose_grid
from ...ops.phash import phash
from ...utils import prng
from ...utils.config import KIND_ID, OVERLAY_LEAVES, GenConfig
from ...utils.state import (ElementState, cat, recompute_bbox_from_center,
                            stack, tree_map)
from .rules import RULES, _gather_slots, _rank, concat_states, pack_state
from .sampler import sample_prototype

CIRCLE = KIND_ID["circle"]
N_CANDIDATES = 4
M32 = 0xFFFFFFFF


def seq_len_for(leaf: str) -> int:
    return 6 if leaf in OVERLAY_LEAVES else 4


def proto_n_for(leaf: str):
    """Initial element count per rule (reference src/generator.py:327-335)."""
    if leaf in ("单一遍历", "位置遍历"):
        return 2
    if leaf in ("平移", "旋转", "翻转(镜像)"):
        return 1
    return None


def _constrain_prototype(leaf: str, keys, st: ElementState, W, H, grid_size=3):
    """Leaf-specific validity constraints (no circle for 旋转, no centre-cell
    element for 翻转(镜像))."""
    if leaf == "旋转":
        k = prng.randint(keys, (st.num_slots,), 0, 10)
        k = torch.where(k >= CIRCLE, k + 1, k)
        return st._replace(kind=torch.where(st.kind == CIRCLE, k, st.kind))
    if leaf == "翻转(镜像)":
        cell_w, cell_h = W / grid_size, H / grid_size
        mid = grid_size // 2
        in_center = ((torch.floor(st.cx / cell_w) == mid) &
                     (torch.floor(st.cy / cell_h) == mid) & st.valid)
        new_cx = torch.where(in_center, st.cx - cell_w, st.cx)
        new_cx = torch.where(new_cx < 0, new_cx + W, new_cx)
        return st._replace(cx=new_cx)
    return st


def _q(x):
    """round(x) converted to uint32 as XLA converts: saturating, so a
    negative value becomes 0."""
    return torch.round(x).double().clamp(0, M32).long()


def state_hash(st: ElementState) -> torch.Tensor:
    """Order-independent structural hash of each frame (uint32 values in an
    int64 tensor ``[...]``): FNV-style multiply-add per element, summed
    over the valid slots."""
    fields = [
        st.kind, _q(st.size), _q(st.cx), _q(st.cy), _q(st.angle * 8.0),
        st.fill.long(), _q(st.stroke),
        _q(st.color[..., 0]), _q(st.color[..., 1]), _q(st.color[..., 2]),
        _q(st.bbox[..., 0]), _q(st.bbox[..., 1]), _q(st.bbox[..., 2]),
        _q(st.bbox[..., 3]), st.flip_h.long(), st.flip_v.long(),
    ]
    h = torch.full(st.kind.shape, 2166136261, dtype=torch.int64,
                   device=st.kind.device)
    for f in fields:
        h = (h * 16777619 + f) & M32
    h = torch.where(st.valid, h | 1, torch.zeros_like(h))
    return h.sum(-1) & M32


def _random_subset(keys, st: ElementState) -> ElementState:
    """random.sample(elems, randint(0, n)) on fixed slots."""
    k1, k2 = prng.split(keys, 2).unbind(-2)
    n = st.count()
    c = prng.randint(k1, (), 0, n + 1)
    scores = torch.where(st.valid, prng.uniform(k2, (st.num_slots,)),
                         torch.inf)
    return pack_state(st, (_rank(scores) < c[:, None]) & st.valid,
                      st.num_slots)


def _repeat(x, k: int):
    """[B, ...] -> [B*k, ...], each row repeated k times in a row."""
    return x.repeat_interleave(k, dim=0)


def _select(st: ElementState, pick):
    """st ``[B, C, E...]`` -> ``[B, E...]`` at candidate pick[b]."""
    return st.map(lambda a: _gather_slots(a, pick[:, None]).squeeze(1))


def make_sample_fn(leaf: str, cfg: GenConfig):
    """The batched per-sample generation function of one leaf: keys
    ``[B, 2]``, use_grid ``[B]`` -> dict of batched outputs."""
    W, H = cfg.canvas_size
    E = cfg.max_elems
    L = seq_len_for(leaf)
    O = cfg.num_options
    init_fn, step_fn = RULES[leaf]
    n0 = proto_n_for(leaf)
    gs = cfg.grid_size

    def distractor_candidates(keys, prev2, prev1, use_grid, j: int):
        if leaf in OVERLAY_LEAVES:
            k1, k2 = prng.split(keys, 2).unbind(-2)
            return concat_states(_random_subset(k1, prev1),
                                 _random_subset(k2, prev2), E)
        if leaf == "翻转(镜像)" and j == 1:
            return prev1
        k1, k2 = prng.split(keys, 2).unbind(-2)
        params = init_fn(k1, prev1, use_grid, W, H, gs)
        new, _ = step_fn(prev2, prev1, params, k2, 1, use_grid, W, H, gs)
        return new

    def sample(keys, use_grid):
        B = keys.shape[0]
        kp, kc, kr, kd, ksh, kscan = prng.split(keys, 6).unbind(-2)
        init = sample_prototype(kp, W, H, E, n=n0, use_grid=use_grid,
                                grid_size=gs)
        init = _constrain_prototype(leaf, kc, init, W, H, gs)
        params = init_fn(kr, init, use_grid, W, H, gs)

        step_keys = prng.split(kscan, L - 1)
        seq = [init]
        prev, cur = init, init
        for i in range(1, L):
            new, params = step_fn(prev, cur, params, step_keys[:, i - 1], i,
                                  use_grid, W, H, gs)
            prev, cur = cur, new
            seq.append(new)
        states = stack(seq, 1)                                # [B, L, E]
        correct, prev1, prev2 = seq[L - 1], seq[L - 2], seq[L - 3]

        # distractors: K candidates per slot, first non-duplicate wins; O
        # shifted copies of the last frame close the all-collide hole
        # the shifts rounded to float32, as the JAX package's array holds them
        shifts = [float(np.float32((p * W) / (O + 1)))
                  for p in range(1, O + 1)]
        fallback = stack([recompute_bbox_from_center(
            prev1._replace(cx=torch.remainder(prev1.cx + amt, W)), W, H)
            for amt in shifts], 1)                            # [B, O, E]
        opt_states = [correct]
        hashes = [state_hash(correct)]
        dkeys = prng.split(kd, O - 1)
        K = N_CANDIDATES
        p2, p1, ug = (prev2.map(lambda a: _repeat(a, K)),
                      prev1.map(lambda a: _repeat(a, K)), _repeat(use_grid, K))
        for j in range(1, O):
            ckeys = prng.split(dkeys[:, j - 1], K).reshape(B * K, 2)
            cands = distractor_candidates(ckeys, p2, p1, ug, j)
            cands = cands.map(lambda a: a.reshape((B, K) + a.shape[1:]))
            cands = cat([cands, fallback], 1)                 # [B, K+O, E]
            chashes = state_hash(cands)                       # [B, K+O]
            taken = torch.stack(hashes, 1)                    # [B, j]
            ok = (chashes[:, :, None] != taken[:, None, :]).all(2)
            pick = ok.long().argmax(1)
            opt_states.append(_select(cands, pick))
            hashes.append(torch.gather(chashes, 1, pick[:, None])[:, 0])
        options = stack(opt_states, 1)                        # [B, O, E]

        if cfg.shuffle_options:
            perm = prng.permutation(ksh, O)
        else:
            perm = torch.arange(O, device=keys.device).expand(B, O)
        options = options.map(lambda a: _gather_slots(a, perm))
        correct_index = (perm == 0).long().argmax(1)
        rframes = tree_map(lambda s, o: torch.cat([s, o], 1), states, options)
        return {"states": states, "options": options, "rframes": rframes,
                "perm": perm, "correct_index": correct_index,
                "use_grid": use_grid, "params": params}

    return sample


class LeafPipeline:
    """Batched generator for one rule leaf on one device."""

    def __init__(self, leaf: str, cfg: GenConfig, show_labels: bool = True,
                 show_border: bool = True):
        self.leaf = leaf
        self.cfg = cfg
        W, H = cfg.canvas_size
        self.L = seq_len_for(leaf)
        self.layout: GridLayout = build_layout(
            W, H, n_states=self.L - 1, num_options=cfg.num_options,
            show_labels=show_labels, show_border=show_border,
            bg_color=cfg.bg_color)
        self._sample = make_sample_fn(leaf, cfg)

    def step(self, keys: torch.Tensor, use_grid: torch.Tensor) -> dict:
        """One batch, eagerly: keys ``[B, 2]``, use_grid bool ``[B]`` ->
        states, options, perm, correct_index, use_grid, params, grid_img,
        grid_phash, and (unless grid_only) state_imgs and option_imgs; with
        ``sparse_transfer`` also their packed streams.  It reads nothing
        back to the host and copies nothing from it (the batch function the
        JAX package jits)."""
        cfg = self.cfg
        W, H = cfg.canvas_size
        L = self.L
        out = self._sample(keys, use_grid)
        rframes = out.pop("rframes")                          # [B, F, E]
        B, F = rframes.kind.shape[:2]
        flat = rframes.map(lambda a: a.flatten(0, 1))
        imgs = raster.render_frames(
            flat, W, H, use_grid.repeat_interleave(F), cfg.grid_size)
        imgs = imgs.reshape((B, F) + imgs.shape[1:])
        state_imgs, option_imgs = imgs[:, :L], imgs[:, L:]
        out["grid_img"], grids_pre = compose_grid(
            self.layout, state_imgs[:, :L - 1], option_imgs, return_pre=True)
        out["grid_phash"] = phash(out["grid_img"])
        if not cfg.grid_only:
            out["state_imgs"] = state_imgs
            out["option_imgs"] = option_imgs
        return out


def sample_keys(seed: int, sample_ids, device=None) -> torch.Tensor:
    """Per-sample keys fold_in(key(seed), id) -> ``[B, 2]`` on `device`
    (the ids go up without waiting for the device)."""
    ids = upload(sample_ids, torch.int64, device)
    return prng.fold_in(prng.key(seed, ids.device), ids)
