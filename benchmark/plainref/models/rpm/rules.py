# rules.py — sequence-transformation rule engine, batched over samples.
"""The 9 rule leaves of the JAX package (models/rpm/rules.py) with the
batch written out.

Each leaf is an ``init_<rule>(keys, init_state, use_grid, W, H, gs)`` /
``step_<rule>(prev, cur, params, keys, i, use_grid, W, H, gs)`` pair over
states ``[B, E]``, keys ``[B, 2]`` and use_grid bool ``[B]``; params are
NamedTuples of ``[B, ...]`` tensors.  ``i`` is the step index, a Python
int (the JAX package's ``lax.scan`` becomes a Python loop in
pipeline.py).  The draws come from the same key stream as the JAX
package's, so the sequences are equal element for element.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...device import constant
from ...ops.raster import DEG2RAD, cos_sin
from ...utils import prng
from ...utils.config import KIND_ID, SHAPE_KINDS
from ...utils.state import ElementState, tree_map, where
from .sampler import sample_prototype

CIRCLE = KIND_ID["circle"]
MAXSEQ = 8
MAX_ANGLE_CHOICES = 8

_DEFAULT_ANGLES = [0, 45, 90, 135, 180, 225, 270, 315]
_ANGLES_BY_KIND = {
    "triangle": [30, 45, 60, 90],
    "square": [30, 45, 60],
    "rounded_square": [30, 45, 60],
    "diamond": [30, 45, 60, 90],
    "star": [30, 45, 60, 90],
}


def _angle_table():
    tab = np.zeros((len(SHAPE_KINDS), MAX_ANGLE_CHOICES), np.float32)
    cnt = np.zeros((len(SHAPE_KINDS),), np.int64)
    for i, k in enumerate(SHAPE_KINDS):
        allowed = _ANGLES_BY_KIND.get(k, _DEFAULT_ANGLES)
        if k == "circle":
            allowed = [0]
        tab[i, :len(allowed)] = allowed
        tab[i, len(allowed):] = allowed[0]
        cnt[i] = len(allowed)
    return tab, cnt


ANGLE_TAB, ANGLE_CNT = _angle_table()
_TRAVERSE_KINDS = np.asarray([KIND_ID[k] for k in
                              ("square", "circle", "triangle", "diamond", "star")])
_STEPS = np.asarray([-2, -1, 1, 2])
_TM_ROT = np.asarray([45., 90., 135., 180., 225., 270., 315.], np.float32)


_TABLES = {"steps": _STEPS, "tm_rot": _TM_ROT, "angle_tab": ANGLE_TAB,
           "angle_cnt": ANGLE_CNT, "traverse_kinds": _TRAVERSE_KINDS}


def _t(name: str, like):
    """The table `name` of _TABLES on `like`'s device (built once there)."""
    return constant(("rules", name), like.device, lambda: _TABLES[name])


def _slot(st: ElementState):
    return torch.arange(st.num_slots, device=st.kind.device)


def _take(x, idx):
    """x[b, idx[b]] for x ``[B, E, ...]``, idx ``[B]``."""
    i = idx.reshape((-1, 1) + (1,) * (x.ndim - 2)).expand(
        (x.shape[0], 1) + x.shape[2:])
    return torch.gather(x, 1, i).squeeze(1)


def _choice(keys, table_row, count):
    """Uniform choice among the first `count` entries of padded rows."""
    i = prng.randint(keys, (), 0, torch.clamp(count, min=1))
    return _take(table_row, i)


def _rand_pick_valid(keys, valid):
    """Uniform index among each row's valid slots."""
    n = torch.clamp(valid.sum(-1), min=1)
    r = prng.randint(keys, (), 0, n)
    cum = torch.cumsum(valid.long(), -1) - 1
    return ((cum == r[:, None]) & valid).long().argmax(-1)


def _clip_bbox(bx, by, bw, bh, W, H):
    bx = torch.clamp(bx, min=0.0)
    by = torch.clamp(by, min=0.0)
    shift_x = torch.clamp(bx + bw - W, min=0.0)
    shift_y = torch.clamp(by + bh - H, min=0.0)
    bx = torch.clamp(bx - shift_x, min=0.0)
    by = torch.clamp(by - shift_y, min=0.0)
    bw = torch.where(bx + bw > W, torch.clamp(W - bx, min=1.0), bw)
    bh = torch.where(by + bh > H, torch.clamp(H - by, min=1.0), bh)
    return bx, by, bw, bh


def _set_elem(state: ElementState, idx, **fields) -> ElementState:
    """state.<field>[b, idx[b]] = value[b] for each given field."""
    hit = _slot(state)[None, :] == idx[:, None]
    upd = {}
    for name, val in fields.items():
        arr = getattr(state, name)
        h = hit.reshape(hit.shape + (1,) * (arr.ndim - 2))
        upd[name] = torch.where(h, val.unsqueeze(1), arr)
    return state._replace(**upd)


def pack_state(state: ElementState, keep, max_out: int) -> ElementState:
    """Compact kept elements to the front slots (stable), mask the rest."""
    keep = keep & state.valid
    order = torch.argsort((~keep).long(), dim=-1, stable=True)
    gathered = tree_map(lambda a: _gather_slots(a, order), state)
    n_keep = keep.sum(-1, keepdim=True)
    new_valid = _slot(state)[None, :] < torch.clamp(n_keep, max=max_out)
    return gathered._replace(valid=new_valid)


def _gather_slots(a, order):
    i = order.reshape(order.shape + (1,) * (a.ndim - 2)).expand(
        order.shape + a.shape[2:])
    return torch.gather(a, 1, i)


def concat_states(a: ElementState, b: ElementState, max_out: int) -> ElementState:
    joined = tree_map(lambda x, y: torch.cat([x, y], 1), a, b)
    packed = pack_state(joined, joined.valid, 2 * a.num_slots)
    return packed.map(lambda x: x[:, :max_out])


def _deg_cos_sin_abs(delta):
    c, s = cos_sin(delta * DEG2RAD)
    return torch.abs(c), torch.abs(s)


# ===========================================================================
# 平移 rule_translate
# ===========================================================================

class TranslateParams(NamedTuple):
    idx: torch.Tensor
    is_horizontal: torch.Tensor
    dist: torch.Tensor


def init_translate(keys, init_state, use_grid, W, H, grid_size=3):
    k1, k2, k3 = prng.split(keys, 3).unbind(-2)
    idx = _rand_pick_valid(k1, init_state.valid)
    is_h = prng.bernoulli(k2)
    step = _t("steps", keys)[prng.randint(k3, (), 0, 4)]
    dist = torch.where(use_grid, step, step * (min(W, H) // 3))
    return TranslateParams(idx, is_h, dist)


def step_translate(prev, cur, p: TranslateParams, keys, i, use_grid, W, H,
                   grid_size=3):
    st = cur
    e = p.idx
    cx, cy = _take(st.cx, e), _take(st.cy, e)
    bbox = _take(st.bbox, e)
    bw, bh = torch.clamp(bbox[:, 2], min=1.0), torch.clamp(bbox[:, 3], min=1.0)
    cell_w, cell_h = W / grid_size, H / grid_size
    col = torch.clamp(torch.floor(cx / cell_w), 0, grid_size - 1)
    row = torch.clamp(torch.floor(cy / cell_h), 0, grid_size - 1)
    zero = torch.zeros_like(p.dist)
    new_col = torch.remainder(col + torch.where(p.is_horizontal, p.dist, zero),
                              grid_size)
    new_row = torch.remainder(row + torch.where(p.is_horizontal, zero, p.dist),
                              grid_size)
    g_cx = torch.clamp(torch.round((new_col + 0.5) * cell_w), 0, W)
    g_cy = torch.clamp(torch.round((new_row + 0.5) * cell_h), 0, H)
    px_cx = cx + torch.where(p.is_horizontal, p.dist, zero)
    px_cy = cy + torch.where(p.is_horizontal, zero, p.dist)
    new_cx = torch.where(use_grid, g_cx, px_cx)
    new_cy = torch.where(use_grid, g_cy, px_cy)
    nbx, nby, nbw, nbh = _clip_bbox(torch.round(new_cx - bw / 2),
                                    torch.round(new_cy - bh / 2), bw, bh, W, H)
    st = _set_elem(st, e, cx=new_cx, cy=new_cy,
                   bbox=torch.stack([nbx, nby, nbw, nbh], -1))
    return st, p


# ===========================================================================
# 旋转 rule_rotate
# ===========================================================================

class RotateParams(NamedTuple):
    idx: torch.Tensor
    delta: torch.Tensor


def init_rotate(keys, init_state, use_grid, W, H, grid_size=3):
    k1, k2 = prng.split(keys, 2).unbind(-2)
    ok = init_state.valid & (init_state.kind != CIRCLE)
    idx = _rand_pick_valid(k1, ok)
    kind = _take(init_state.kind, idx)
    delta = _choice(k2, _t("angle_tab", keys)[kind],
                    _t("angle_cnt", keys)[kind])
    return RotateParams(idx, delta)


def step_rotate(prev, cur, p: RotateParams, keys, i, use_grid, W, H,
                grid_size=3):
    st = cur
    e = p.idx
    cur_angle = torch.remainder(_take(st.angle, e), 360.0)
    applied = torch.remainder(cur_angle + p.delta, 360.0)
    raw = torch.remainder(applied - cur_angle, 360.0)
    delta = torch.where(raw >= 180.0, raw - 360.0, raw)
    bbox = _take(st.bbox, e)
    bw, bh = torch.clamp(bbox[:, 2], min=1.0), torch.clamp(bbox[:, 3], min=1.0)
    c, s = _deg_cos_sin_abs(delta)
    nbw = torch.clamp(torch.round(bw * c + bh * s), min=1.0)
    nbh = torch.clamp(torch.round(bw * s + bh * c), min=1.0)
    nbx, nby, nbw, nbh = _clip_bbox(torch.round(_take(st.cx, e) - nbw / 2),
                                    torch.round(_take(st.cy, e) - nbh / 2),
                                    nbw, nbh, W, H)
    st = _set_elem(st, e, angle=applied,
                   bbox=torch.stack([nbx, nby, nbw, nbh], -1))
    return st, p


# ===========================================================================
# 翻转(镜像) rule_flip
# ===========================================================================

class FlipParams(NamedTuple):
    idx: torch.Tensor
    mode: torch.Tensor  # 0=h, 1=v, 2=both


def init_flip(keys, init_state, use_grid, W, H, grid_size=3):
    k1, k2 = prng.split(keys, 2).unbind(-2)
    cell_w, cell_h = W / grid_size, H / grid_size
    centered = ((torch.floor(init_state.cx / cell_w) == grid_size // 2) &
                (torch.floor(init_state.cy / cell_h) == grid_size // 2))
    ok = init_state.valid & ~centered
    ok = torch.where(ok.any(-1, keepdim=True), ok, init_state.valid)
    idx = _rand_pick_valid(k1, ok)
    mode = prng.randint(k2, (), 0, 3)
    return FlipParams(idx, mode)


def _flip_once(st: ElementState, e, mode, W, H):
    do_h = (mode == 0) | (mode == 2)
    do_v = (mode == 1) | (mode == 2)
    cx, cy = _take(st.cx, e), _take(st.cy, e)
    bbox = _take(st.bbox, e)
    bx, by = bbox[:, 0], bbox[:, 1]
    bw, bh = torch.clamp(bbox[:, 2], min=1.0), torch.clamp(bbox[:, 3], min=1.0)
    new_cx = torch.where(do_h, torch.round(W - cx), cx)
    new_cy = torch.where(do_v, torch.round(H - cy), cy)
    nbx = torch.where(do_h, torch.round(W - (bx + bw)), bx)
    nby = torch.where(do_v, torch.round(H - (by + bh)), by)
    nbx, nby, bw, bh = _clip_bbox(nbx, nby, bw, bh, W, H)
    fh, fv = _take(st.flip_h, e), _take(st.flip_v, e)
    return _set_elem(st, e, cx=new_cx, cy=new_cy,
                     bbox=torch.stack([nbx, nby, bw, bh], -1),
                     flip_h=torch.where(do_h, ~fh, fh),
                     flip_v=torch.where(do_v, ~fv, fv))


def step_flip(prev, cur, p: FlipParams, keys, i, use_grid, W, H, grid_size=3):
    return _flip_once(cur, p.idx, p.mode, W, H), p


# ===========================================================================
# 组合 rule_transform_many
# ===========================================================================

class TransformManyParams(NamedTuple):
    active: torch.Tensor     # bool [B, E]
    op: torch.Tensor         # [B, E]: 0=translate, 1=rotate, 2=flip
    dx: torch.Tensor
    dy: torch.Tensor
    grid_dist: torch.Tensor
    grid_is_h: torch.Tensor
    flip_mode: torch.Tensor
    rot_delta: torch.Tensor


def _rank(scores):
    return torch.argsort(torch.argsort(scores, dim=-1, stable=True), dim=-1,
                         stable=True)


def init_transform_many(keys, init_state, use_grid, W, H, grid_size=3):
    ks = prng.split(keys, 10).unbind(-2)
    E = init_state.num_slots
    n = torch.clamp(init_state.count(), min=1)
    max_select = torch.clamp(n, max=3)
    count = prng.randint(ks[0], (), 1, max_select + 1)
    scores = torch.where(init_state.valid, prng.uniform(ks[1], (E,)),
                         torch.inf)
    active = (_rank(scores) < count[:, None]) & init_state.valid
    op = prng.randint(ks[2], (E,), 0, 3)
    mn = min(W, H)
    off = prng.randint(ks[3], (), mn // 10, mn // 6 + 1).float()
    r = prng.uniform(ks[4])
    sgn = torch.where(prng.bernoulli(ks[5]), 1.0, -1.0)
    zero = torch.zeros_like(off)
    dx = torch.where(r < 0.5, sgn * off, zero)
    dy = torch.where(dx == 0, -off, zero)
    grid_dist = _t("steps", keys)[prng.randint(ks[6], (), 0, 4)]
    grid_is_h = prng.bernoulli(ks[7])
    flip_mode = prng.randint(ks[8], (), 0, 3)
    rot_delta = _t("tm_rot", keys)[prng.randint(ks[9], (), 0, 7)]
    return TransformManyParams(active, op, dx, dy, grid_dist, grid_is_h,
                               flip_mode, rot_delta)


def step_transform_many(prev, cur, p: TransformManyParams, keys, i, use_grid,
                        W, H, grid_size=3):
    st = cur
    E = st.num_slots
    slot_keys = prng.split(keys, E)
    cell_w, cell_h = W / grid_size, H / grid_size
    tab, cnt = _t("angle_tab", keys), _t("angle_cnt", keys)
    do_h = (p.flip_mode == 0) | (p.flip_mode == 2)
    do_v = (p.flip_mode == 1) | (p.flip_mode == 2)
    zero_i = torch.zeros_like(p.grid_dist)
    g_dx = torch.where(p.grid_is_h, p.grid_dist, zero_i)
    g_dy = torch.where(p.grid_is_h, zero_i, p.grid_dist)
    for e in range(E):
        active, op = p.active[:, e], p.op[:, e]
        is_t = active & (op == 0)
        is_r = active & (op == 1)
        is_f = active & (op == 2)
        cx, cy = st.cx[:, e], st.cy[:, e]
        bw = torch.clamp(st.bbox[:, e, 2], min=1.0)
        bh = torch.clamp(st.bbox[:, e, 3], min=1.0)

        col = torch.clamp(torch.floor(cx / cell_w), 0, grid_size - 1)
        row = torch.clamp(torch.floor(cy / cell_h), 0, grid_size - 1)
        ncol = torch.remainder(col + g_dx, grid_size)
        nrow = torch.remainder(row + g_dy, grid_size)
        lim_x = torch.clamp((cell_w - bw) / 2, min=0.0)
        lim_y = torch.clamp((cell_h - bh) / 2, min=0.0)
        off_x = torch.minimum(torch.maximum(cx - (col + 0.5) * cell_w, -lim_x),
                              lim_x)
        off_y = torch.minimum(torch.maximum(cy - (row + 0.5) * cell_h, -lim_y),
                              lim_y)
        t_cx = torch.where(use_grid,
                           torch.round((ncol + 0.5) * cell_w + off_x),
                           torch.remainder(torch.round(cx + p.dx), W))
        t_cy = torch.where(use_grid,
                           torch.round((nrow + 0.5) * cell_h + off_y),
                           torch.remainder(torch.round(cy + p.dy), H))

        kind = st.kind[:, e]
        snapped = _choice(slot_keys[:, e], tab[kind], cnt[kind])
        delta = torch.where(kind == CIRCLE, p.rot_delta, snapped)
        new_angle = torch.remainder(st.angle[:, e] + delta, 360.0)
        c, s = _deg_cos_sin_abs(delta)
        r_bw = torch.clamp(torch.round(bw * c + bh * s), min=1.0)
        r_bh = torch.clamp(torch.round(bw * s + bh * c), min=1.0)

        f_cx = torch.where(do_h, torch.round(W - cx), cx)
        f_cy = torch.where(do_v, torch.round(H - cy), cy)

        new_cx = torch.where(is_t, t_cx, torch.where(is_f, f_cx, cx))
        new_cy = torch.where(is_t, t_cy, torch.where(is_f, f_cy, cy))
        out_angle = torch.where(is_r, new_angle, st.angle[:, e])
        out_bw = torch.where(is_r, r_bw, bw)
        out_bh = torch.where(is_r, r_bh, bh)
        nbx, nby, out_bw, out_bh = _clip_bbox(
            torch.round(new_cx - out_bw / 2), torch.round(new_cy - out_bh / 2),
            out_bw, out_bh, W, H)
        fh, fv = st.flip_h[:, e], st.flip_v[:, e]
        idx = torch.full_like(kind, e)
        st = _set_elem(st, idx, cx=new_cx, cy=new_cy, angle=out_angle,
                       bbox=torch.stack([nbx, nby, out_bw, out_bh], -1),
                       flip_h=torch.where(is_f & do_h, ~fh, fh),
                       flip_v=torch.where(is_f & do_v, ~fv, fv))
    return st, p


# ===========================================================================
# overlay triplet 直接叠加 / 去同存异 / 去异存同
# ===========================================================================

class OverlayParams(NamedTuple):
    dummy: torch.Tensor


def init_overlay(keys, init_state, use_grid, W, H, grid_size=3):
    return OverlayParams(torch.zeros(keys.shape[0], device=keys.device))


def _pairwise_same(a: ElementState, b: ElementState,
                   iou_thresh=0.5, size_rel=0.2, angle_deg=5.0):
    """Same-element test matrix ``[B, Ea, Eb]`` (kind, IoU, size, angle)."""
    ax0, ay0 = a.bbox[:, :, None, 0], a.bbox[:, :, None, 1]
    aw, ah = a.bbox[:, :, None, 2], a.bbox[:, :, None, 3]
    bx0, by0 = b.bbox[:, None, :, 0], b.bbox[:, None, :, 1]
    bw, bh = b.bbox[:, None, :, 2], b.bbox[:, None, :, 3]
    x1 = torch.maximum(ax0, bx0)
    y1 = torch.maximum(ay0, by0)
    x2 = torch.minimum(ax0 + aw, bx0 + bw)
    y2 = torch.minimum(ay0 + ah, by0 + bh)
    inter = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    union = aw * ah + bw * bh - inter
    zero = torch.zeros((), device=inter.device)
    iou = torch.where(union > 0, inter / union, zero)
    sa, sb = a.size[:, :, None], b.size[:, None, :]
    smax = torch.maximum(sa, sb)
    srel = torch.where(smax > 0, torch.abs(sa - sb) / smax, zero)
    adiff = torch.abs(torch.remainder(
        a.angle[:, :, None] - b.angle[:, None, :] + 180.0, 360.0) - 180.0)
    same = ((a.kind[:, :, None] == b.kind[:, None, :]) &
            (iou >= iou_thresh) & (srel <= size_rel) & (adiff <= angle_deg))
    return same & a.valid[:, :, None] & b.valid[:, None, :]


def _replace_some(cur: ElementState, keys, use_grid, W, H, grid_size):
    """Replace r in [1, n-1] random elements with fresh prototype elements,
    or append one when n <= 1."""
    k1, k2, k3 = prng.split(keys, 3).unbind(-2)
    E = cur.num_slots
    n = cur.count()
    proto = sample_prototype(k3, W, H, E, n=None, use_grid=use_grid,
                             grid_size=grid_size)
    append_case = (n <= 1)[:, None]
    first_free = cur.valid.long().argmin(-1)
    r = prng.randint(k1, (), 1, torch.clamp(n, min=2))
    scores = torch.where(cur.valid, prng.uniform(k2, (E,)), torch.inf)
    replaced = (_rank(scores) < r[:, None]) & cur.valid & ~append_case
    proto_idx = torch.clamp(torch.cumsum(replaced.long(), -1) - 1, 0, E - 1)
    mixed = where(replaced, proto.map(lambda a: _gather_slots(a, proto_idx)),
                  cur)._replace(valid=cur.valid)
    at_free = _slot(cur)[None, :] == first_free[:, None]
    proto0 = proto.map(lambda a: a[:, :1].expand_as(a))
    out = where(append_case & at_free, proto0, mixed)
    return out._replace(valid=torch.where(append_case, cur.valid | at_free,
                                          cur.valid))


def step_direct_overlay(prev, cur, p, keys, i, use_grid, W, H, grid_size=3):
    """直接叠加: fresh prototype, except every 3rd frame merges the last two."""
    if i % 3 == 2:
        return concat_states(cur, prev, cur.num_slots), p
    return sample_prototype(keys, W, H, cur.num_slots, n=None,
                            use_grid=use_grid, grid_size=grid_size), p


def step_diff_keep_same(prev, cur, p, keys, i, use_grid, W, H, grid_size=3):
    """去同存异: symmetric difference of the last two frames on merge steps."""
    if i % 3 != 2:
        return _replace_some(cur, keys, use_grid, W, H, grid_size), p
    same = _pairwise_same(cur, prev)
    cur_keep = cur.valid & ~same.any(2)
    prev_keep = prev.valid & ~same.any(1)
    E = cur.num_slots
    return concat_states(pack_state(cur, cur_keep, E),
                         pack_state(prev, prev_keep, E), E), p


def step_diff_keep_intersection(prev, cur, p, keys, i, use_grid, W, H,
                                grid_size=3):
    """去异存同: keep last-frame elements matched in prev; keep the largest if
    the intersection is empty."""
    if i % 3 != 2:
        return _replace_some(cur, keys, use_grid, W, H, grid_size), p
    same = _pairwise_same(cur, prev)
    keep = cur.valid & same.any(2)
    area = torch.where(cur.valid, cur.bbox[..., 2] * cur.bbox[..., 3],
                       torch.full_like(cur.size, -1.0))
    biggest = area.argmax(-1)
    keep = torch.where(keep.any(-1, keepdim=True), keep,
                       cur.valid & (_slot(cur)[None, :] == biggest[:, None]))
    return pack_state(cur, keep, cur.num_slots), p


# ===========================================================================
# 单一遍历 rule_traverse_sequence
# ===========================================================================

class TraverseSeqParams(NamedTuple):
    seq: torch.Tensor      # [B, MAXSEQ] kind ids
    seq_len: torch.Tensor  # [B]


def init_traverse_sequence(keys, init_state, use_grid, W, H, grid_size=3,
                           seq_len: int = 3):
    seq = _t("traverse_kinds", keys)[prng.randint(keys, (MAXSEQ,), 0, 5)]
    seq = torch.cat([init_state.kind[:, :2], seq[:, 2:]], 1)
    return TraverseSeqParams(seq, torch.full_like(seq[:, 0], seq_len))


def step_traverse_sequence(prev, cur, p: TraverseSeqParams, keys, i, use_grid,
                           W, H, grid_size=3):
    k0 = _take(p.seq, torch.remainder(i, p.seq_len))
    k1 = _take(p.seq, torch.remainder(i + 1, p.seq_len))
    kind = torch.cat([k0[:, None], k1[:, None], cur.kind[:, 2:]], 1)
    return cur._replace(kind=kind), p


# ===========================================================================
# 位置遍历 rule_traverse_positions
# ===========================================================================

class TraversePosParams(NamedTuple):
    pos: torch.Tensor       # f32 [B, MAXSEQ, 2]
    pos_len: torch.Tensor   # [B]
    size_hint: torch.Tensor  # f32 [B]


def init_traverse_positions(keys, init_state, use_grid, W, H, grid_size=3,
                            seq_len: int = 3, size_hint: float = 80.0):
    lo = size_hint / 2
    maxval = constant(("rules", "pos_max", W, H, lo), keys.device,
                      lambda: np.asarray([W - lo, H - lo], np.float32))
    rand = prng.uniform(keys, (MAXSEQ, 2), minval=lo, maxval=maxval)
    first = torch.stack([init_state.cx[:, :2], init_state.cy[:, :2]], -1)
    pos = torch.cat([first, rand[:, 2:]], 1)
    B = keys.shape[0]
    return TraversePosParams(
        pos, torch.full((B,), seq_len, dtype=torch.int64, device=keys.device),
        torch.full((B,), size_hint, dtype=torch.float32, device=keys.device))


def step_traverse_positions(prev, cur, p: TraversePosParams, keys, i, use_grid,
                            W, H, grid_size=3):
    p1 = _take(p.pos, torch.remainder(i, p.pos_len))
    p2 = _take(p.pos, torch.remainder(i + 1, p.pos_len))
    s = p.size_hint
    st = cur
    for e, pe in ((0, p1), (1, p2)):
        idx = torch.full_like(p.pos_len, e)
        st = _set_elem(st, idx, cx=pe[:, 0], cy=pe[:, 1],
                       bbox=torch.stack([pe[:, 0] - s / 2, pe[:, 1] - s / 2,
                                         pe[:, 0] + s / 2, pe[:, 1] + s / 2],
                                        -1))
    return st, p


# ===========================================================================
# 元素传递 rule_element_transfer (registered, not in the default taxonomy)
# ===========================================================================

def init_element_transfer(keys, init_state, use_grid, W, H, grid_size=3):
    return OverlayParams(torch.zeros(keys.shape[0], device=keys.device))


def step_element_transfer(prev, cur, p, keys, i, use_grid, W, H, grid_size=3):
    area = torch.where(prev.valid, prev.size, torch.full_like(prev.size, -1.0))
    big = area.argmax(-1)
    first_free = cur.valid.long().argmin(-1)
    has_room = ~cur.valid.all(-1)
    at_free = _slot(cur)[None, :] == first_free[:, None]
    sel = at_free & has_room[:, None]
    src = prev.map(lambda a: _take(a, big).unsqueeze(1).expand_as(a))
    out = where(sel, src, cur)
    room = has_room[:, None]
    return out._replace(
        cx=torch.where(at_free, torch.where(room, W / 2.0, out.cx), out.cx),
        cy=torch.where(at_free, torch.where(room, H / 2.0, out.cy), out.cy),
        valid=cur.valid | sel), p


RULES = {
    "平移": (init_translate, step_translate),
    "旋转": (init_rotate, step_rotate),
    "翻转(镜像)": (init_flip, step_flip),
    "组合": (init_transform_many, step_transform_many),
    "直接叠加": (init_overlay, step_direct_overlay),
    "去同存异": (init_overlay, step_diff_keep_same),
    "去异存同": (init_overlay, step_diff_keep_intersection),
    "单一遍历": (init_traverse_sequence, step_traverse_sequence),
    "位置遍历": (init_traverse_positions, step_traverse_positions),
    "多遍历": (init_translate, step_translate),
    "元素传递": (init_element_transfer, step_element_transfer),
}
