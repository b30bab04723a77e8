# metadata.py — the meta.json, coco.json and index.json records.
"""Schema-compatible metadata export (the JAX package's metadata.py on
numpy per-sample trees; it writes the same meta, coco and index JSON).

Reproduces the structures written by the reference's `_generate_metadata`
(reference src/generator.py:552-632) and `compose_grid`'s cells_meta
(reference src/layout.py:138-191): same keys, same nesting, same file names.
rule_info dictionaries are rebuilt host-side from the pipeline's rule-param
arrays with the reference handlers' key vocabulary.
"""
from __future__ import annotations

import os
from datetime import datetime, timezone
from typing import Dict, List

import numpy as np

from ...utils.config import SHAPE_KINDS
from ...utils.state import ElementState, state_to_dicts
from .rules import (TranslateParams, RotateParams, FlipParams,
                    TransformManyParams, TraverseSeqParams, TraversePosParams,
                    ANGLE_TAB, ANGLE_CNT)

HANDLER_NAMES = {
    "平移": "rule_translate",
    "旋转": "rule_rotate",
    "翻转(镜像)": "rule_flip",
    "组合": "rule_transform_many",
    "直接叠加": "rule_direct_overlay",
    "去同存异": "rule_diff_keep_same",
    "去异存同": "rule_diff_keep_intersection",
    "单一遍历": "rule_traverse_sequence",
    "位置遍历": "rule_traverse_positions",
}

_FLIP_MODES = ["horizontal", "vertical", "both"]
_TM_OPS = ["translate", "rotate", "flip"]


def _np(x):
    return np.asarray(x)


def serialize_rule_info(leaf: str, params, step_idx: int, use_grid: bool,
                        grid_size: int, states: ElementState) -> Dict:
    """Per-step rule_info dict in the reference handlers' vocabulary."""
    if leaf in ("平移", "多遍历"):
        p: TranslateParams = params
        return {
            "idx": int(_np(p.idx)), "is_horizontal": bool(_np(p.is_horizontal)),
            "dist": int(_np(p.dist)), "use_grid": bool(use_grid),
            "grid_size": int(grid_size) if use_grid else None,
        }
    if leaf == "旋转":
        p: RotateParams = params
        idx = int(_np(p.idx))
        kind = int(_np(states.kind)[step_idx, idx])
        cnt = int(_np(ANGLE_CNT)[kind])
        allowed = [int(a) for a in _np(ANGLE_TAB)[kind][:cnt]]
        return {
            "idx": idx, "requested_angle": float(_np(p.delta)),
            "applied_angle": float(_np(states.angle)[step_idx, idx]) % 360.0,
            "allowed_set": allowed,
        }
    if leaf == "翻转(镜像)":
        p: FlipParams = params
        return {"idx": int(_np(p.idx)),
                "flip_mode": _FLIP_MODES[int(_np(p.mode))]}
    if leaf == "组合":
        p: TransformManyParams = params
        active = _np(p.active)
        op = _np(p.op)
        elem_op_map = {}
        for e in range(len(active)):
            if not active[e]:
                continue
            o = _TM_OPS[int(op[e])]
            if o == "translate":
                if use_grid:
                    param = {"dist": int(_np(p.grid_dist)),
                             "dir": "horizontal" if bool(_np(p.grid_is_h)) else "vertical",
                             "mode": "relative", "use_grid": True,
                             "grid_size": int(grid_size)}
                else:
                    param = {"dx": float(_np(p.dx)), "dy": float(_np(p.dy)),
                             "mode": "relative", "use_grid": False}
            elif o == "rotate":
                param = {"angle": float(_np(p.rot_delta))}
            else:
                param = {"mode": _FLIP_MODES[int(_np(p.flip_mode))]}
            elem_op_map[str(e)] = {"op_type": o, "op_param": param}
        def _param_of(op_name):
            return next((v["op_param"] for v in elem_op_map.values()
                         if v["op_type"] == op_name), None)

        return {"transform_many": {
            "target_indices": [int(e) for e in np.nonzero(active)[0]],
            "elem_op_map": elem_op_map,
            "translate_param": _param_of("translate"),
            "rotate_param": _param_of("rotate"),
            "flip_param": _param_of("flip"),
            "valid_ops": [v["op_type"] for v in elem_op_map.values()],
        }}
    if leaf in ("直接叠加", "去同存异", "去异存同"):
        is_merge = (step_idx % 3) == 2
        if leaf == "直接叠加":
            op = "merge_last_two" if is_merge else "added_element_from_proto"
        elif leaf == "去同存异":
            op = "diff_keep" if is_merge else "replace_some_in_last_frame"
        else:
            op = "diff_keep_intersection" if is_merge else "replace_some_in_last_frame"
        info = {"op": op, "seed": None, "frame_count": int(step_idx)}
        if is_merge and leaf in ("去同存异", "去异存同"):
            # reconstruct the kept/removed index bookkeeping the reference
            # records (src/rules.py:1435-1439, 1632-1636) from the two input
            # frames, using the identical same-element test
            kept, removed = _diff_indices(states, step_idx)
            info["kept_idx_in_last"] = kept
            info["removed_idx_in_last"] = removed
            info["num_kept"] = len(kept)
            info["num_removed"] = len(removed)
        elif not is_merge and leaf in ("去同存异", "去异存同"):
            # replace-branch bookkeeping (src/rules.py:1319-1328, 1559-1567),
            # reconstructed by diffing the two frames slot-wise (our replace
            # is in-place per slot).  A newly-valid slot is the n<=1
            # append case -> added_idx.
            replaced, added = _replaced_indices(states, step_idx)
            if added is not None:
                info["added_idx"] = added
            else:
                info["num_replaced"] = len(replaced)
                info["replaced_idx"] = replaced
        return info
    if leaf == "单一遍历":
        p: TraverseSeqParams = params
        n = int(_np(p.seq_len))
        t = int(step_idx)
        seq = [SHAPE_KINDS[int(k)] for k in _np(p.seq)[:n]]
        # the reference stores the NEXT raw index after applying step t
        # (src/rules.py:878-881) and flips done when the pre-advance index
        # reaches the sequence length (src/rules.py:864-867)
        info = {"sequence": seq, "step_idx": t + 1, "done": t >= n}
        if t == n:
            info["note"] = "sequence_finished_after_this_step"
        elif t > n:
            info["note"] = "sequence_already_done"
        # last_modified accumulates 2 entries per applied step
        # (reference src/rules.py:871-877)
        kinds = _np(states.kind)
        cx, cy = _np(states.cx), _np(states.cy)
        bbox = _np(states.bbox)
        info["last_modified"] = [{
            "element_index": e,
            "from_kind": SHAPE_KINDS[int(kinds[s - 1, e])],
            "to_kind": SHAPE_KINDS[int(kinds[s, e])],
            "center": [float(cx[s, e]), float(cy[s, e])],
            "bbox": [float(v) for v in bbox[s, e]],
        } for s in range(1, t + 1) for e in range(2)]
        return info
    if leaf == "位置遍历":
        p: TraversePosParams = params
        n = int(_np(p.pos_len))
        t = int(step_idx)
        pos = [[float(a), float(b)] for a, b in _np(p.pos)[:n]]
        cx, cy = _np(states.cx), _np(states.cy)
        info = {"positions_sequence": pos, "step_idx": t + 1,
                "done": (t - 1) >= n,
                # one accumulated entry per applied step
                # (reference src/rules.py:1000-1008)
                "last_modified": [{
                    "step_idx": s,
                    "original_center": [[float(cx[s - 1, e]),
                                         float(cy[s - 1, e])]
                                        for e in range(2)],
                    "new_centers": [[float(cx[s, e]), float(cy[s, e])]
                                    for e in range(2)],
                    "elements_count": 2,
                } for s in range(1, t + 1)]}
        if (t + 1 - 2) >= n:  # reference src/rules.py:1013-1015
            info["note"] = "positions_sequence_will_finish_next_step"
        return info
    return {"handler": HANDLER_NAMES.get(leaf, leaf)}


def _replaced_indices(states: ElementState, step_idx: int):
    """Slot-diff frames step_idx-1 -> step_idx: (replaced_indices, added_idx).
    A slot valid in both frames whose properties changed was replaced; a slot
    newly valid is the reference's n<=1 forced-append (src/rules.py:1309-1321)."""
    valid = _np(states.valid)
    last, prev = step_idx, step_idx - 1
    added = None
    replaced = []
    kind, size = _np(states.kind), _np(states.size)
    cx, cy = _np(states.cx), _np(states.cy)
    color = _np(states.color)
    for i in range(valid.shape[1]):
        if valid[last, i] and not valid[prev, i]:
            added = i
            continue
        if not (valid[last, i] and valid[prev, i]):
            continue
        changed = (kind[last, i] != kind[prev, i]
                   or size[last, i] != size[prev, i]
                   or cx[last, i] != cx[prev, i]
                   or cy[last, i] != cy[prev, i]
                   or (color[last, i] != color[prev, i]).any())
        if changed:
            replaced.append(i)
    return replaced, added


def _diff_indices(states: ElementState, step_idx: int,
                  iou_thresh=0.5, size_rel=0.2, angle_deg=5.0):
    """Same-element matching of frames step_idx-1 vs step_idx-2 with the
    reference's kind ∧ IoU ∧ size ∧ angle test (src/rules.py:1364-1433)."""
    valid = _np(states.valid)
    kind = _np(states.kind)
    size = _np(states.size)
    angle = _np(states.angle)
    bbox = _np(states.bbox)
    last, prev = step_idx - 1, step_idx - 2
    kept, removed = [], []
    for i in range(valid.shape[1]):
        if not valid[last, i]:
            continue
        same = False
        for j in range(valid.shape[1]):
            if not valid[prev, j] or kind[last, i] != kind[prev, j]:
                continue
            b1, b2 = bbox[last, i], bbox[prev, j]
            x1 = max(b1[0], b2[0])
            y1 = max(b1[1], b2[1])
            x2 = min(b1[0] + b1[2], b2[0] + b2[2])
            y2 = min(b1[1] + b1[3], b2[1] + b2[3])
            inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
            union = b1[2] * b1[3] + b2[2] * b2[3] - inter
            iou = inter / union if union > 0 else 0.0
            smax = max(size[last, i], size[prev, j])
            srel = abs(size[last, i] - size[prev, j]) / smax if smax > 0 else 0.0
            adiff = abs(((angle[last, i] - angle[prev, j] + 180) % 360) - 180)
            if iou >= iou_thresh and srel <= size_rel and adiff <= angle_deg:
                same = True
                break
        (kept if same else removed).append(i)
    return kept, removed


def build_sample_meta(sample_id: int, leaf: str, category_path: List[str],
                      out_dir: str, sample_dir: str, grid_path: str,
                      states: ElementState, options: ElementState,
                      perm: np.ndarray, correct_index: int,
                      params, use_grid: bool, grid_size: int,
                      canvas_size, layout, cfg_seed, sample_seed,
                      grid_only: bool = False) -> Dict:
    """Full meta.json dict for one sample (reference src/generator.py:574-590).

    With `grid_only`, per-frame image paths are None — those PNGs are
    never written (the grid is the only exported image), so consumers
    walking the index must not be handed dangling paths."""
    L = _np(states.valid).shape[0]
    O = _np(options.valid).shape[0]
    now = datetime.now(timezone.utc).isoformat()

    def fpath(name):
        return None if grid_only else os.path.join(sample_dir, name)

    def frame(tree, t):
        return tree.map(lambda a: a[t])

    sequence_meta = []
    for t in range(L):
        rule_info = None if t == 0 else serialize_rule_info(
            leaf, params, t, use_grid, grid_size, states)
        sequence_meta.append({
            "state_path": fpath(f"state_{t}.png"),
            "elements": state_to_dicts(frame(states, t)),
            "canvas_size": list(canvas_size),
            "rule_info": rule_info,
            "timestamp": now,
        })

    options_meta = []
    for pos in range(O):
        src = int(perm[pos])
        path = fpath("proto_true_next.png" if src == 0
                     else f"option_{src}.png")
        options_meta.append({
            "option_path": path,
            "is_correct": src == 0,
            "elements": state_to_dicts(frame(options, pos)),
            "rule_info": (sequence_meta[-1]["rule_info"] if src == 0 else
                          {"distractor": True,
                           "handler": HANDLER_NAMES.get(leaf, leaf)}),
        })

    # cells_meta: static layout geometry + per-sample paths
    cells_meta = []
    for cell in layout.cells_meta:
        c = dict(cell)
        if c["r"] == 0:
            i = c["c"]
            if c.get("is_query"):
                c.update({"proto_path": None, "state_path": None,
                          "query_path": fpath("query.png")})
            else:
                c.update({"proto_path": None,
                          "state_path": sequence_meta[i]["state_path"],
                          "is_query": False, "query_path": None})
        else:
            i = c["c"]
            c.update({"path": options_meta[i]["option_path"],
                      "is_correct": options_meta[i]["is_correct"]})
        cells_meta.append(c)

    return {
        "id": int(sample_id),
        "category_path": list(category_path),
        "sample_dir": sample_dir,
        "grid_path": grid_path,
        "sequence": sequence_meta,
        "options": options_meta,
        "correct_index": int(correct_index),
        "rule": leaf,
        "cells_meta": cells_meta,
        "seed_info": {"cfg_seed": cfg_seed, "sample_seed": sample_seed},
        "generation_time": now,
    }


def build_coco(sample_id: int, leaf: str, grid_path: str, out_dir: str,
               grid_h: int, cells_meta: List[Dict]) -> Dict:
    """coco.json (reference src/generator.py:600-620 — note the reference
    stores grid_h for BOTH width and height; replicated)."""
    coco = {
        "images": [{
            "id": int(sample_id),
            "file_name": os.path.relpath(grid_path, out_dir),
            "width": int(grid_h),
            "height": int(grid_h),
        }],
        "annotations": [],
        "categories": [{"id": 1, "name": leaf}],
    }
    ann_id = 1
    for cell in cells_meta:
        coco["annotations"].append({
            "id": ann_id, "image_id": int(sample_id), "category_id": 1,
            "bbox": cell["bbox"], "label": cell.get("label", ""),
        })
        ann_id += 1
    return coco
