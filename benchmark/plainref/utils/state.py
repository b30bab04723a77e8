# state.py — struct-of-arrays element state as a NamedTuple of tensors.
"""ElementState: the masked struct-of-arrays frame of the JAX package
(reasoning_image_generation_tpu/utils/state.py), with torch tensors.

Every field has a trailing element axis of fixed size E (``valid`` masks
the live slots) and free leading axes (batch, sequence, option).  Integer
fields are int64, booleans bool, the rest float32.  ``from_numpy`` and
``to_numpy`` carry a state across to and from the JAX package field by
field.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import KIND_ID, SHAPE_KINDS


class ElementState(NamedTuple):
    kind: torch.Tensor      # i64 [..., E]   index into config.SHAPE_KINDS
    size: torch.Tensor      # f32 [..., E]   full side/diameter in pixels
    fill: torch.Tensor      # bool [..., E]
    stroke: torch.Tensor    # f32 [..., E]   outline stroke width
    cx: torch.Tensor        # f32 [..., E]
    cy: torch.Tensor        # f32 [..., E]
    angle: torch.Tensor     # f32 [..., E]   degrees, clockwise-positive
    flip_h: torch.Tensor    # bool [..., E]
    flip_v: torch.Tensor    # bool [..., E]
    color: torch.Tensor     # f32 [..., E, 3] RGB 0-255
    bbox: torch.Tensor      # f32 [..., E, 4] (x, y, w, h)
    valid: torch.Tensor     # bool [..., E]

    @property
    def num_slots(self) -> int:
        return self.kind.shape[-1]

    def count(self) -> torch.Tensor:
        """Number of live elements (i64 [...])."""
        return self.valid.sum(-1)

    def map(self, fn) -> "ElementState":
        return ElementState(*(fn(a) for a in self))


def tree_map(fn, *states: ElementState) -> ElementState:
    """Apply `fn` field by field across states of the same layout."""
    return ElementState(*(fn(*xs) for xs in zip(*states)))


def stack(states, dim: int = 0) -> ElementState:
    return tree_map(lambda *xs: torch.stack(xs, dim), *states)


def cat(states, dim: int = 0) -> ElementState:
    return tree_map(lambda *xs: torch.cat(xs, dim), *states)


def where(cond: torch.Tensor, a: ElementState, b: ElementState) -> ElementState:
    """Field-wise select; `cond` has the leading dims (or the slot dims)
    of the fields and broadcasts over their trailing axes."""
    def sel(x, y):
        c = cond.reshape(cond.shape + (1,) * (x.ndim - cond.ndim))
        return torch.where(c, x, y)
    return tree_map(sel, a, b)


def empty_state(max_elems: int, leading=(), device=None) -> ElementState:
    """All-invalid state with the given leading dims."""
    shp = tuple(leading) + (max_elems,)

    def f32(extra=()):
        return torch.zeros(shp + extra, dtype=torch.float32, device=device)

    def b():
        return torch.zeros(shp, dtype=torch.bool, device=device)
    return ElementState(
        kind=torch.zeros(shp, dtype=torch.int64, device=device),
        size=f32(), fill=b(),
        stroke=torch.ones(shp, dtype=torch.float32, device=device),
        cx=f32(), cy=f32(), angle=f32(), flip_h=b(), flip_v=b(),
        color=f32((3,)), bbox=f32((4,)), valid=b())


def recompute_bbox_from_center(state: ElementState, W: int, H: int) -> ElementState:
    """bbox = size-square centred at (cx, cy), clipped to the canvas."""
    half = torch.floor_divide(state.size, 2)
    bx = state.cx - half
    by = state.cy - half
    shift_x = torch.clamp(-bx, min=0.0)
    shift_y = torch.clamp(-by, min=0.0)
    bx = torch.clamp(bx, min=0.0)
    by = torch.clamp(by, min=0.0)
    bw = torch.clamp(state.size - shift_x, min=1.0)
    bh = torch.clamp(state.size - shift_y, min=1.0)
    bw = torch.where(bx + bw > W, torch.clamp(W - bx, min=1.0), bw)
    bh = torch.where(by + bh > H, torch.clamp(H - by, min=1.0), bh)
    return state._replace(bbox=torch.stack([bx, by, bw, bh], dim=-1))


def from_numpy(state_np, device=None) -> ElementState:
    """A state whose fields are array-likes (e.g. a JAX ElementState passed
    through ``np.asarray``) -> torch ElementState on `device`."""
    out = {}
    for f in ElementState._fields:
        a = np.asarray(getattr(state_np, f))
        if f == "kind":
            t = torch.from_numpy(a.astype(np.int64))
        elif a.dtype == np.bool_:
            t = torch.from_numpy(a.copy())
        else:
            t = torch.from_numpy(a.astype(np.float32))
        out[f] = t.to(device)
    return ElementState(**out)


def to_numpy(state: ElementState) -> ElementState:
    """torch ElementState -> the same NamedTuple holding numpy arrays with
    the JAX package's dtypes (i32 kind, f32, bool)."""
    arrs = [a.detach().cpu().numpy() for a in state]
    arrs[0] = arrs[0].astype(np.int32)  # kind
    return ElementState(*arrs)


def state_to_dicts(state: ElementState, kinds=None) -> list:
    """One unbatched frame -> the reference element-dict list (the schema of
    the JAX package's state_to_dicts, which this mirrors line for line)."""
    kinds = kinds or SHAPE_KINDS
    arr = {f: np.asarray(getattr(state, f).cpu() if torch.is_tensor(
        getattr(state, f)) else getattr(state, f)) for f in state._fields}
    idx = np.nonzero(arr["valid"])[0]
    if idx.size == 0:
        return []

    def ri(a):
        return np.rint(a[idx].astype(np.float64)).astype(np.int64).tolist()

    kind = arr["kind"][idx].tolist()
    size, stroke = ri(arr["size"]), ri(arr["stroke"])
    cx, cy = ri(arr["cx"]), ri(arr["cy"])
    angle = arr["angle"][idx].astype(np.float64).tolist()
    bbox = ri(arr["bbox"])
    fill = arr["fill"][idx].tolist()
    fh = arr["flip_h"][idx].tolist()
    fv = arr["flip_v"][idx].tolist()
    color = ri(arr["color"])
    return [{
        "kind": kinds[k],
        "size": s,
        "fill": f,
        "stroke_width": sw,
        "center": (x, y),
        "angle": a,
        "bbox": tuple(bb),
        "flip": {"h": h, "v": v},
        "color": tuple(c),
    } for k, s, f, sw, x, y, a, bb, h, v, c in zip(
        kind, size, fill, stroke, cx, cy, angle, bbox, fh, fv, color)]


def dicts_to_state(elements: list, max_elems: int, device=None) -> ElementState:
    """Inverse of state_to_dicts (for tests / interop)."""
    st = to_numpy(empty_state(max_elems))
    arrs = {f: getattr(st, f).copy() for f in st._fields}
    for i, el in enumerate(elements[:max_elems]):
        arrs["kind"][i] = KIND_ID[el["kind"]]
        arrs["size"][i] = el["size"]
        arrs["fill"][i] = bool(el.get("fill", True))
        arrs["stroke"][i] = el.get("stroke_width", 1)
        arrs["cx"][i], arrs["cy"][i] = el["center"]
        arrs["angle"][i] = el.get("angle", 0.0) or 0.0
        flip = el.get("flip", {}) or {}
        arrs["flip_h"][i] = bool(flip.get("h", False))
        arrs["flip_v"][i] = bool(flip.get("v", False))
        color = el.get("color") or (0, 0, 0)
        arrs["color"][i] = np.asarray(color, np.float32)
        arrs["bbox"][i] = el.get("bbox", (0, 0, el["size"], el["size"]))
        arrs["valid"][i] = True
    return from_numpy(ElementState(**arrs), device)
