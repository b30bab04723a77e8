# record.py — the params record of one mg scene (plain reference).
"""Copied from the port's models/multigraph/generator.py: the
ShapeParameters-shaped record of each shape (reference
multigraph_generation/parameter.py:11-30) and the JSON conversion."""
from __future__ import annotations

from typing import Dict

import numpy as np

_PARAM_FIELDS_DEFAULTS = {
    "rotation": 0.0, "edge_color": None, "line_width": None,
    "line_style": None, "fill_color": None, "alpha": None,
    "has_gradient": False, "gradient_colors": None,
    "has_mask": False, "mask_type": None,
    "has_decoration": False, "decoration_style": None,
}


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
