# check.py — render-time validity QC (in-bounds check + pair features).
# The JAX package's models/multigraph/check.py, on the port's transform.
"""Scene-level quality control.

Rebuilds the reference's two analysis passes without a renderer round-trip:

1. ``check_scene_inside`` — the in-bounds detector
   (multigraph_generation/check.py:82-139).  The reference forces an Agg
   draw and tests display-space bboxes; here the scene IS geometry, so the
   check is a direct data-space bbox test with a linewidth margin,
   returning the same report shape
   {all_inside, out_of_bounds[], checked_count}.

2. ``compute_scene_features`` — the pairwise tangency / crossing / overlap
   feature extractor (multigraph_generation/multi_combinator.py:114-533),
   reformulated on polygon arrays: touch points from boundary-distance
   minima, crossing counts from segment intersections, overlap flags from
   area coverage.  (The reference's version crashes on a `math.lg10` typo
   at :127 whenever invoked; this one works — divergence documented.)
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from .renderer import data_to_pixel_transform
from .scene import (MAX_SHAPES, BOUNDS, poly_area, overlap_area,
                    poly_min_distance)


def check_scene_inside(scene: Dict, bounds=BOUNDS, tol: float = 1e-6,
                       dpi: int = 200) -> Dict:
    """In-bounds report for every artist in a scene."""
    lo, hi = bounds
    out_of_bounds: List[Dict] = []
    checked = 0

    def check(name, pts, lw_pt):
        nonlocal checked
        checked += 1
        # linewidth extends half a stroke beyond the geometry; convert
        # points -> data units via the calibrated transform
        scale, _, _, _ = data_to_pixel_transform(dpi)
        margin = (lw_pt * dpi / 72.0) * 0.5 / scale
        bb = (pts[:, 0].min() - margin, pts[:, 1].min() - margin,
              pts[:, 0].max() + margin, pts[:, 1].max() + margin)
        if (bb[0] < lo - tol or bb[1] < lo - tol or
                bb[2] > hi + tol or bb[3] > hi + tol):
            out_of_bounds.append({
                "artist": name, "reason": "bbox outside axes",
                "bbox_data": [float(v) for v in bb],
            })

    for i in range(MAX_SHAPES):
        if scene["shape_valid"][i]:
            check(f"shape_{i}", scene["shape_verts"][i],
                  float(scene["shape_lw"][i]))
    for k in range(len(scene["line_valid"])):
        if scene["line_valid"][k]:
            p = scene["line_pts"][k].reshape(2, 2)
            check(f"line_{k}", p, float(scene["line_lw"][k]))

    return {"all_inside": not out_of_bounds,
            "out_of_bounds": out_of_bounds,
            "checked_count": checked}


def _segment_intersections(a: np.ndarray, b: np.ndarray):
    """All proper intersection points between two polygons' boundaries."""
    a2 = np.roll(a, -1, 0)
    b2 = np.roll(b, -1, 0)
    pts = []
    for i in range(len(a)):
        p, r = a[i], a2[i] - a[i]
        q = b
        s = b2 - b
        denom = r[0] * s[:, 1] - r[1] * s[:, 0]
        ok = np.abs(denom) > 1e-12
        dq = q - p
        t = np.where(ok, (dq[:, 0] * s[:, 1] - dq[:, 1] * s[:, 0]) /
                     np.where(ok, denom, 1.0), -1)
        u = np.where(ok, (dq[:, 0] * r[1] - dq[:, 1] * r[0]) /
                     np.where(ok, denom, 1.0), -1)
        hit = ok & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
        for j in np.nonzero(hit)[0]:
            pts.append(p + t[j] * r)
    return pts


def compute_scene_features(scene: Dict, touch_tol: float = 0.02) -> Dict:
    """Pairwise geometric features of the placed shapes."""
    shapes = [scene["shape_verts"][i] for i in range(MAX_SHAPES)
              if scene["shape_valid"][i]]
    n = len(shapes)
    features = {
        "num_geometries": n,
        "pairs": [],
        "tangency_points": [],
        "crossing_points": [],
        "partial_overlap_pairs": [],
    }
    for i in range(n):
        for j in range(i + 1, n):
            a, b = shapes[i], shapes[j]
            inter = _segment_intersections(a, b)
            dist = poly_min_distance(a, b)
            ov = overlap_area(a, b)
            min_area = min(poly_area(a), poly_area(b))
            rec = {"i": i, "j": j, "min_distance": float(dist),
                   "n_boundary_intersections": len(inter),
                   "overlap_area": float(ov)}
            if ov > 1e-3 * min_area and len(inter) >= 2:
                rec["relation"] = "crossing"
                features["crossing_points"].extend(
                    [[float(p[0]), float(p[1])] for p in inter])
                features["partial_overlap_pairs"].append([i, j])
            elif dist <= touch_tol and ov <= 1e-3 * min_area:
                rec["relation"] = "tangent"
                # touch point ~ midpoint of closest boundary samples
                d = a[:, None, :] - b[None, :, :]
                k = np.unravel_index(
                    np.argmin((d ** 2).sum(-1)), (len(a), len(b)))
                tp = (a[k[0]] + b[k[1]]) / 2.0
                features["tangency_points"].append(
                    [float(tp[0]), float(tp[1])])
            elif ov > 1e-3 * min_area:
                rec["relation"] = "contains_or_nested"
            else:
                rec["relation"] = "disjoint"
            features["pairs"].append(rec)

    # --- reference compute_geos_features vocabulary ---------------------
    # (reference multi_combinator.py:114-533.  That function is DEAD code
    # upstream: `math.lg10` does not exist, so it raises AttributeError on
    # every call.  We emit its intended result keys with working values.)
    intersection_points = [pt for pts in
                           (features["tangency_points"],
                            features["crossing_points"]) for pt in pts]
    per_geo_info, parallel_pairs = _per_geo_info(shapes)
    features.update({
        "tangency_points_count": len(features["tangency_points"]),
        "crossing_points_count": len(features["crossing_points"]),
        "intersection_points": intersection_points,
        "intersection_points_count": len(intersection_points),
        "partial_overlaps_pairs": list(features["partial_overlap_pairs"]),
        "partial_overlaps_count": len(features["partial_overlap_pairs"]),
        "parallel_edge_pairs_count": parallel_pairs,
        "per_geo_info": per_geo_info,
    })
    return features


def _per_geo_info(shapes: List[np.ndarray],
                  angle_tol: float = math.radians(2.0)):
    """Per-geometry segment stats + global parallel-pair count
    (reference multi_combinator.py:458-519 semantics: straight chains split
    where consecutive edge angles differ by > angle_tol mod pi; parallel
    pairs counted within angle buckets of width angle_tol)."""
    infos = []
    all_angles = []
    for idx, poly in enumerate(shapes):
        a = np.asarray(poly, np.float64)
        e = np.roll(a, -1, 0) - a
        keep = (np.abs(e) > 1e-12).any(1)
        ang = (np.arctan2(e[keep][:, 1], e[keep][:, 0])) % math.pi
        angles = ang.tolist()
        straight = junctions = 0
        if angles:
            for k in range(1, len(angles)):
                da = abs(angles[k] - angles[k - 1])
                da = min(da, math.pi - da)
                if da > angle_tol:
                    straight += 1
                    junctions += 1
            straight += 1
        infos.append({"idx": idx, "n_segments": int(keep.sum()),
                      "straight_chains": straight,
                      "curved_junctions": junctions,
                      "n_angles": len(angles)})
        all_angles.extend(angles)
    buckets: Dict[int, int] = {}
    for angv in all_angles:
        k = int(round(angv / angle_tol))
        buckets[k] = buckets.get(k, 0) + 1
    parallel_pairs = sum(m * (m - 1) // 2 for m in buckets.values() if m >= 2)
    return infos, parallel_pairs


def pretty_print_features(features: Dict) -> str:
    lines = [f"geometries: {features['num_geometries']}"]
    for p in features["pairs"]:
        lines.append(
            f"  ({p['i']},{p['j']}): {p['relation']}, "
            f"dist={p['min_distance']:.4f}, "
            f"x-ings={p['n_boundary_intersections']}, "
            f"overlap={p['overlap_area']:.4f}")
    lines.append(f"tangency points: {len(features['tangency_points'])}")
    lines.append(f"crossing points: {len(features['crossing_points'])}")
    return "\n".join(lines)
