# geometry.py — static unit-vertex tables for the 11 RPM shape kinds.
"""Unit-space vertex tables for the 11 shape kinds, as the JAX package's
``ops/geometry.py`` builds them.

Every kind's outline is a fixed table of unit vertices (coordinates relative
to ``half = size/2``), padded to MAX_VERTS by repeating vertex 0: the
padding adds zero-length edges that change neither the distance field nor
the even-odd crossing parity.

Reference behaviours kept on purpose (reference src/shapes.py):
- ``star`` has the same 5 radial vertices as ``pentagon`` (:428-450);
- ``plus`` is two overlapping rectangles, each with its own fill and
  outline (:477-509), so it has two parts;
- ``heart`` is the 16·sin³t curve sampled at 60 points with scale
  0.8·half/16 (:511-544);
- ``rounded_square`` has 12-point arcs of radius 0.4·half plus one edge
  point per side (:596-656);
- ``circle`` and ``crescent`` are analytic (no polygon): the crescent is the
  outer circle minus an inner circle of radius 0.65·r offset by 0.35·r
  (:546-594).
"""
from __future__ import annotations

import math

import numpy as np

from ..utils.config import KIND_ID, SHAPE_KINDS

NKIND = len(SHAPE_KINDS)
NPART = 2          # plus needs two polygons; all other kinds use part 0 only
MAX_VERTS = 64

CIRCLE = KIND_ID["circle"]
CRESCENT = KIND_ID["crescent"]

CRESCENT_INNER_R = 0.65
CRESCENT_OFFSET = 0.35


def _regular(n: int, start_deg: float = -90.0):
    return [(math.cos(math.radians(i * 360.0 / n + start_deg)),
             math.sin(math.radians(i * 360.0 / n + start_deg)))
            for i in range(n)]


def _heart(num: int = 60, r: float = 0.8):
    pts = []
    for t in np.linspace(0.0, 2.0 * math.pi, num=num):
        x = 16.0 * math.sin(t) ** 3
        y = 13.0 * math.cos(t) - 5.0 * math.cos(2 * t) - 2.0 * math.cos(3 * t) - math.cos(4 * t)
        s = r / 16.0
        pts.append((x * s, -y * s))
    return pts


def _rounded_square(r: float = 0.4, arc_n: int = 12):
    tl = (-1 + r, -1 + r)
    tr = (1 - r, -1 + r)
    br = (1 - r, 1 - r)
    bl = (-1 + r, 1 - r)
    pts = []
    for th in np.linspace(math.pi, 1.5 * math.pi, num=arc_n):
        pts.append((tl[0] + r * math.cos(th), tl[1] + r * math.sin(th)))
    pts.append((tr[0], tr[1] - r))
    for th in np.linspace(1.5 * math.pi, 2.0 * math.pi, num=arc_n):
        pts.append((tr[0] + r * math.cos(th), tr[1] + r * math.sin(th)))
    pts.append((br[0] + r, br[1]))
    for th in np.linspace(0.0, 0.5 * math.pi, num=arc_n):
        pts.append((br[0] + r * math.cos(th), br[1] + r * math.sin(th)))
    pts.append((bl[0], bl[1] + r))
    for th in np.linspace(0.5 * math.pi, math.pi, num=arc_n):
        pts.append((bl[0] + r * math.cos(th), bl[1] + r * math.sin(th)))
    pts.append((tl[0] - r, tl[1]))
    return pts


def _plus_parts():
    # arm = 0.25*size = 0.5*half; length = 0.9*size = 1.8*half
    a, l = 0.25, 0.9  # half-extents in unit coords
    vertical = [(-a, -l), (a, -l), (a, l), (-a, l)]
    horizontal = [(-l, -a), (l, -a), (l, a), (-l, a)]
    return vertical, horizontal


def build_tables():
    """Returns (verts [NKIND, NPART, MAX_VERTS, 2] f32, nv [NKIND, NPART] i32)."""
    verts = np.zeros((NKIND, NPART, MAX_VERTS, 2), np.float32)
    nv = np.zeros((NKIND, NPART), np.int32)

    def put(kind: str, part: int, pts):
        k = KIND_ID[kind]
        p = np.asarray(pts, np.float32)
        verts[k, part, :len(p)] = p
        verts[k, part, len(p):] = p[0]  # pad with vertex 0 (degenerate edges)
        nv[k, part] = len(p)

    put("square", 0, [(-1, -1), (1, -1), (1, 1), (-1, 1)])
    put("triangle", 0, [(-1, 1), (0, -1), (1, 1)])
    put("diamond", 0, [(0, -1), (1, 0), (0, 1), (-1, 0)])
    put("star", 0, _regular(5))      # reference quirk: star == pentagon
    put("pentagon", 0, _regular(5))
    put("hexagon", 0, _regular(6))
    v, h = _plus_parts()
    put("plus", 0, v)
    put("plus", 1, h)
    put("heart", 0, _heart())
    put("rounded_square", 0, _rounded_square())
    # circle / crescent stay all-zero (analytic path); nv 0 means "no polygon"
    return verts, nv


VERTS_UNIT, NV = build_tables()
