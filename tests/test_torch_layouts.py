# test_torch_layouts.py — the baked grid layouts against the JAX package's.
"""ops/layout_assets.npz holds the overlay, alpha and query patch that the
JAX package's build_layout draws with OpenCV; the port reads them from
there.  Each baked layout must equal a fresh draw (which needs OpenCV),
and the port's layout geometry must equal the JAX package's.  Exact.

This file also bakes the assets.  After adding a canvas to CANVASES, run
from the repository root, where OpenCV and the JAX package import:

    python -m tests.test_torch_layouts --bake
"""
import itertools
import sys

import numpy as np
import pytest

from reasoning_image_generation_tpu.ops import compose as jax_compose
from reasoning_image_generation_tpu_torch.ops import compose

# (W, H) canvases: the default 512x512 and the 128x128 test canvas; each
# with the 4-frame (3 shown states) and 6-frame (5 shown states) leaves
CANVASES = ((512, 512), (128, 128), (64, 64))
N_STATES = (3, 5)
NUM_OPTIONS = 4
MARGIN = 20
PADDING_V = 20

COMBOS = list(itertools.product(CANVASES, N_STATES, (True, False),
                                (True, False)))
GEOMETRY = ("W", "H", "n_states", "num_options", "margin", "padding_v",
            "cell_size", "grid_h", "seq_offset_x", "opt_offset_x", "top_y",
            "bottom_y", "show_labels", "show_border", "bg_color", "cells_meta")


def _kw(n_states, labels, border):
    return dict(n_states=n_states, num_options=NUM_OPTIONS, margin=MARGIN,
                padding_v=PADDING_V, show_labels=labels, show_border=border)


def bake() -> dict:
    """Every combination's pixels, drawn by the JAX package (OpenCV)."""
    out = {}
    for (W, H), n, labels, border in COMBOS:
        lay = jax_compose.build_layout(W, H, **_kw(n, labels, border))
        key = compose.layout_key(W, H, n, NUM_OPTIONS, MARGIN, PADDING_V,
                                 labels, border)
        out[f"{key}/overlay_rgb"] = lay.overlay_rgb_u8
        out[f"{key}/overlay_a"] = lay.overlay_a8
        out[f"{key}/query_patch"] = lay.query_patch
    return out


def _layouts(canvas, n_states, labels, border):
    W, H = canvas
    kw = _kw(n_states, labels, border)
    return (jax_compose.build_layout(W, H, **kw),
            compose.build_layout(W, H, **kw))


@pytest.mark.parametrize("canvas,n_states,labels,border", COMBOS)
def test_baked_layout_equals_a_fresh_draw(canvas, n_states, labels, border):
    pytest.importorskip("cv2")
    want, got = _layouts(canvas, n_states, labels, border)
    for f in GEOMETRY:
        assert getattr(got, f) == getattr(want, f), f
    for f in ("overlay_rgb_u8", "overlay_a8", "query_patch"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_assets_hold_exactly_the_baked_combinations():
    with np.load(compose.ASSETS) as z:
        keys = set(z.files)
    want = {compose.layout_key(W, H, n, NUM_OPTIONS, MARGIN, PADDING_V,
                               labels, border) + "/" + part
            for (W, H), n, labels, border in COMBOS
            for part in ("overlay_rgb", "overlay_a", "query_patch")}
    assert keys == want


def test_missing_layout_raises_with_its_key():
    with pytest.raises(KeyError, match="256x256_s3_o4"):
        compose.build_layout(256, 256, n_states=3, num_options=4)


if __name__ == "__main__":
    if sys.argv[1:] != ["--bake"]:
        raise SystemExit("usage: python -m tests.test_torch_layouts --bake")
    arrays = bake()
    np.savez_compressed(compose.ASSETS, **arrays)
    print(f"wrote {len(arrays) // 3} layouts to {compose.ASSETS}")
