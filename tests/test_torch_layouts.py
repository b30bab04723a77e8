# test_torch_layouts.py — the baked grid layouts against the JAX package's.
"""ops/layout_assets.npz holds the overlay, alpha and query patch that the
JAX package's build_layout draws with OpenCV; the port reads them from
there.  Each baked layout must equal a fresh draw (which needs OpenCV),
and the port's layout geometry must equal the JAX package's.  Exact."""
import itertools

import numpy as np
import pytest

from reasoning_image_generation_tpu.ops import compose as jax_compose
from reasoning_image_generation_tpu_torch.ops import compose
from reasoning_image_generation_tpu_torch.tools import bake_layouts

COMBOS = list(itertools.product(bake_layouts.CANVASES, bake_layouts.N_STATES,
                                (True, False), (True, False)))
GEOMETRY = ("W", "H", "n_states", "num_options", "margin", "padding_v",
            "cell_size", "grid_h", "seq_offset_x", "opt_offset_x", "top_y",
            "bottom_y", "show_labels", "show_border", "bg_color", "cells_meta")


def _layouts(canvas, n_states, labels, border):
    W, H = canvas
    kw = dict(n_states=n_states, num_options=bake_layouts.NUM_OPTIONS,
              margin=bake_layouts.MARGIN, padding_v=bake_layouts.PADDING_V,
              show_labels=labels, show_border=border)
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
    B = bake_layouts
    want = {compose.layout_key(W, H, n, B.NUM_OPTIONS, B.MARGIN, B.PADDING_V,
                               labels, border) + "/" + part
            for (W, H), n, labels, border in COMBOS
            for part in ("overlay_rgb", "overlay_a", "query_patch")}
    assert keys == want


def test_missing_layout_raises_with_its_key():
    with pytest.raises(KeyError, match="256x256_s3_o4"):
        compose.build_layout(256, 256, n_states=3, num_options=4)
