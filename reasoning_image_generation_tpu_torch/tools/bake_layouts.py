# bake_layouts.py — write ops/layout_assets.npz from the JAX package's layouts.
"""Bakes the grid-layout pixels the port reads at run time.

The JAX package's ``build_layout`` draws the cell labels and the '?' query
glyph with OpenCV's Hershey font; the port must run without OpenCV, so
this script renders every supported layout once and stores its u8
overlay, alpha and query patch in ``ops/layout_assets.npz``.

Run from the repository root on a machine with OpenCV (and the JAX
package's dependencies):

    python -m reasoning_image_generation_tpu_torch.tools.bake_layouts
"""
from __future__ import annotations

import itertools

import numpy as np

from ..ops.compose import ASSETS, layout_key

# (W, H) canvases: the default 512x512 and the 128x128 test canvas; each
# with the 4-frame (3 shown states) and 6-frame (5 shown states) leaves
CANVASES = ((512, 512), (128, 128))
N_STATES = (3, 5)
NUM_OPTIONS = 4
MARGIN = 20
PADDING_V = 20


def bake() -> dict:
    from reasoning_image_generation_tpu.ops.compose import build_layout
    out = {}
    for (W, H), n, labels, border in itertools.product(
            CANVASES, N_STATES, (True, False), (True, False)):
        lay = build_layout(W, H, n_states=n, num_options=NUM_OPTIONS,
                           margin=MARGIN, padding_v=PADDING_V,
                           show_labels=labels, show_border=border)
        key = layout_key(W, H, n, NUM_OPTIONS, MARGIN, PADDING_V, labels,
                         border)
        out[f"{key}/overlay_rgb"] = lay.overlay_rgb_u8
        out[f"{key}/overlay_a"] = lay.overlay_a8
        out[f"{key}/query_patch"] = lay.query_patch
    return out


def main():
    arrays = bake()
    np.savez_compressed(ASSETS, **arrays)
    print(f"wrote {len(arrays) // 3} layouts to {ASSETS}")


if __name__ == "__main__":
    main()
