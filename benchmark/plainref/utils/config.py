# config.py — the generation config and the rule/shape tables.
"""Generation configuration of the RPM pipeline.

``GenConfig`` keeps the field names and defaults of the JAX package's
``utils/config.py`` (and so of the reference dataclass, reference
src/config.py:23-52) for every field the port reads, so the same config
drives either package, the transfer codecs' knobs included
(``sparse_transfer``, ``transfer_codec`` and the budgets, with the JAX
defaults), and the device mesh's ``use_mesh``.  ``renderer`` and
``max_generation_time`` are accepted and read by neither package, so a
config written for one loads in the other; the TPU-only ``aot`` is not
here.

``DEFAULT_CATEGORIES`` is the two-level rule taxonomy of reference
src/config.py:6-21; the sampled ``category_path`` is exported in meta.json.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

DEFAULT_CATEGORIES: Dict[str, Any] = {
    "图形相似": {
        "位置变换": ["平移", "旋转", "翻转(镜像)", "组合"],
        "叠加": ["直接叠加", "去同存异", "去异存同"],
    },
    "图形相异": {
        "图形遍历": ["单一遍历", "位置遍历"],
    },
}

# Leaves whose sequences run 6 frames instead of 4 (reference src/generator.py:262).
OVERLAY_LEAVES = ("直接叠加", "去同存异", "去异存同")

# All rule leaves in taxonomy order; index = rule id.
RULE_LEAVES = (
    "平移",          # 0 translate
    "旋转",          # 1 rotate
    "翻转(镜像)",    # 2 flip
    "组合",          # 3 transform_many
    "直接叠加",      # 4 direct overlay
    "去同存异",      # 5 diff keep-different
    "去异存同",      # 6 diff keep-intersection
    "单一遍历",      # 7 kind traversal
    "位置遍历",      # 8 position traversal
)

# The 11 shape kinds in the reference's sampling order
# (reference src/sample.py:151); index = kind id.
SHAPE_KINDS = (
    "square", "circle", "triangle", "diamond", "star",
    "pentagon", "hexagon", "plus", "heart", "crescent", "rounded_square",
)
KIND_ID = {name: i for i, name in enumerate(SHAPE_KINDS)}


@dataclass
class GenConfig:
    """Schema-compatible generation config (reference src/config.py:23-52)."""

    out_dir: str = "./out"
    canvas_size: Tuple[int, int] = (512, 512)  # (W, H)
    grid_size: int = 3

    # appearance
    bg_color: Tuple[int, int, int] = (255, 255, 255)

    # randomness / reproducibility
    seed: Optional[int] = None

    # categories & sampling
    categories: Dict[str, Any] = field(
        default_factory=lambda: copy.deepcopy(DEFAULT_CATEGORIES))
    category_weights: Dict[str, float] = field(default_factory=dict)

    # export options
    export_coco: bool = True
    export_json: bool = True

    # sequence reasoning options
    seq_min: int = 2
    seq_max: int = 4
    num_options: int = 4
    shuffle_options: bool = True

    # ---- batching extensions (not in the reference schema) ----
    # samples per pipeline call
    batch_size: int = 64
    # element slots in the struct-of-arrays state (the reference's worst
    # case is ~6 after an overlay merge of two 3-element frames)
    max_elems: int = 8
    # distractor retry budget (reference src/generator.py:428)
    max_distractor_retries: int = 20
    # read by neither package, here only so that a config written for one
    # package loads in the other
    max_generation_time: int = 30
    renderer: str = "auto"
    # meta/coco JSON formatting: False writes compact JSON on the C
    # encoder; True restores the reference's indent=2 (reference
    # src/generator.py:596); the content is the same either way
    pretty_json: bool = False
    # export only grid_%06d.png + meta/coco (no per-frame images)
    grid_only: bool = False

    # ---- device-to-host transfer codecs (ops/rle.py, ops/sparse.py) ----
    # pack frames on the device before the copy (the CLI's --sparse)
    sparse_transfer: bool = False
    # block budgets of the 'sparse' codec, as fractions of a frame's and a
    # grid's 8x8 blocks; a frame above its budget is fetched raw
    sparse_budget: float = 0.35
    sparse_budget_grid: float = 0.55
    # 'rle5d'/'rle5' (length-1 bitmask), 'rle4d' (u8 lengths with a u16
    # extension stream and inter-frame deltas; the default), 'rle4',
    # 'rle3d', 'rle3' (batch-compacted runs, 255-colour palettes with
    # escapes), 'rle2' (u16 length + RGB a run), 'rle' (u32 start + packed
    # colour) or 'sparse' (8x8 blocks).  All lossless, with a raw fallback
    # for frames over budget.
    transfer_codec: str = "rle4d"
    # runs a frame / a grid may hold on the device; 0 = H*W/24 and
    # grid_h*W/9 (ops/rle.py default_budget, default_grid_budget)
    rle_budget: int = 0
    rle_budget_grid: int = 0

    # the device mesh (parallel/mesh.py): 'auto' splits each batch over
    # the largest number of visible cards that divides batch_size, when
    # that is more than one; True is an alias of 'auto' (as in the JAX
    # package); False pins one device
    use_mesh: Any = "auto"


def category_leaves(categories: Dict[str, Any]) -> list:
    """Flatten the two-level taxonomy into leaf paths (reference
    src/generator.py:634-650)."""
    leaves = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        elif isinstance(node, list):
            for item in node:
                leaves.append(path + [item])

    walk(categories, [])
    return leaves
