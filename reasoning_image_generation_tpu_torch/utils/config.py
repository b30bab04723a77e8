# config.py — the generation config and the rule/shape tables.
"""The JAX package's ``utils/config.py`` imports no JAX, so the port shares
it unchanged: both packages read one set of defaults, leaves and shape
kinds.  Port modules and scripts import these names from here."""
from reasoning_image_generation_tpu.utils.config import (  # noqa: F401
    KIND_ID, OVERLAY_LEAVES, RULE_LEAVES, SHAPE_KINDS, GenConfig,
    category_leaves)
