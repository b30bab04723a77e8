# test_torch_pipeline_composite.py — the 组合 leaf and state_hash against JAX.
"""组合 (several elements translated, rotated or flipped at once) through
the port's LeafPipeline and the JAX package's, with the checks and the
tolerance of test_torch_pipeline.py (exact for every output), and the
distractor dedup's structural hash on its own."""
import torch

from .test_torch_pipeline import leaf_mismatches

torch.set_num_threads(1)


def test_leaf_pipeline_matches_jax():
    assert leaf_mismatches("组合") == []


def test_state_hash_matches_jax():
    """Random frames with centres and boxes below zero (平移 and the
    fallback shifts can leave them there) and above 2**16: XLA saturates
    round(x) -> uint32, and the multiply-add wraps at 2**32."""
    import jax
    import numpy as np

    from reasoning_image_generation_tpu.models.rpm.pipeline import (
        state_hash as jax_state_hash)
    from reasoning_image_generation_tpu.utils.state import ElementState as JS
    from reasoning_image_generation_tpu_torch.models.rpm.pipeline import (
        state_hash)
    from reasoning_image_generation_tpu_torch.utils.state import from_numpy

    rng = np.random.default_rng(0)
    N, E = 64, 8
    f = lambda lo, hi, *s: rng.uniform(lo, hi, (N, E) + s).astype(np.float32)
    b = lambda: rng.random((N, E)) < 0.5
    st = JS(kind=rng.integers(0, 11, (N, E)).astype(np.int32),
            size=f(0, 300), fill=b(), stroke=f(0, 4), cx=f(-600, 70000),
            cy=f(-600, 600), angle=f(-360, 360), flip_h=b(), flip_v=b(),
            color=f(0, 256, 3), bbox=f(-300, 600, 4), valid=b())
    want = np.asarray(jax.vmap(jax_state_hash)(st))
    got = state_hash(from_numpy(st)).numpy()
    assert np.array_equal(want.astype(np.int64), got)
