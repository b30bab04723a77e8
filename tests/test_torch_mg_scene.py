# test_torch_mg_scene.py — the port's mg scene builder against the JAX package's.
"""``scene.build_scene_batch`` of both packages on the same seeds and modes:
every array equal in dtype, shape and value, every record equal.  The port
keeps the host scene builder as numpy code, so the bar is exact."""
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.models.multigraph import scene as jax_scene
from reasoning_image_generation_tpu_torch.models.multigraph import scene

torch.set_num_threads(1)

MODES = ("random", "nested", "adjacent", "intersecting")
SEEDS = (0, 1, 2, 3, 5, 8, 13, 21)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", SEEDS)
def test_scene_batch_matches_jax(mode, seed):
    want, want_rec = jax_scene.build_scene_batch([seed, seed + 100],
                                                 [mode, mode])
    got, got_rec = scene.build_scene_batch([seed, seed + 100], [mode, mode])
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert np.array_equal(want[k], got[k]), k
    assert _same(want_rec, got_rec)
