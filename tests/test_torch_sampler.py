# test_torch_sampler.py — prototype sampler and the off-taxonomy rule vs JAX.
"""sample_prototype in all 5 arrangements, grid and free placement, with
n drawn or pinned, and the 元素传递 rule (registered but outside the default
taxonomy, so the pipeline tests never reach it), against the JAX package on
the same keys.  Tolerance: exact, float fields included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.models.rpm import rules as jax_rules
from reasoning_image_generation_tpu.models.rpm.sampler import (
    sample_prototype as jax_sample_prototype)
from reasoning_image_generation_tpu_torch.models.rpm import rules
from reasoning_image_generation_tpu_torch.models.rpm.sampler import (
    sample_prototype)
from reasoning_image_generation_tpu_torch.utils import prng
from reasoning_image_generation_tpu_torch.utils.state import (from_numpy,
                                                              to_numpy)

torch.set_num_threads(1)

B, E, W, H = 16, 8, 512, 512
IDS = np.arange(B) * 7 + 3


def _keys(seed):
    master = jax.random.key(seed)
    kj = jax.vmap(lambda i: jax.random.fold_in(master, i))(jnp.asarray(IDS))
    return kj, prng.fold_in(prng.key(seed), torch.tensor(IDS))


def _assert_states_equal(want, got):
    got = to_numpy(got)
    for f in got._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# n=None draws 1..3 per key, so each arrangement meets its n == 1 branch;
# the pinned counts are the ones the leaves ask for (pipeline.proto_n_for)
CASES = [(a, None) for a in ("random", "horizontal", "vertical", "diagonal",
                             "circular")] + [("random", 1), ("random", 2),
                                             ("circular", 2)]


@pytest.mark.parametrize("arrangement,n", CASES)
def test_sample_prototype_matches_jax(arrangement, n):
    kj, kt = _keys(11)
    ug = np.arange(B) % 3 == 0
    want = jax.jit(jax.vmap(lambda k, g: jax_sample_prototype(
        k, W, H, E, n=n, use_grid=g, arrangement=arrangement)))(
            kj, jnp.asarray(ug))
    got = sample_prototype(kt, W, H, E, n=n, use_grid=torch.tensor(ug),
                           arrangement=arrangement)
    _assert_states_equal(want, got)


def test_element_transfer_matches_jax():
    kj, kt = _keys(5)
    ug = np.zeros(B, bool)
    prev_j = jax.vmap(lambda k: jax_sample_prototype(k, W, H, E))(kj)
    cur_j = jax.vmap(lambda k: jax_sample_prototype(
        jax.random.fold_in(k, 1), W, H, E))(kj)
    # one frame with every slot live: nothing to transfer into
    cur_j = cur_j._replace(valid=cur_j.valid.at[0].set(True))
    init_j, step_j = jax_rules.RULES["元素传递"]
    init_t, step_t = rules.RULES["元素传递"]

    def one(prev, cur, k, g):
        p = init_j(k, cur, g, W, H)
        return step_j(prev, cur, p, k, jnp.asarray(1), g, W, H)[0]

    want = jax.jit(jax.vmap(one))(prev_j, cur_j, kj, jnp.asarray(ug))
    prev_t = from_numpy(jax.tree.map(np.asarray, prev_j))
    cur_t = from_numpy(jax.tree.map(np.asarray, cur_j))
    p = init_t(kt, cur_t, torch.tensor(ug), W, H)
    got, _ = step_t(prev_t, cur_t, p, kt, 1, torch.tensor(ug), W, H)
    _assert_states_equal(want, got)
