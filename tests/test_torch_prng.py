# test_torch_prng.py — the port's threefry streams against jax.random.
"""Every jax.random call the JAX package makes (key, fold_in, split,
uniform, randint, bernoulli, permutation) must give the same bits in the
port (utils/prng.py), batched over many keys.  Tolerance: exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu_torch.utils import prng as P

torch.set_num_threads(1)

N_KEYS = 256
SHAPES = [(), (8,), (8, 2), (3, 5)]


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.fixture(scope="module")
def keys():
    master = jax.random.key(7)
    ids = np.arange(N_KEYS) * 13 + 1
    kj = jax.vmap(lambda i: jax.random.fold_in(master, i))(jnp.asarray(ids))
    kt = P.fold_in(P.key(7), torch.tensor(ids))
    return kj, kt


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, 2 ** 32 + 5, -1])
def test_key(seed):
    assert (_kd(jax.random.key(seed)) == P.key(seed).numpy()).all()


def test_fold_in(keys):
    kj, kt = keys
    assert (_kd(kj) == kt.numpy()).all()


@pytest.mark.parametrize("num", [2, 3, 6, 11])
def test_split(keys, num):
    kj, kt = keys
    want = _kd(jax.vmap(lambda k: jax.random.split(k, num))(kj))
    assert (want == P.split(kt, num).numpy()).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.5, 7.25), (30.0, 220.0),
                                   (40.0, 472.0)])
def test_uniform(keys, shape, lo, hi):
    kj, kt = keys
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.uniform(k, shape, minval=lo, maxval=hi)))(kj))
    got = P.uniform(kt, shape, lo, hi).numpy()
    assert (want.view(np.int32) == got.view(np.int32)).all()


def test_uniform_array_bounds(keys):
    kj, kt = keys
    mx = np.asarray([472.0, 88.0], np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.uniform(
        k, (8, 2), minval=40.0, maxval=jnp.asarray(mx))))(kj))
    got = P.uniform(kt, (8, 2), 40.0, torch.tensor(mx)).numpy()
    assert (want.view(np.int32) == got.view(np.int32)).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 4), (1, 4), (-5, 6), (0, 11),
                                   (3, 3), (5, 2), (-2 ** 31, 2 ** 31 - 1),
                                   (0, 2 ** 20 + 7)])
def test_randint_ranges(keys, shape, lo, hi):
    kj, kt = keys
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, shape, lo, hi))(kj))
    assert (want == P.randint(kt, shape, lo, hi).numpy()).all()


@pytest.mark.parametrize("shape", [(), (4,)])
def test_randint_traced_maxval(keys, shape):
    kj, kt = keys
    mx = np.arange(N_KEYS) % 7 + 1
    want = np.asarray(jax.vmap(lambda k, m: jax.random.randint(
        k, shape, 0, m + 1))(kj, jnp.asarray(mx)))
    m = torch.tensor(mx).reshape((-1,) + (1,) * len(shape))
    assert (want == P.randint(kt, shape, 0, m + 1).numpy()).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_bernoulli(keys, shape):
    kj, kt = keys
    want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, shape=shape))(kj))
    assert (want == P.bernoulli(kt, 0.5, shape).numpy()).all()


@pytest.mark.parametrize("n", [1, 2, 4, 9, 100, 3000])
def test_permutation(keys, n):
    """n = 3000 takes two sort rounds."""
    kj, kt = keys
    want = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(kj))
    assert (want == P.permutation(kt, n).numpy()).all()
