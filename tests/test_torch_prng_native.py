# test_torch_prng_native.py — the threefry kernel's round code and its
# wrappers against the integer code and jax.random.
"""csrc/threefry.cuh holds the code each thread of the threefry kernel runs
(csrc/threefry.cu only launches it).  Here a host C compiler builds it
into a shim that exports the kernel's three entry points as loops on the
CPU, and ops/prng_cuda.py's wrappers run on it in place of the launch:
their layouts (strided, broadcast and transposed key views), counts and
output shapes, and the rounds themselves, must equal utils/prng.py's
integer code and, on the keys of test_torch_prng.py, ``jax.random``.
Tolerance: exact.  A failed host compile skips with the compiler's
message.

The ``test_card_*`` tests take the ``card`` fixture and skip without a
CUDA card; on one they hold the kernel, eagerly and replayed from a CUDA
graph, to the integer code on the CPU, bit for bit, and count its
launches.  This file imports JAX only inside the fixture that compares
with it, so on a card it runs without JAX:
``python -m pytest --noconftest -p no:cacheprovider -q
tests/test_torch_prng_native.py -k card``.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu_torch.io.transfer import tree_flatten
from reasoning_image_generation_tpu_torch.models.rpm.pipeline import (
    make_sample_fn)
from reasoning_image_generation_tpu_torch.ops import cuda_build, prng_cuda
from reasoning_image_generation_tpu_torch.utils import graphs
from reasoning_image_generation_tpu_torch.utils import prng as P
from reasoning_image_generation_tpu_torch.utils.config import (
    RULE_LEAVES, GenConfig)

torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parent.parent
M32 = 0xFFFFFFFF
# words at both ends of uint32 and around the key schedule's constant
WORDS = [0, 1, 0x1BD11BDA, 0x80000000, M32 - 1, M32]
COUNTS = [1, 2, 6, 1024]

# the kernel's entry points as loops over the same per-output code
SHIM = r"""
#include "threefry.cuh"

static int run(int mode, const int64_t *keys, const int64_t *data,
               int64_t value, RigTfBatch b, int64_t count, int64_t *out) {
  const int64_t n = rig_tf_rows(b) * count;
  for (int64_t t = 0; t < n; ++t)
    rig_tf_one(mode, keys, data, value, b, count, t, out);
  return 0;
}

int rig_threefry_fold_in(const int64_t *keys, const int64_t *data,
                         int64_t value, RigTfBatch b, int64_t *out,
                         void *stream) {
  (void)stream;
  return run(RIG_TF_FOLD_IN, keys, data, value, b, 1, out);
}

int rig_threefry_split(const int64_t *keys, RigTfBatch b, int64_t num,
                       int64_t *out, void *stream) {
  (void)stream;
  return run(RIG_TF_SPLIT, keys, 0, 0, b, num, out);
}

int rig_threefry_random_bits(const int64_t *keys, RigTfBatch b,
                             int64_t count, int64_t *out, void *stream) {
  (void)stream;
  return run(RIG_TF_BITS, keys, 0, 0, b, count, out);
}
"""


def word_keys() -> torch.Tensor:
    """Every pair of WORDS as a key ``[36, 2]``."""
    return torch.tensor([[a, b] for a in WORDS for b in WORDS],
                        dtype=torch.int64)


def folded_keys(n: int = 32, device="cpu") -> torch.Tensor:
    return P.fold_in(P.key(11, device),
                     torch.arange(n, device=device) * 7 + 3)


# key views the leaves hand to the key streams: rows, a batch of batches,
# split's halves and scan steps (strided rows), unbind's pieces, a
# transposed batch (no single row stride), a broadcast key, and words that
# are not adjacent
LAYOUTS = {
    "rows": lambda k: k,
    "batch_of_batches": lambda k: k.reshape(4, 8, 2),
    "split_half": lambda k: P.split(k, 2)[..., 0, :],
    "scan_step": lambda k: P.split(k, 5)[:, 3],
    "unbind": lambda k: P.split(k, 6).unbind(-2)[4],
    "transposed": lambda k: k.reshape(4, 8, 2).transpose(0, 1),
    "broadcast": lambda k: k[:1].expand(5, 2),
    "word_stride": lambda k: torch.stack([k[:, 0], k[:, 1]]).t(),
}


def draws(keys: torch.Tensor) -> list:
    """Each key stream on `keys`: fold_in by a tensor and by an int, split,
    random_bits of a scalar and of a shape."""
    batch = keys.shape[:-1]
    data = torch.arange(int(np.prod(batch)), device=keys.device)
    return [P.fold_in(keys, data.reshape(batch) * 5 - 2),
            P.fold_in(keys, 2 ** 40 + 9), P.split(keys, 3),
            P.random_bits(keys), P.random_bits(keys, (2, 3))]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/threefry.cuh built with the C compiler ($CC, default cc) into
    the shim, loaded with the kernel's signatures."""
    cc = os.environ.get("CC", "cc")
    if shutil.which(cc) is None:
        pytest.skip(f"no C compiler {cc!r} on PATH")
    d = tmp_path_factory.mktemp("threefry_host")
    src, lib = d / "threefry_host.c", d / "libthreefry_host.so"
    src.write_text(SHIM)
    proc = subprocess.run(
        [cc, "-O2", "-std=c99", "-Wall", "-shared", "-fPIC",
         "-I", cuda_build.CSRC, "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        pytest.skip(f"{cc} could not build the host shim:\n{proc.stderr}")
    return cuda_build.load(str(lib), prng_cuda.SIGNATURES)


@pytest.fixture
def native(host, monkeypatch):
    """ops/prng_cuda.py with the shim in place of the launch."""
    def launch(fn, out, *args):
        if out.numel():
            assert getattr(host, fn)(*args, out.data_ptr(), None) == 0
        return out
    monkeypatch.setattr(prng_cuda, "_launch", launch)
    return prng_cuda


@pytest.fixture(scope="module")
def oracle():
    """test_torch_prng.py's keys: jax's and the port's."""
    pytest.importorskip("jax")
    from . import test_torch_prng
    return test_torch_prng.fold_in_keys()


def test_entry_points_are_the_kernels():
    """The shim exports what csrc/threefry.cu exports."""
    with open(os.path.join(cuda_build.CSRC, "threefry.cu")) as f:
        names = re.findall(r'extern "C" int (\w+)\(', f.read())
    assert sorted(names) == sorted(prng_cuda.SIGNATURES)


@pytest.mark.parametrize("data", [0, 1, 0x1BD11BDA, M32, -1, 2 ** 40 + 3])
def test_fold_in_rounds(native, data):
    """fold_in is threefry2x32 of (0, data) under each key."""
    k = word_keys()
    a, b = P.threefry2x32(k[:, 0], k[:, 1], torch.zeros_like(k[:, 0]),
                          torch.full_like(k[:, 0], data & M32))
    want = torch.stack([a, b], -1)
    assert torch.equal(native.fold_in(k, data), want)
    assert torch.equal(native.fold_in(k, torch.full((36,), data)), want)


@pytest.mark.parametrize("count", COUNTS)
def test_split_matches_integer_code(native, count):
    k = word_keys()
    assert torch.equal(native.split(k, count), P.split(k, count))


@pytest.mark.parametrize("count", COUNTS)
def test_random_bits_matches_integer_code(native, count):
    k = word_keys()
    assert torch.equal(native.random_bits(k, (count,)),
                       P.random_bits(k, (count,)))


@pytest.mark.parametrize("name", LAYOUTS)
def test_layouts_match_integer_code(native, name):
    """Key views read in place through their strides."""
    keys = LAYOUTS[name](folded_keys())
    batch = keys.shape[:-1]
    data = torch.arange(int(np.prod(batch))).reshape(batch) * 5 - 2
    for got, want in [
            (native.fold_in(keys, data), P.fold_in(keys, data)),
            (native.fold_in(keys, 2 ** 40 + 9), P.fold_in(keys, 2 ** 40 + 9)),
            (native.split(keys, 3), P.split(keys, 3)),
            (native.random_bits(keys), P.random_bits(keys)),
            (native.random_bits(keys, (2, 3)), P.random_bits(keys, (2, 3)))]:
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("keys_shape,data_shape", [
    ((2,), (7,)), ((4, 1, 2), (3,)), ((1, 3, 2), (5, 1)), ((6, 2), ())])
def test_fold_in_broadcasts(native, keys_shape, data_shape):
    keys = folded_keys(int(np.prod(keys_shape[:-1]))).reshape(keys_shape)
    data = torch.arange(int(np.prod(data_shape))).reshape(data_shape) + 11
    got, want = native.fold_in(keys, data), P.fold_in(keys, data)
    assert got.shape == want.shape and torch.equal(got, want)


def test_empty_and_too_many_dims(native):
    k = folded_keys(4)
    assert native.split(k, 0).shape == (4, 0, 2)
    assert native.random_bits(k[:0], (3,)).shape == (0, 3)
    with pytest.raises(ValueError):
        prng_cuda.layout(torch.zeros((1,) * 9 + (2,), dtype=torch.int64),
                         (1,) * 9)


def test_first_calls_import_nothing():
    """The wrappers' first calls import no module: a lazy import there (as
    torch.broadcast_shapes imports sympy) lands in a generator's set-up."""
    child = (
        "import sys, torch\n"
        "from reasoning_image_generation_tpu_torch.ops import prng_cuda\n"
        "prng_cuda._launch = lambda fn, out, *args: out\n"
        "k = torch.zeros((4, 1, 2), dtype=torch.int64)\n"
        "before = set(sys.modules)\n"
        "prng_cuda.fold_in(k, torch.arange(3)); prng_cuda.fold_in(k, 7)\n"
        "prng_cuda.split(k[:, 0], 3); prng_cuda.random_bits(k, (2, 5))\n"
        "print(sorted(set(sys.modules) - before))\n")
    proc = subprocess.run([sys.executable, "-c", child], cwd=str(REPO_ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_fold_in_matches_jax(native, oracle):
    import jax
    kj, kt = oracle
    ids = np.arange(len(kt)) * 13 + 1
    got = native.fold_in(P.key(7), torch.tensor(ids))
    assert (np.asarray(jax.random.key_data(kj)).astype(np.int64)
            == got.numpy()).all()
    # one int: every key of the batch folded with it
    want = jax.vmap(lambda k: jax.random.fold_in(k, 5))(kj)
    assert (np.asarray(jax.random.key_data(want)).astype(np.int64)
            == native.fold_in(kt, 5).numpy()).all()


@pytest.mark.parametrize("num", COUNTS)
def test_split_matches_jax(native, oracle, num):
    import jax
    kj, kt = oracle
    want = jax.vmap(lambda k: jax.random.split(k, num))(kj)
    assert (np.asarray(jax.random.key_data(want)).astype(np.int64)
            == native.split(kt, num).numpy()).all()


@pytest.mark.parametrize("count", COUNTS)
def test_random_bits_matches_jax(native, oracle, count):
    import jax
    kj, kt = oracle
    want = jax.vmap(lambda k: jax.random.bits(k, (count,), np.uint32))(kj)
    assert (np.asarray(want).astype(np.int64)
            == native.random_bits(kt, (count,)).numpy()).all()


# ---- on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", LAYOUTS)
def test_card_key_streams_match_cpu(card, name):
    """Each entry point on each key view, one launch a call."""
    keys = LAYOUTS[name](folded_keys(device=card))
    want = draws(LAYOUTS[name](folded_keys()))
    before = prng_cuda.LAUNCHES
    got = draws(keys)
    assert prng_cuda.LAUNCHES - before == len(got)
    for g, w in zip(got, want):
        assert g.device == keys.device and g.dtype == torch.int64
        assert g.shape == w.shape and torch.equal(g.cpu(), w)


def samplers(keys: torch.Tensor) -> list:
    mx = torch.arange(keys.shape[0], device=keys.device) % 7 + 1
    return [P.uniform(keys, (8, 2), 40.0, 472.0), P.uniform(keys),
            P.randint(keys, (5,), -5, 6), P.randint(keys, (), 0, mx),
            P.randint(keys, (3,), -2 ** 31, 2 ** 31 - 1),
            P.bernoulli(keys, 0.5, (4,)), P.permutation(keys, 4),
            P.permutation(keys, 3000)]


def test_card_samplers_match_cpu(card):
    want = samplers(folded_keys())
    got = samplers(folded_keys(device=card))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_card_no_integer_chain(card, monkeypatch):
    """On a card no op of threefry2x32's integer code runs."""
    keys = folded_keys(device=card)

    def integer_chain(*args):
        raise AssertionError("threefry2x32's integer code ran on a card")

    monkeypatch.setattr(P, "threefry2x32", integer_chain)
    draws(keys)
    samplers(keys)
    P.fold_in(P.key(3, card), torch.arange(4, device=card))


def _step(keys):
    sub = P.split(keys, 4)
    return {"bits": P.random_bits(sub[:, 1], (8,)),
            "u": P.uniform(sub[:, 2], (3,)),
            "i": P.randint(sub[:, 3], (2,), 0, 9),
            "k": P.fold_in(sub[:, 0], 9)}


def test_card_graph_replays(card):
    """Captured into a CUDA graph: two warm runs count, each replay adds
    the graph's launches, and the replays equal the CPU."""
    # split, random_bits, uniform's one, randint's three, fold_in
    per_call = 7
    g = graphs.StepGraphs(_step, counters=(prng_cuda,))
    ka, kb = folded_keys(), P.split(folded_keys(), 2)[:, 1]
    before = prng_cuda.LAUNCHES
    a = g(ka.to(card))
    assert prng_cuda.LAUNCHES - before == (graphs.WARM_RUNS + 1) * per_call
    b = g(kb.to(card))
    assert prng_cuda.LAUNCHES - before == (graphs.WARM_RUNS + 2) * per_call
    for got, keys in ((a, ka), (b, kb)):
        want = _step(keys)
        assert all(torch.equal(got[n].cpu(), want[n]) for n in want)


@pytest.mark.parametrize("leaf", RULE_LEAVES)
def test_card_leaf_samples_match_cpu(card, leaf):
    """A leaf's sample function (every draw of its batch) on the card
    equals the CPU's."""
    cfg = GenConfig(canvas_size=(128, 128))
    keys = folded_keys(8)
    use_grid = torch.arange(8) % 2 == 1
    fn = make_sample_fn(leaf, cfg)
    want = fn(keys, use_grid)
    before = prng_cuda.LAUNCHES
    got = fn(keys.to(card), use_grid.to(card))
    assert prng_cuda.LAUNCHES > before
    (lg, dg), (lw, dw) = tree_flatten(got), tree_flatten(want)
    assert dg == dw and len(lg) == len(lw)
    for g, w in zip(lg, lw):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w), leaf
