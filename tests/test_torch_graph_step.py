# test_torch_graph_step.py — the batch steps that a card captures as graphs.
"""``LeafPipeline.step`` (all 9 rule leaves; grid-only and ``--sparse``
rle4d on 平移), the mg render (``renderer.render_scene_tensors``) and the
rest of each generator's batch (the steps its ``_dispatch`` hands to
utils/graphs.StepGraphs: keys, compaction, dedup, pHash, pack, blob) are
what a card captures into CUDA graphs.  A capture records the device work
of one call, so from its second call on a step must read no tensor back
to the host (no ``aten._local_scalar_dense``, ``nonzero``, ``is_nonzero``,
``masked_select``, ``unique`` or index by a boolean mask, seen through a
TorchDispatchMode) and build no tensor from host data (``torch.tensor``,
``torch.as_tensor`` of anything but a tensor, ``torch.from_numpy``, seen
through monkeypatching).  Outside the steps a warm ``_dispatch`` may only
make tensors of its host inputs and copy the blob (on a card: the inputs'
copies into the graphs, the outputs' clones and the blob's copy to the
host).  The plain versions of K1 and K2 (``raster.render_prepared``,
``renderer.render_prepared``) stand in for the kernels on the CPU and are
not watched: on a card the kernels run in their place.

On the CPU ``LeafPipeline.__call__`` and the mg generator's render run
the step as it is; they must equal ``step`` and the eager
``render_scene_batch`` byte for byte (tolerance: exact, every output
leaf, dtypes and shapes included).  The JAX package holds the outputs
themselves in the other test_torch_* files.  Canvas 64x64 (mg: dpi 8),
batch 2.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from reasoning_image_generation_tpu_torch.io.transfer import tree_flatten
from reasoning_image_generation_tpu_torch.models.multigraph import renderer
from reasoning_image_generation_tpu_torch.models.multigraph.generator import (
    GeometryGenerator)
from reasoning_image_generation_tpu_torch.models.rpm.generator import (
    RPMGenerator)
from reasoning_image_generation_tpu_torch.models.rpm.pipeline import (
    LeafPipeline, sample_keys)
from reasoning_image_generation_tpu_torch.ops import raster
from reasoning_image_generation_tpu_torch.ops.phash import CorpusDedup
from reasoning_image_generation_tpu_torch.utils import graphs
from reasoning_image_generation_tpu_torch.utils.config import (
    RULE_LEAVES, GenConfig)

torch.set_num_threads(1)

S = 64
# ops whose CUDA version reads a tensor on the host (the size of an output
# that depends on the data, or a value); an index by a boolean mask is one
HOST_READS = ("aten._local_scalar_dense", "aten.nonzero", "aten.is_nonzero",
              "aten.masked_select", "aten._unique2", "aten.unique_dim",
              "aten.unique_consecutive")
MASK_INDEX = ("aten.index", "aten.index_put", "aten.index_put_")


class HostWatch(TorchDispatchMode):
    """Inside ``with``, records every op that reads a tensor on the host
    and (through ``note``) every tensor built from host data, except while
    ``paused``."""

    def __init__(self):
        super().__init__()
        self.seen = []
        self.paused = False
        self.active = False

    def __enter__(self):
        self.active = True
        return super().__enter__()

    def __exit__(self, *exc):
        self.active = False
        return super().__exit__(*exc)

    def note(self, name: str) -> None:
        if self.active and not self.paused:
            self.seen.append(name)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in HOST_READS:
            self.note(name)
        elif name in MASK_INDEX and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            self.note(f"{name} by a mask")
        return func(*args, **(kwargs or {}))


class StepWatch(HostWatch):
    """A HostWatch that watches only inside utils/graphs.StepGraphs calls,
    what a card replays, and logs in ``outside`` every op run outside
    them."""

    def __init__(self):
        super().__init__()
        self.in_step = 0
        self.outside = []

    def note(self, name: str) -> None:
        if self.in_step:
            super().note(name)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.in_step:
            return super().__torch_dispatch__(func, types, args, kwargs)
        self.outside.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


# what a warm _dispatch may run outside the steps: a tensor of host data
# (its inputs) and the blob's copy (HostCopy on the CPU)
OUTSIDE_STEPS = {"aten.lift_fresh", "aten.clone"}


def _install(w, monkeypatch):
    """Patch the host-data constructors to report to `w` and run the plain
    kernel versions unwatched."""

    def reporting(name, fn, data_arg=True):
        def wrapped(*args, **kw):
            if not (data_arg and torch.is_tensor(args[0])):
                w.note(name)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(torch, "tensor", reporting("torch.tensor",
                                                   torch.tensor, False))
    monkeypatch.setattr(torch, "as_tensor", reporting("torch.as_tensor",
                                                      torch.as_tensor))
    monkeypatch.setattr(torch, "from_numpy", reporting("torch.from_numpy",
                                                       torch.from_numpy,
                                                       False))

    def unwatched(fn):
        def wrapped(*args, **kw):
            w.paused = True
            try:
                return fn(*args, **kw)
            finally:
                w.paused = False
        return wrapped

    monkeypatch.setattr(raster, "render_prepared",
                        unwatched(raster.render_prepared))
    monkeypatch.setattr(renderer, "render_prepared",
                        unwatched(renderer.render_prepared))


@pytest.fixture
def watch(monkeypatch):
    """A HostWatch (see ``_install``); enter it with ``with``."""
    w = HostWatch()
    _install(w, monkeypatch)
    return w


@pytest.fixture
def step_watch(monkeypatch):
    """A StepWatch (see ``_install``), told by StepGraphs when a step
    runs; enter it with ``with``."""
    w = StepWatch()
    _install(w, monkeypatch)
    real = graphs.StepGraphs.__call__

    def call(self, *args, **kw):
        w.in_step += 1
        try:
            return real(self, *args, **kw)
        finally:
            w.in_step -= 1

    monkeypatch.setattr(graphs.StepGraphs, "__call__", call)
    return w


def assert_same_tree(a, b):
    la, da = tree_flatten(a)
    lb, db = tree_flatten(b)
    assert da == db
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


CASES = [(leaf, {}) for leaf in RULE_LEAVES] + [
    ("平移", {"grid_only": True}),
    ("平移", {"sparse_transfer": True, "transfer_codec": "rle4d"})]


@pytest.mark.parametrize(
    "leaf,extra", CASES, ids=[f"{l}-{'-'.join(e) or 'full'}" for l, e in CASES])
def test_leaf_step_stays_on_the_device(leaf, extra, watch):
    pipe = LeafPipeline(leaf, GenConfig(batch_size=2, canvas_size=(S, S),
                                        **extra))
    keys = sample_keys(0, [3, 11])
    use_grid = torch.tensor([False, True])
    first = pipe.step(keys, use_grid)        # fills the per-device tables
    with watch:
        again = pipe.step(keys, use_grid)
    assert watch.seen == []
    assert_same_tree(again, first)
    # a second key set through __call__ (on the CPU: the step as it is)
    keys2, ug2 = sample_keys(0, [5, 8]), torch.tensor([True, False])
    assert_same_tree(pipe(keys2, ug2), pipe.step(keys2, ug2))


def test_mg_render_stays_on_the_device(watch, tmp_path, monkeypatch):
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path))
    dpi = 25
    batch = chip_smoke.mg_generated_batch(4)
    scene = renderer.scene_batch_to_torch(batch, "cpu")
    first = renderer.render_scene_tensors(scene, dpi)
    with watch:
        again = renderer.render_scene_tensors(scene, dpi)
    assert watch.seen == []
    assert torch.equal(again, first)
    # the generator's render (the graph's path on a card) equals the eager
    # upload-and-render
    gen = GeometryGenerator(torch.device("cpu"))
    imgs, hashes = gen._render_imgs(batch, dpi)
    gen.close()
    assert hashes is None
    want = renderer.render_scene_batch(batch, dpi, torch.device("cpu"))
    assert imgs.dtype == want.dtype and torch.equal(imgs, want)


TAIL_CASES = [("raw", {}),
              ("rle4d", {"sparse_transfer": True, "transfer_codec": "rle4d"}),
              ("rle5d", {"sparse_transfer": True, "transfer_codec": "rle5d"})]


@pytest.mark.parametrize("name,extra", TAIL_CASES,
                         ids=[n for n, _e in TAIL_CASES])
def test_rpm_dispatch_stays_in_its_steps(name, extra, step_watch, tmp_path,
                                         monkeypatch):
    """A warm RPMGenerator._dispatch of 平移 with the dedup, full export
    (raw, or --sparse rle4d / rle5d with the tiers of the first batch):
    its steps stay on the device and nothing else runs but tensors of its
    host inputs and the blob's copy; both batches export."""
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "stats"))
    gen = RPMGenerator(GenConfig(out_dir=str(tmp_path / "out"), batch_size=2,
                                 canvas_size=(S, S), seed=0, **extra),
                       torch.device("cpu"))
    gen._corpus = CorpusDedup(4, gen.device)
    path = next(p for p in gen._leaves if p[-1] == "平移")
    pipe, metas = gen._pipeline("平移"), {}
    first = [(0, path, False), (1, path, True)]
    gen._flush(gen._dispatch("平移", pipe, first), metas)
    gen._tier_stats = dict(gen._run_stats)
    with step_watch:
        pending = gen._dispatch("平移", pipe, [(2, path, False)])
    gen._flush(pending, metas)
    gen._pool.drain()
    gen.close()
    assert step_watch.seen == []
    assert set(step_watch.outside) <= OUTSIDE_STEPS, step_watch.outside
    assert sorted(metas) == [0, 1, 2]
    assert not any(m.result().get("error") for m in metas.values()
                   if hasattr(m, "result"))


@pytest.mark.parametrize("codec", ["rle4", "rle5"])
def test_mg_dispatch_stays_in_its_steps(codec, step_watch, tmp_path,
                                        monkeypatch):
    """A warm GeometryGenerator._dispatch_batch with the dedup (rle4 or
    rle5, the tiers and budget of the first batch): as the RPM case; the
    repeated scene comes back a duplicate."""
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path))
    gen = GeometryGenerator(torch.device("cpu"), transfer_codec=codec)
    gen._corpus = CorpusDedup(4, gen.device)
    first = gen._finish_batch(gen._dispatch_batch(
        [0, 1], ["random", "nested"], None, None, 8))
    with step_watch:
        st = gen._dispatch_batch([2, 0], ["adjacent", "random"], None, None,
                                 8)
    recs = first + gen._finish_batch(st)
    gen.close()
    assert step_watch.seen == []
    assert set(step_watch.outside) <= OUTSIDE_STEPS, step_watch.outside
    assert [bool(r.get("duplicate")) for r in recs] == [False] * 3 + [True]


@pytest.mark.parametrize("expr,want", [
    (lambda x: bool(x.sum()), "aten._local_scalar_dense"),
    (lambda x: int(x[0]), "aten._local_scalar_dense"),
    (lambda x: x[x > 1], "aten.index by a mask"),
    (lambda x: torch.nonzero(x), "aten.nonzero"),
    (lambda x: torch.tensor([1, 2]), "torch.tensor"),
    (lambda x: torch.as_tensor([1.0]), "torch.as_tensor"),
    (lambda x: torch.from_numpy(x.numpy()), "torch.from_numpy"),
    (lambda x: torch.as_tensor(x), None),        # a tensor: no host data
], ids=["bool", "int", "mask", "nonzero", "tensor", "as_tensor",
        "from_numpy", "as_tensor_of_tensor"])
def test_watch_sees_host_reads_and_uploads(expr, want, watch):
    """The watch itself: each kind of host traffic it is meant to catch."""
    x = torch.arange(4)
    with watch:
        expr(x)
    assert want in watch.seen if want else watch.seen == []
