# test_torch_transfer.py — the port's transfer helpers against the JAX ones.
"""io/transfer.py, utils/cache.py and the run-stream PNG writers of the
port, on the CPU.

Coalescing: the same leaves (bool, u8, int32, u16 — int16 on the port's
wire — and float32) through the JAX package's ``coalesce``,
``coalesce_shrunk``, ``coalesce_flat`` and ``coalesce_flat_shrunk`` and
the port's give the same bytes, under given sizes too, and the port's
split gives the leaves back.  The port's tree flattening visits leaves in
``jax.tree.flatten``'s order.  Compacted rle4/rle5 streams shrunk under
given sizes make the same blob in both packages, and ``Rle3Frames`` over
it decodes every frame to the original or flags it for a raw fetch.  The
raw fallbacks (``gather_frames``, ``overflow_pixels``, ``unpack_images``)
give the original frames.  The C run-stream writer (at most 256 colours:
indexed PNG; more: RGB; with an overlay) and its zlib fallback write the
pixels ``io/png_read`` reads back.  Exact throughout.
"""
import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.io import transfer as jax_transfer
from reasoning_image_generation_tpu.ops import rle as jax_rle
from reasoning_image_generation_tpu_torch.io import png, transfer
from reasoning_image_generation_tpu_torch.io.png_read import read_png
from reasoning_image_generation_tpu_torch.ops import phash, rle, sparse
from reasoning_image_generation_tpu_torch.ops.compose import apply_overlay_u8
from reasoning_image_generation_tpu_torch.utils import cache

from .test_torch_rle import frame_set, hand_frames

torch.set_num_threads(1)

B = 3


class Pair(NamedTuple):
    b: object
    a: object


def _leaves(rng):
    """(port tensors, JAX arrays) of five leaves with the batch axis."""
    vals = [rng.integers(0, 2, (B, 5)).astype(bool),
            rng.integers(0, 256, (B, 3, 2)).astype(np.uint8),
            rng.integers(-2 ** 31, 2 ** 31, (B,)).astype(np.int32),
            rng.integers(0, 2 ** 16, (B, 4)).astype(np.uint16),
            rng.standard_normal((B, 2)).astype(np.float32)]
    port = [torch.from_numpy(v.view(np.int16) if v.dtype == np.uint16 else v)
            for v in vals]
    return port, [jnp.asarray(v) for v in vals], vals


@pytest.mark.parametrize("sizes", [None, (None, (-1, 1), None, (1, 2), None),
                                   ((1, 2), (1, 1), None, (-1, 3), (1, 1))])
def test_coalesce_matches_jax(sizes):
    port, jx, vals = _leaves(np.random.default_rng(0))
    if sizes is None:
        want = np.asarray(jax_transfer.coalesce(jx))
        got = transfer.coalesce(port)
        specs = transfer.blob_specs(tuple(port))[2]
    else:
        want = np.asarray(jax_transfer.coalesce_shrunk(jx, sizes))
        got = transfer.coalesce_shrunk(port, sizes)
        specs = transfer.shrunk_specs(port, sizes)
    assert got.dtype == torch.uint8 and np.array_equal(want, got.numpy())
    back = transfer.split_blob(got.numpy(), transfer.tree_flatten(
        tuple(port))[1], specs)
    for v, b, (shape, _dt) in zip(vals, back, specs):
        idx = tuple(slice(0, n) for n in shape)
        assert b.dtype == v.dtype and np.array_equal(b, v[idx])


@pytest.mark.parametrize("sizes", [None, ((0, 2), None, (1, 1), None,
                                          (0, 1))])
def test_coalesce_flat_matches_jax(sizes):
    port, jx, vals = _leaves(np.random.default_rng(1))
    if sizes is None:
        want = np.asarray(jax_transfer.coalesce_flat(jx))
        got = transfer.coalesce_flat(port)
        specs = transfer.blob_specs(port)[2]
    else:
        want = np.asarray(jax_transfer.coalesce_flat_shrunk(jx, sizes))
        got = transfer.coalesce_flat_shrunk(port, sizes)
        specs = transfer.shrunk_specs(port, sizes)
    assert np.array_equal(want, got.numpy())
    back = transfer.split_flat(got.numpy(), transfer.tree_flatten(port)[1],
                               specs)
    for v, b, (shape, _dt) in zip(vals, back, specs):
        assert np.array_equal(b, v[tuple(slice(0, n) for n in shape)])


def test_tree_order_matches_jax():
    """dict keys sorted, tuple and NamedTuple items in order; unflatten
    rebuilds the same structure."""
    tree = {"z": Pair(1, (2, 3)), "_k": 4, "a": {"y": 5, "b": (6,)},
            "m": (Pair(7, 8), 9)}
    leaves, treedef = transfer.tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree)
    assert transfer.tree_unflatten(treedef, leaves) == tree
    assert isinstance(transfer.tree_unflatten(treedef, leaves)["z"], Pair)


def test_transfer_tier_matches_jax():
    for cap in (1024, 40000):
        for seen in (None, 0, 1.5, 100, 900.7, 5000, 39000):
            assert transfer.transfer_tier(seen, cap) == \
                jax_transfer.transfer_tier(seen, cap), (seen, cap)


@pytest.mark.parametrize("version", [4, 5])
def test_shrunk_compacted_streams_decode(version):
    """rle4/rle5 of the hand-built frames with the run stream shrunk below
    what the later frames need: the same blob as the JAX package's, and
    every frame decodes to the original or is flagged for a raw fetch
    (never a wrong frame)."""
    frames, _b, cap = frame_set("hand")
    packed = getattr(rle, f"pack_batch_rle{version}")(torch.from_numpy(frames),
                                                      cap)
    jpacked = getattr(jax_rle, f"pack_batch_rle{version}")(
        jnp.asarray(frames), cap)
    # the run stream cut just after frame 2's runs: frames 3.. overflow
    c = np.minimum(packed[-5 if version == 5 else -4].numpy(), cap)
    t = (0, int(c[:3].sum()))
    sizes = ((None, None, t) if version == 5 else (t, t))
    sizes += (None,) * (len(packed) - len(sizes))
    blob = transfer.coalesce_flat_shrunk(list(packed), sizes)
    assert np.array_equal(np.asarray(jax_transfer.coalesce_flat_shrunk(
        list(jpacked), sizes)), blob.numpy())
    specs = transfer.shrunk_specs(list(packed), sizes)
    host = transfer.split_flat(blob.numpy(), transfer.tree_flatten(packed)[1],
                               specs)
    fr = rle.Rle3Frames(host, cap)
    over = fr.overflow_indices(len(frames))
    assert over.tolist() == [3, 4, 5]
    raw = transfer.gather_frames(torch.from_numpy(frames), over)
    for i, want in enumerate(frames):
        got = raw[i] if i in over else fr.unpack(i, want.shape)
        assert np.array_equal(got, want), i
    assert fr.overflow_reasons(len(frames)) == {"T": 3}


@pytest.mark.parametrize("codec", ["rle", "rle2", "sparse"])
def test_unpack_images_falls_back_to_raw(codec):
    """Per-frame codecs at a budget that the noisy frame overflows: the
    frames come back exact, the overflowed one from the raw tensor."""
    frames = torch.from_numpy(hand_frames()).reshape(2, 3, 64, 64, 3)
    if codec == "sparse":
        packed = sparse.pack_batch(frames, 40)
    else:
        packed = getattr(rle, "pack_batch_rle" if codec == "rle"
                         else "pack_batch_rle2")(frames, 300)
    host = tuple(transfer.host_array(a) for a in packed)
    ring = transfer.HostBufferRing(slots=2)
    buf, wrapped = ring.acquire(frames.shape)
    out = transfer.unpack_images(host, frames, codec, out=buf)
    assert out is buf and not wrapped
    assert np.array_equal(out, frames.numpy())
    if codec != "sparse":
        over = transfer.overflow_pixels(host, frames, 6)
        assert sorted(over) == [i for i in range(6)
                                if int(host[2].reshape(-1)[i]) > 300]
        assert over and all(np.array_equal(v, frames.reshape(6, 64, 64, 3)[i])
                            for i, v in over.items())


def test_host_buffer_ring_wraps():
    ring = transfer.HostBufferRing(slots=2)
    a, wa = ring.acquire((4, 3))
    b, wb = ring.acquire((4, 3))
    c, wc = ring.acquire((4, 3))
    d, wd = ring.acquire((4, 3), np.int32)
    assert (wa, wb, wc, wd) == (False, False, True, False)
    assert c is a and b is not a and d.dtype == np.int32


def test_host_copy_is_a_copy():
    blob = torch.arange(10, dtype=torch.uint8)
    copy = transfer.HostCopy(blob)
    blob += 1
    assert copy.numpy().tolist() == list(range(10))


def test_corpus_dedup_handle_stays_on_the_device():
    """submit hands back the keep mask as a tensor (it rides in a blob);
    resolve gives the host mask."""
    d = phash.CorpusDedup(3, torch.device("cpu"), threshold=0)
    h = torch.tensor([[1] * 8, [2] * 8, [1] * 8, [3] * 8], dtype=torch.uint8)
    kind, keep, n = d.submit(h, 3)
    assert kind == "dev" and isinstance(keep, torch.Tensor) and n == 3
    assert keep.tolist() == [True, True, False, False]
    assert d.resolve(d.submit(h[[3, 0, 1, 3]], 4)).tolist() == \
        [True, False, False, False]


def test_run_stats_persist_in_their_own_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "a"))
    assert cache.cache_dir() == str(tmp_path / "a")
    assert cache.load_run_stats("x") == {}
    cache.save_run_stats("x", {"k": 3, "j": 1.5})
    cache.save_run_stats("x", {"k": 2, "m": 7})       # max-merged
    assert cache.load_run_stats("x") == {"k": 3.0, "j": 1.5, "m": 7.0}
    with open(tmp_path / "a" / "runstats_x.json", encoding="utf-8") as f:
        assert json.load(f)["k"] == 3.0
    monkeypatch.setenv("RIG_TORCH_CACHE", str(tmp_path / "b"))
    assert cache.load_run_stats("x") == {}            # read at call time
    monkeypatch.delenv("RIG_TORCH_CACHE")
    assert "rig_tpu_xla" not in cache.cache_dir()


@pytest.mark.parametrize("n_colours", [5, 300])
@pytest.mark.parametrize("encoder", ["fastpng", "zlib"])
def test_png_from_runs(tmp_path, monkeypatch, encoder, n_colours):
    """The run-stream writer with and without an overlay: indexed PNG up to
    256 colours, RGB above (the C encoder), the decode path without it."""
    if encoder == "fastpng" and png.encoder() != "fastpng":
        pytest.fail("csrc/fastpng.c did not build")
    monkeypatch.setattr(png, "_encoder", None if encoder == "fastpng"
                        else False)
    rng = np.random.default_rng(n_colours)
    img = np.full((37, 53, 3), 255, np.uint8)
    pal = rng.integers(0, 256, (n_colours, 3)).astype(np.uint8)
    img[5:35] = pal[rng.integers(0, n_colours, (30, 53))]
    ln, co, cnt = (transfer.host_array(a)[0] for a in rle.pack_batch_rle2(
        torch.from_numpy(img)[None], 4000))
    ov = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    alpha = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    alpha[:10] = 0
    p, po = str(tmp_path / "a.png"), str(tmp_path / "o.png")
    png.write_png_rle(p, ln, co, int(cnt), 37, 53)
    png.write_png_rle(po, ln, co, int(cnt), 37, 53, overlay=(ov, alpha))
    with open(p, "rb") as f:
        ctype = f.read()[25]
    assert ctype == (3 if encoder == "fastpng" and n_colours < 256 else 2)
    assert np.array_equal(read_png(p), img)
    want = apply_overlay_u8(*(torch.from_numpy(a) for a in (img, ov, alpha)))
    assert np.array_equal(read_png(po), want.numpy())
    with pytest.raises(OverflowError):
        png.write_png_rle(p, ln[:5], co[:5], int(cnt), 37, 53)
