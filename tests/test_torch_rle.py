# test_torch_rle.py — the port's run-length codecs against the JAX package's.
"""ops/rle.py of the port against the JAX package's, on the CPU.

The same u8 frames go through both: frames the port's own pipeline renders
at 128x128 (the states, the options with their delta bases, the grids
before their overlay), and hand-built frames with more than 255 colours
(escapes), runs longer than 255 (extension stream), one colour only, a tie
at the 255th palette entry, a frame equal to its base (a delta frame of
copy runs only, no palette), a budget small enough to overflow, and one
white 512x512 frame (runs longer than 65535, broken every U16_RUN).
Every output array must be equal element for element: u16 arrays read
through ``io/transfer.host_array`` (int16 on the wire) and v1's u32 arrays
as the int32 they travel as.  The host decode (``Rle3Frames``) must give
back the original frames, or flag exactly the frames over budget.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu.ops import rle as jax_rle
from reasoning_image_generation_tpu_torch.io.transfer import host_array
from reasoning_image_generation_tpu_torch.models.rpm.pipeline import (
    LeafPipeline, sample_keys)
from reasoning_image_generation_tpu_torch.ops import rle
from reasoning_image_generation_tpu_torch.ops.compose import compose_grid

from .test_torch_pipeline import small_cfg

torch.set_num_threads(1)

HS = 64     # hand-built frames are HS x HS


def tie_colours() -> np.ndarray:
    """256 distinct colours, none of them white: u8 [256, 3]."""
    c = np.arange(1, 257)
    return np.stack([c % 7 * 30, c // 7 * 6, 255 - c], -1).astype(np.uint8)


def hand_frames() -> np.ndarray:
    """u8 [6, HS, HS, 3]: escapes, one colour, a palette tie at entry 255,
    long runs, a sparse scene, and the sparse scene again (the last is a
    delta frame of copy runs only against the one before)."""
    rng = np.random.default_rng(11)
    f = np.full((6, HS, HS, 3), 255, np.uint8)
    # 0: 600 colours in a noisy block: most runs escape the palette
    cols = rng.integers(0, 256, (600, 3)).astype(np.uint8)
    f[0, 10:50, 5:60] = cols[rng.integers(0, 600, (40, 55))]
    # 1: one colour only
    f[1] = (12, 34, 56)
    # 2: white, 253 colours in two runs each and 3 in one run each: the
    # 255th palette entry is a tie between those three
    rgb = tie_colours()
    runs = [rgb[i] for i in range(253) for _ in (0, 1)] + list(rgb[253:])
    flat = f[2].reshape(-1, 3)
    for i, col in enumerate(runs):
        flat[i * 3:i * 3 + 2] = col        # 2-pixel runs with white between
    # 3: bands of 5 rows (320-pixel runs) in 7 colours
    for y in range(0, HS, 5):
        f[3, y:y + 5] = rgb[y // 5 % 7]
    # 4: a few filled rectangles with a 1-pixel darker outline
    for _ in range(6):
        y, x = rng.integers(0, HS - 16, 2)
        col = rng.integers(0, 200, 3)
        f[4, y:y + 14, x:x + 12] = col // 2
        f[4, y + 1:y + 13, x + 1:x + 11] = col
    f[5] = f[4]
    return f


def delta_bases(frames: np.ndarray) -> np.ndarray:
    """Each frame's base: the frame before it, and 255 - itself for the
    first (a keyframe: no pixel equals its complement)."""
    base = np.concatenate([255 - frames[:1], frames[:-1]])
    return np.ascontiguousarray(base)


def rendered_sets() -> dict:
    """The port's frames at 128x128 for one 4-frame and one 6-frame leaf:
    name -> (frames [B, F, H, W, 3], delta bases)."""
    out = {}
    for leaf in ("平移", "直接叠加"):
        pipe = LeafPipeline(leaf, small_cfg())
        res = pipe(sample_keys(5, [3, 10]), torch.tensor([False, True]))
        s, o = res["state_imgs"], res["option_imgs"]
        L = pipe.L
        _g, pre = compose_grid(pipe.layout, s[:, :L - 1], o, return_pre=True)
        s_base = torch.cat([255 - s[:, :1], s[:, :-1]], 1)
        o_base = s[:, L - 1:L].expand(o.shape)
        out[f"{leaf} states"] = (s.numpy(), s_base.numpy())
        out[f"{leaf} options"] = (o.numpy(), o_base.contiguous().numpy())
        out[f"{leaf} grids"] = (pre.numpy(), 255 - pre.numpy())
    return out


_SETS = None


def frame_set(name: str):
    """-> (frames, bases, budget); built once per process."""
    global _SETS
    if _SETS is None:
        _SETS = {k: v + (rle.default_budget(*v[0].shape[-3:-1]),)
                 for k, v in rendered_sets().items()}
        hand = hand_frames()
        _SETS["hand"] = (hand, delta_bases(hand), HS * HS)
        _SETS["hand, budget 300"] = (hand, delta_bases(hand), 300)
        white = np.full((1, 512, 512, 3), 255, np.uint8)
        _SETS["white 512"] = (white, 255 - white, rle.default_budget(512, 512))
    return _SETS[name]


SET_NAMES = ["平移 states", "平移 options", "平移 grids", "直接叠加 states",
             "直接叠加 options", "直接叠加 grids", "hand", "hand, budget 300",
             "white 512"]


def assert_same(want, got, what: str):
    """Every array of a JAX output tuple equals the port's."""
    assert len(want) == len(got), what
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), host_array(g)
        if w.dtype == np.uint32:            # v1: u32 travels as int32
            g = g.view(np.uint32)
        assert w.dtype == g.dtype and w.shape == g.shape, (what, i, w.dtype,
                                                           g.dtype)
        assert np.array_equal(w, g), (what, i, int((w != g).sum()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", SET_NAMES)
def test_pack_batch_rle_v1(name):
    frames, _b, cap = frame_set(name)
    assert_same(jax_rle.pack_batch_rle(jnp.asarray(frames), cap),
                rle.pack_batch_rle(_t(frames), cap), name)


@pytest.mark.parametrize("name", SET_NAMES)
def test_pack_batch_rle2_and_delta(name):
    frames, bases, cap = frame_set(name)
    assert_same(jax_rle.pack_batch_rle2(jnp.asarray(frames), cap),
                rle.pack_batch_rle2(_t(frames), cap), name)
    assert_same(jax_rle.pack_batch_rle2_delta(jnp.asarray(frames),
                                              jnp.asarray(bases), cap),
                rle.pack_batch_rle2_delta(_t(frames), _t(bases), cap), name)


def _decode_all(packed, frames, bases, cap, delta):
    """Rle3Frames of the port's host arrays: each frame decodes to the
    original (a delta frame against its base), or is flagged as over
    budget exactly when it had more runs than `cap`.  -> the number of
    flagged frames."""
    host = tuple(host_array(a) for a in packed)
    fr = rle.Rle3Frames(host, cap, delta=delta)
    flat = frames.reshape((-1,) + frames.shape[-3:])
    flat_bases = np.broadcast_to(bases, frames.shape).reshape(flat.shape)
    over = set(fr.overflow_indices(len(flat)).tolist())
    assert over == {i for i in range(len(flat)) if int(fr.cnt[i]) > cap}
    for i, want in enumerate(flat):
        if i in over:
            continue
        got = (fr.unpack_delta(i, flat_bases[i], want.shape) if delta
               else fr.unpack(i, want.shape))
        assert np.array_equal(got, want), i
    return len(over)


@pytest.mark.parametrize("version", ["3", "4", "5"])
@pytest.mark.parametrize("name", SET_NAMES)
def test_compact_and_pack_rle345(name, version):
    """compact_rleN, compact_rleNd and pack_batch_rleN equal the JAX
    package's; the compacted streams decode to the frames."""
    frames, bases, cap = frame_set(name)
    jf, tf = jnp.asarray(frames), _t(frames)
    j2, t2 = jax_rle.pack_batch_rle2(jf, cap), rle.pack_batch_rle2(tf, cap)
    jd = jax_rle.pack_batch_rle2_delta(jf, jnp.asarray(bases), cap)
    td = rle.pack_batch_rle2_delta(tf, _t(bases), cap)
    plain = getattr(rle, f"compact_rle{version}")(*t2)
    delta = getattr(rle, f"compact_rle{version}d")(*td)
    assert_same(getattr(jax_rle, f"compact_rle{version}")(*j2), plain, name)
    assert_same(getattr(jax_rle, f"compact_rle{version}d")(*jd), delta, name)
    assert_same(getattr(jax_rle, f"pack_batch_rle{version}")(jf, cap),
                getattr(rle, f"pack_batch_rle{version}")(tf, cap), name)
    n_over = _decode_all(plain, frames, bases, cap, False)
    _decode_all(delta, frames, bases, cap, True)
    if name.startswith("hand"):
        assert (n_over > 0) == (name == "hand, budget 300")


def test_hand_frames_reach_every_case():
    """The hand-built frames do what they are for: escapes, a palette tie
    at entry 255, extension runs, a copy-only delta frame without a
    palette, forced breaks of the white 512x512 frame."""
    frames, bases, cap = frame_set("hand")
    ln, rgb, cnt = rle.pack_batch_rle2(_t(frames), cap)
    LN8, IDX, PAL, ESC, LNX, c, nc, ec, xc = rle.compact_rle4(ln, rgb, cnt)
    # escapes: the noisy frame's, and the two one-run colours of the tie
    assert int(nc[0]) > 255 and int(ec[0]) > 0
    assert host_array(ec)[1:].tolist() == [0, 2, 0, 0, 0]
    assert int(nc[1]) == 1 and int(cnt[1]) == 1
    assert int(nc[2]) == 257            # 256 colours and the white
    assert int(xc[3]) == len(range(0, HS, 5))    # every band over 255
    d = rle.compact_rle4d(*rle.pack_batch_rle2_delta(_t(frames), _t(bases),
                                                     cap))
    assert int(d[6][5]) == 0 and int(d[5][5]) == 1   # one copy run, nc 0
    # the tie: of the three one-run colours only the smallest packed one
    # made the palette (lax.top_k takes the lower index among equals)
    pal = host_array(PAL)
    poff = int(np.minimum(host_array(nc), 255)[:2].sum())
    in_pal = {tuple(x) for x in pal[poff:poff + 255].tolist()}
    ones = tie_colours()[253:].astype(np.int64)
    packed = (ones[:, 0] << 16) | (ones[:, 1] << 8) | ones[:, 2]
    assert [tuple(x) in in_pal for x in ones.tolist()] == \
        [bool(v == packed.min()) for v in packed]
    white, _b, wcap = frame_set("white 512")
    ln, _rgb, cnt = rle.pack_batch_rle2(_t(white), wcap)
    assert int(cnt[0]) == 5
    assert host_array(ln)[0, :5].tolist() == [65535] * 4 + [4]


@pytest.mark.parametrize("i", range(6))
def test_per_frame_entry_points(i):
    """pack_frame_rle, pack_frame_rle2, pack_frame_rle2_delta and
    palettize_frame_esc (plain and with the delta stream's copy runs) on
    one hand-built frame equal the JAX package's per-frame functions."""
    frames, bases, cap = frame_set("hand")
    f, b = frames[i], bases[i]
    jf, tf = jnp.asarray(f), _t(f)
    assert_same(jax_rle.pack_frame_rle(jf, cap),
                rle.pack_frame_rle(tf, cap), "rle")
    j2, t2 = jax_rle.pack_frame_rle2(jf, cap), rle.pack_frame_rle2(tf, cap)
    assert_same(j2, t2, "rle2")
    jd = jax_rle.pack_frame_rle2_delta(jf, jnp.asarray(b), cap)
    td = rle.pack_frame_rle2_delta(tf, _t(b), cap)
    assert_same(jd, td, "rle2 delta")
    assert_same(jax_rle.palettize_frame_esc(j2[1], j2[2]),
                rle.palettize_frame_esc(t2[1], t2[2]), "palette")
    assert_same(jax_rle.palettize_frame_esc(jd[1], jd[3], jd[2],
                                            k=jax_rle.COPY_MARK),
                rle.palettize_frame_esc(td[1], td[3], td[2],
                                        k=rle.COPY_MARK), "delta palette")
