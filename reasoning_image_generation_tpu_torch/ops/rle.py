# rle.py — lossless run-length codecs for the device-to-host copy.
"""The JAX package's ops/rle.py on torch tensors, batched over frames.

Rendered canvases are long horizontal runs of one colour, so a frame
packed into runs on the device crosses to the host in a few per cent of
its raw bytes.  Every encoder here works on a whole batch of frames at
once (``[F, ...]``, no Python loop over frames) and gives, array for
array, what the JAX package's encoder gives on the same frames:

- v1 ``pack_batch_rle``: (starts, colours as packed RGB, count);
- v2 ``pack_batch_rle2``: (u16 lengths with a forced break every
  ``U16_RUN`` pixels, u8 RGB, count), and ``pack_batch_rle2_delta``, where
  pixels equal to a base frame carry a 25-bit sentinel and collapse into
  copy runs;
- v3/v4/v5 ``compact_rle3/4/5`` (and their ``d`` delta forms): all frames'
  live runs compacted into one stream, a per-frame palette of the 255 most
  frequent colours with escapes for the rest, and three wire formats for
  the lengths (u16; u8 with a u16 extension stream; a length-1 bitmask).

Each JAX ``.at[tgt].set(..., mode="drop")`` is a scatter into a buffer one
slot longer than the output, the last slot cut off: every target that is
kept is unique (a run's slot, a unique colour's slot, a frame's offset plus
its slot), and only the dump slot receives duplicates, so the card and
the CPU give the same bytes.

Wire dtypes: torch has few kernels for uint16 and uint32, so u16 arrays
travel as int16 tensors with the same bits (``io/transfer.host_array``
views them as numpy uint16), and v1's u32 starts and colours as int32
(their values are below 2**31).  Arithmetic is in int32 and int64.

The host side (numpy) is the JAX package's, copied: ``rle3_offsets``,
``Rle3Frames``, ``unpack_frame_rle`` and ``unpack_frame_rle2``.  A frame
with more runs than its budget, or whose slice a shrunk transfer cut,
raises OverflowError on decode; callers fetch it raw.
"""
from __future__ import annotations

import numpy as np
import torch

U16_RUN = 65535
PAL_K = 255          # palette entries per frame; index 255 = escape marker
ESC_MARK = 255
COPY_MARK = 254      # delta streams: copy-from-base runs
DELTA_SENT = 0x1000000      # bit 24: outside every packed RGB
PAL_SENTINEL = 0xFFFFFFFF   # sorts past every 24-bit colour


def default_budget(H: int, W: int) -> int:
    """Runs a frame may hold on the device (H*W/24, at least 1024)."""
    return max(1024, (H * W) // 24)


def default_grid_budget(H: int, W: int) -> int:
    """Runs a composed grid may hold (H*W/9, at least 2048): grids are
    denser (resized cells, labels, borders)."""
    return max(2048, (H * W) // 9)


# ---- device helpers -------------------------------------------------------

def _frames(imgs: torch.Tensor):
    """u8 ``[..., H, W, 3]`` -> (``[F, H, W, 3]``, leading shape)."""
    return imgs.reshape((-1,) + tuple(imgs.shape[-3:])), tuple(imgs.shape[:-3])


def _pack24(fr: torch.Tensor) -> torch.Tensor:
    """u8 ``[F, H, W, 3]`` (or ``[F, n, 3]``) -> packed RGB int32 ``[F, n]``."""
    x = fr.reshape(fr.shape[0], -1, 3).to(torch.int32)
    return (x[..., 0] << 16) | (x[..., 1] << 8) | x[..., 2]


def _split24(col: torch.Tensor) -> torch.Tensor:
    """Packed RGB (any integer dtype) ``[...]`` -> u8 ``[..., 3]``."""
    return torch.stack([(col >> 16) & 0xFF, (col >> 8) & 0xFF, col & 0xFF],
                       -1).to(torch.uint8)


def _u16(x: torch.Tensor) -> torch.Tensor:
    """Values 0..65535 -> int16 with the same 16 bits (the u16 wire)."""
    return torch.where(x > 32767, x - 65536, x).to(torch.int16)


def _first_diff(v: torch.Tensor) -> torch.Tensor:
    """bool ``[F, n]``: True where v differs from its left neighbour, and at
    every frame's first element."""
    b = torch.ones(v.shape, dtype=torch.bool, device=v.device)
    b[:, 1:] = v[:, 1:] != v[:, :-1]
    return b


def _targets(mask: torch.Tensor, cap: int):
    """Slots of the True entries of each row, counted from 0 (cumsum), and
    the scatter targets: the slot where it is below `cap`, else the dump
    slot `cap`.  -> (pos int32 ``[F, n]``, count int32 ``[F]``, targets
    int64 ``[F, n]``)."""
    pos = torch.cumsum(mask, 1, dtype=torch.int32) - 1
    count = pos[:, -1] + 1
    tgt = torch.where(mask & (pos < cap), pos, cap).long()
    return pos, count, tgt


def _scatter(tgt: torch.Tensor, src: torch.Tensor, cap: int, fill=0):
    """Row-wise scatter of src ``[F, n, ...]`` to slots tgt ``[F, n]`` of a
    ``[F, cap, ...]`` buffer filled with `fill`; targets equal to `cap`
    land in a dump slot that is cut off (the JAX ``mode="drop"``)."""
    F = src.shape[0]
    out = torch.full((F, cap + 1) + tuple(src.shape[2:]), fill,
                     dtype=src.dtype, device=src.device)
    idx = tgt.reshape(tgt.shape + (1,) * (src.dim() - 2)).expand(src.shape)
    out.scatter_(1, idx, src)
    return out[:, :cap]


def _compact(values: torch.Tensor, counts: torch.Tensor, cap_out: int):
    """Frame f's first counts[f] slots of values ``[F, cap, ...]`` into one
    stream ``[cap_out, ...]`` at the exclusive cumsum of the counts."""
    F, cap = values.shape[:2]
    counts = counts.long()
    off = torch.cumsum(counts, 0) - counts
    slot = torch.arange(cap, device=values.device)[None, :]
    t = off[:, None] + slot
    tgt = torch.where((slot < counts[:, None]) & (t < cap_out), t, cap_out)
    out = torch.zeros((cap_out + 1,) + tuple(values.shape[2:]),
                      dtype=values.dtype, device=values.device)
    out[tgt.reshape(-1)] = values.reshape((F * cap,) + tuple(values.shape[2:]))
    return out[:cap_out]


def _in_frame(mask: torch.Tensor, values: torch.Tensor, cap: int):
    """The entries of values ``[F, cap, ...]`` where mask ``[F, cap]`` is
    set, moved to the front of each frame in order -> (``[F, cap, ...]``,
    counts int32 ``[F]``)."""
    _pos, n, tgt = _targets(mask, cap)
    return _scatter(tgt, values, cap), n


# ---- v1 and v2 ------------------------------------------------------------

def pack_batch_rle(imgs: torch.Tensor, max_runs: int):
    """u8 ``[..., H, W, 3]`` -> (starts ``[..., max_runs]``, packed colours
    ``[..., max_runs]``, count int32 ``[...]``); starts and colours are
    u32 in the JAX package and int32 here, with the same values."""
    fr, lead = _frames(imgs)
    F, n = fr.shape[0], fr.shape[1] * fr.shape[2]
    flat = _pack24(fr)
    _pos, count, tgt = _targets(_first_diff(flat), max_runs)
    idx = torch.arange(n, dtype=torch.int32, device=fr.device).expand(F, n)
    starts = _scatter(tgt, idx, max_runs)
    colors = _scatter(tgt, flat, max_runs)
    return (starts.reshape(lead + (max_runs,)),
            colors.reshape(lead + (max_runs,)), count.reshape(lead))


def _rle2_encode_values(val: torch.Tensor, max_runs: int):
    """Runs of a value stream int32 ``[F, n]``, broken at least every
    U16_RUN pixels -> (lengths int32 ``[F, max_runs]``, values int32
    ``[F, max_runs]``, count int32 ``[F]``).  count is the true run count,
    also where it exceeds max_runs."""
    F, n = val.shape
    idx = torch.arange(n, dtype=torch.int32, device=val.device)
    boundary = _first_diff(val) | (idx % U16_RUN == 0)[None, :]
    _pos, count, tgt = _targets(boundary, max_runs)
    starts = _scatter(tgt, idx.expand(F, n), max_runs)
    values = _scatter(tgt, val, max_runs)
    # a run's length is the next start minus its own; the slot after the
    # last live run holds 0, so the last run ends at n by the count test
    slot = torch.arange(max_runs, dtype=torch.int32, device=val.device)
    nxt = torch.cat([starts[:, 1:], starts.new_zeros((F, 1))], 1)
    nxt = torch.where(slot[None, :] == count[:, None] - 1, n, nxt)
    lengths = torch.where(slot[None, :] < count[:, None], nxt - starts, 0)
    return lengths.clamp(0, U16_RUN), values, count


def pack_batch_rle2(imgs: torch.Tensor, max_runs: int):
    """u8 ``[..., H, W, 3]`` -> (u16 lengths ``[..., max_runs]`` as int16,
    u8 colours ``[..., max_runs, 3]``, count int32 ``[...]``)."""
    fr, lead = _frames(imgs)
    lengths, colors, count = _rle2_encode_values(_pack24(fr), max_runs)
    return (_u16(lengths).reshape(lead + (max_runs,)),
            _split24(colors).reshape(lead + (max_runs, 3)),
            count.reshape(lead))


def pack_batch_rle2_delta(imgs: torch.Tensor, bases: torch.Tensor,
                          max_runs: int):
    """Delta runs of frames against same-shaped bases -> (lengths, colours,
    copy bool ``[..., max_runs]``, count).  Pixels equal to the base (all
    three channels) become the sentinel, so unchanged spans are single
    copy runs; their colour bytes mean nothing.  A keyframe passes a base
    no pixel can equal (255 - img: x == 255 - x has no u8 solution)."""
    fr, lead = _frames(imgs)
    bf = bases.expand(imgs.shape).reshape(fr.shape)
    flat = _pack24(fr)
    val = torch.where(flat == _pack24(bf), DELTA_SENT, flat)
    lengths, colors, count = _rle2_encode_values(val, max_runs)
    slot = torch.arange(max_runs, device=imgs.device)
    copy = (colors == DELTA_SENT) & (slot[None, :] < count[:, None])
    return (_u16(lengths).reshape(lead + (max_runs,)),
            _split24(colors).reshape(lead + (max_runs, 3)),
            copy.reshape(lead + (max_runs,)), count.reshape(lead))


# one frame u8 [H, W, 3]: the encoders above take any leading shape, none
# included (the JAX package's per-frame functions)
pack_frame_rle = pack_batch_rle
pack_frame_rle2 = pack_batch_rle2
pack_frame_rle2_delta = pack_batch_rle2_delta


# ---- v3, v4, v5: batch-compacted palette codecs ---------------------------

def palettize_esc(rgb: torch.Tensor, count: torch.Tensor,
                  copy: torch.Tensor | None = None, k: int = PAL_K):
    """Per-frame palettes of the k most frequent run colours.

    (rgb u8 ``[F, cap, 3]``, count ``[F]``[, copy bool ``[F, cap]``]) ->
    (pal u8 ``[F, 255, 3]``, nc int32 ``[F]``, idx u8 ``[F, cap]``,
    esc_mask bool ``[F, cap]``).  The live colours are sorted, each
    unique's multiplicity measured, the k largest taken (ties to the
    smaller colour, as ``lax.top_k`` takes the lower index: the key
    ``mult * cap + (cap - 1 - slot)`` is unique per slot) and sorted by
    value.  nc is the true distinct count (may exceed k); runs outside the
    palette get ESC_MARK and esc_mask.  With `copy` (delta streams,
    k = COPY_MARK) copy runs are left out of palette and escapes and carry
    COPY_MARK; the palette keeps 255 rows, the tail sentinel-padded."""
    F, cap = rgb.shape[:2]
    dev = rgb.device
    x = rgb.to(torch.int64)
    col = (x[..., 0] << 16) | (x[..., 1] << 8) | x[..., 2]
    slot = torch.arange(cap, device=dev)
    live = slot[None, :] < count[:, None]
    pal_ok = live if copy is None else live & ~copy
    s = torch.sort(torch.where(pal_ok, col, PAL_SENTINEL), 1).values
    uniq = _first_diff(s) & (s != PAL_SENTINEL)
    pos, _n, tgt = _targets(uniq, cap)
    nc = torch.where(uniq.any(1), pos[:, -1] + 1, 0)
    # unique colours and their first sorted position into [cap] slots; dead
    # slots keep the sentinel, so unchosen picks sort to the palette's end
    u_col = _scatter(tgt, s, cap, PAL_SENTINEL)
    u_start = _scatter(tgt, slot.expand(F, cap), cap)
    nxt = torch.cat([u_start[:, 1:], u_start.new_zeros((F, 1))], 1)
    n_live = pal_ok.sum(1)
    nxt = torch.where(slot[None, :] == (nc - 1)[:, None], n_live[:, None], nxt)
    mult = torch.where(slot[None, :] < nc[:, None], nxt - u_start, 0)
    topi = torch.topk(mult * cap + (cap - 1 - slot), k, dim=1).indices
    pal32 = torch.sort(torch.gather(u_col, 1, topi), 1).values
    ar = torch.arange(k, device=dev)
    pal32 = torch.where(ar[None, :] < torch.clamp(nc, max=k)[:, None], pal32,
                        PAL_SENTINEL)
    if k < PAL_K:
        pal32 = torch.cat([pal32, pal32.new_full((F, PAL_K - k),
                                                 PAL_SENTINEL)], 1)
    j = torch.searchsorted(pal32, col)
    jc = torch.clamp(j, max=PAL_K - 1)
    # a real colour never equals the sentinel, so hits land in [0, k)
    hit = (j < PAL_K) & (torch.gather(pal32, 1, jc) == col)
    idx = torch.where(hit, jc, ESC_MARK).to(torch.uint8)
    esc_mask = live & ~hit
    if copy is not None:
        idx = torch.where(copy, torch.full_like(idx, COPY_MARK), idx)
        esc_mask = esc_mask & ~copy
    return _split24(pal32), nc.to(torch.int32), idx, esc_mask


def palettize_frame_esc(rgb: torch.Tensor, count, copy=None, k: int = PAL_K):
    """``palettize_esc`` of one frame: (rgb u8 ``[cap, 3]``, count[, copy
    bool ``[cap]``]) -> (pal u8 ``[255, 3]``, nc int32, idx u8 ``[cap]``,
    esc_mask bool ``[cap]``)."""
    count = torch.as_tensor(count, device=rgb.device).reshape(1)
    out = palettize_esc(rgb[None], count, None if copy is None else copy[None],
                        k)
    return tuple(a[0] for a in out)


def _compact_rle3_impl(lengths, rgb, count, copy, k: int, ln_mode: str = "u16"):
    lead = tuple(count.shape)
    cap = lengths.shape[-1]
    ln = (lengths.reshape(-1, cap).to(torch.int32) & 0xFFFF)
    co = rgb.reshape(-1, cap, 3)
    cnt = count.reshape(-1).to(torch.int32)
    F = ln.shape[0]
    pal, nc, idx, esc_mask = palettize_esc(
        co, cnt, None if copy is None else copy.reshape(-1, cap), k)
    c = torch.clamp(cnt, max=cap)              # runs past cap never packed
    IDX = _compact(idx, c, F * cap)
    # escapes compact twice: within the frame, in run order, then across
    # frames
    esc_f, ec = _in_frame(esc_mask, co, cap)
    ESC = _compact(esc_f, ec, F * cap)
    nck = torch.clamp(nc, max=k)
    PAL = _compact(pal, nck, F * PAL_K)
    tail = (cnt.reshape(lead), nc.reshape(lead), ec.reshape(lead))
    if ln_mode == "u16":
        LN = _u16(_compact(ln, c, F * cap))
        return (LN, IDX, PAL, ESC) + tail
    # v4: u8 lengths; runs over 255 ship 0 and their u16 length rides a
    # per-frame extension stream, compacted like the escapes
    big = ln > 255                             # dead slots are 0, never big
    lnx_f, xc = _in_frame(big, ln, cap)
    LNX = _u16(_compact(lnx_f, xc, F * cap))
    ln8 = torch.where(big, 0, ln).to(torch.uint8)
    if ln_mode == "u8":
        LN8 = _compact(ln8, c, F * cap)
        return (LN8, IDX, PAL, ESC, LNX) + tail + (xc.reshape(lead),)
    # v5 ("bm1"): one bit per live run, set where its length is 1 (little
    # bit order, byte-aligned per frame); only the other runs ship a length
    # byte, in run order (0 still marks an LNX-extended run)
    assert ln_mode == "bm1", ln_mode
    slot = torch.arange(cap, device=ln.device)
    live = slot[None, :] < c[:, None]
    one = live & (ln == 1)
    capp = -(-cap // 8) * 8
    one_p = torch.zeros((F, capp), dtype=torch.int32, device=ln.device)
    one_p[:, :cap] = one
    weights = 1 << torch.arange(8, dtype=torch.int32, device=ln.device)
    bm_f = (one_p.reshape(F, capp // 8, 8) * weights).sum(-1).to(torch.uint8)
    bc = (c + 7) // 8                          # live bitmask bytes a frame
    BM = _compact(bm_f, bc, F * (capp // 8))
    ln8s_f, sc = _in_frame(live & (ln != 1), ln8, cap)
    LNS = _compact(ln8s_f, sc, F * cap)
    return ((BM, LNS, IDX, PAL, ESC, LNX) + tail
            + (xc.reshape(lead), sc.reshape(lead)))


def compact_rle3(lengths, rgb, count):
    """Per-frame rle2 streams -> (LN u16 ``[F*cap]``, IDX u8 ``[F*cap]``,
    PAL u8 ``[F*255, 3]``, ESC u8 ``[F*cap, 3]``, cnt, nc, ec)."""
    return _compact_rle3_impl(lengths, rgb, count, None, PAL_K)


def compact_rle3d(lengths, rgb, copy, count):
    """Delta rle2 streams -> the rle3 tuple; copy runs carry COPY_MARK and
    palettes hold at most 254 entries (``Rle3Frames(..., delta=True)``)."""
    return _compact_rle3_impl(lengths, rgb, count, copy, COPY_MARK)


def compact_rle4(lengths, rgb, count):
    """rle3 with u8 lengths -> (LN8, IDX, PAL, ESC, LNX u16, cnt, nc, ec,
    xc)."""
    return _compact_rle3_impl(lengths, rgb, count, None, PAL_K, "u8")


def compact_rle4d(lengths, rgb, copy, count):
    return _compact_rle3_impl(lengths, rgb, count, copy, COPY_MARK, "u8")


def compact_rle5(lengths, rgb, count):
    """rle4 with a length-1 bitmask -> (BM, LNS, IDX, PAL, ESC, LNX, cnt,
    nc, ec, xc, sc)."""
    return _compact_rle3_impl(lengths, rgb, count, None, PAL_K, "bm1")


def compact_rle5d(lengths, rgb, copy, count):
    return _compact_rle3_impl(lengths, rgb, count, copy, COPY_MARK, "bm1")


def pack_batch_rle3(imgs, max_runs: int):
    return compact_rle3(*pack_batch_rle2(imgs, max_runs))


def pack_batch_rle4(imgs, max_runs: int):
    return compact_rle4(*pack_batch_rle2(imgs, max_runs))


def pack_batch_rle5(imgs, max_runs: int):
    return compact_rle5(*pack_batch_rle2(imgs, max_runs))


# ---- host side (numpy), as in the JAX package -----------------------------

def unpack_frame_rle(starts: np.ndarray, colors: np.ndarray, count: int,
                     shape) -> np.ndarray:
    """Exact reconstruction of a v1 frame; OverflowError when the frame had
    more runs than its budget."""
    H, W = shape[:2]
    n = H * W
    if count > starts.shape[0]:
        raise OverflowError(f"rle frame overflow: {count} > {starts.shape[0]}")
    s = np.asarray(starts[:count], np.int64)
    lengths = np.diff(np.append(s, n))
    flat = np.repeat(np.asarray(colors[:count], np.uint32), lengths)
    img = np.empty((n, 3), np.uint8)
    img[:, 0] = (flat >> 16) & 0xFF
    img[:, 1] = (flat >> 8) & 0xFF
    img[:, 2] = flat & 0xFF
    return img.reshape(H, W, 3)


def unpack_frame_rle2(lengths: np.ndarray, colors: np.ndarray, count: int,
                      shape) -> np.ndarray:
    """Exact reconstruction of a v2 frame; OverflowError when it had more
    runs than its budget or its lengths do not sum to the frame."""
    H, W = shape[:2]
    n = H * W
    if count > lengths.shape[0]:
        raise OverflowError(
            f"rle2 frame overflow: {count} > {lengths.shape[0]}")
    ln = np.asarray(lengths[:count], np.int64)
    total = int(ln.sum())
    if total != n:
        raise OverflowError(f"rle2 length sum {total} != {n}")
    return np.repeat(np.asarray(colors[:count], np.uint8), ln,
                     axis=0).reshape(H, W, 3)


def rle3_offsets(cnt: np.ndarray, nc: np.ndarray, ec: np.ndarray, cap: int,
                 pal_k: int = PAL_K):
    """Per-frame stream offsets (exclusive cumsums, flat frame order), as
    the compaction placed them."""
    c = np.minimum(np.asarray(cnt, np.int64).reshape(-1), cap)
    nck = np.minimum(np.asarray(nc, np.int64).reshape(-1), pal_k)
    e = np.asarray(ec, np.int64).reshape(-1)
    return (np.cumsum(c) - c, np.cumsum(nck) - nck, np.cumsum(e) - e)


class Rle3Frames:
    """Host view over one tensor's compacted rle3/4/5 transfer (7-, 9- or
    11-tuple).  ``frame(i)`` -> (lengths u16, rgb u8) of frame i, plus the
    per-run copy mask for delta streams; OverflowError when the frame
    exceeded its run budget or a shrunk transfer cut its slice.
    ``overflow_indices(n)`` lists those frames up front, so their raw
    fetches go in one gather."""

    def __init__(self, packed, cap: int, delta: bool = False):
        self.BM = self.LNS = self.sc = None
        if len(packed) == 11:
            BM, LNS, IDX, PAL, ESC, LNX, cnt, nc, ec, xc, sc = packed
            self.BM = np.asarray(BM)
            self.LNS = np.asarray(LNS)
            self.sc = np.asarray(sc).reshape(-1)
            self.LN = None
            self.LNX = np.asarray(LNX)
            self.xc = np.asarray(xc).reshape(-1)
        elif len(packed) == 9:
            LN, IDX, PAL, ESC, LNX, cnt, nc, ec, xc = packed
            self.LN = np.asarray(LN)
            self.LNX = np.asarray(LNX)
            self.xc = np.asarray(xc).reshape(-1)
        else:
            LN, IDX, PAL, ESC, cnt, nc, ec = packed
            self.LN = np.asarray(LN)
            self.LNX = None
            self.xc = None
        self.IDX = np.asarray(IDX)
        self.PAL = np.asarray(PAL)
        self.ESC = np.asarray(ESC)
        self.cnt = np.asarray(cnt).reshape(-1)
        self.nc = np.asarray(nc).reshape(-1)
        self.ec = np.asarray(ec).reshape(-1)
        self.cap = cap
        self.delta = delta
        self.pal_k = COPY_MARK if delta else PAL_K
        self.off, self.poff, self.eoff = rle3_offsets(
            self.cnt, self.nc, self.ec, cap, self.pal_k)
        if self.xc is not None:
            x = np.asarray(self.xc, np.int64)
            self.xoff = np.cumsum(x) - x
        else:
            self.xoff = None
        if self.BM is not None:
            c = np.minimum(np.asarray(self.cnt, np.int64), cap)
            bc = (c + 7) // 8
            self.bmoff = np.cumsum(bc) - bc
            s = np.asarray(self.sc, np.int64)
            self.soff = np.cumsum(s) - s

    def _bad(self, i: int) -> bool:
        # empty slices never overflow: one frame that overruns a shrunk
        # stream must not flag the later frames that take nothing from it
        c, e = int(self.cnt[i]), int(self.ec[i])
        nck = min(int(self.nc[i]), self.pal_k)
        if self.xc is not None:
            x = int(self.xc[i])
            if x > 0 and self.xoff[i] + x > self.LNX.shape[0]:
                return True
        if self.BM is not None:
            bc = (c + 7) // 8
            s = int(self.sc[i])
            if bc > 0 and self.bmoff[i] + bc > self.BM.shape[0]:
                return True
            if s > 0 and self.soff[i] + s > self.LNS.shape[0]:
                return True
        run_stream = self.IDX if self.LN is None else self.LN
        return (c > self.cap
                or (c > 0 and self.off[i] + c > run_stream.shape[0])
                or (e > 0 and self.eoff[i] + e > self.ESC.shape[0])
                or (nck > 0 and self.poff[i] + nck > self.PAL.shape[0]))

    def overflow_indices(self, n_frames: int) -> np.ndarray:
        return np.asarray([i for i in range(n_frames) if self._bad(i)],
                          np.int64)

    def overflow_reasons(self, n_frames: int) -> dict:
        """Overflowed frames by the stream that cut them ('T' runs, 'E'
        escapes, 'P' palette, 'X' extensions, 'B' bitmask, 'S' lengths; a
        frame can count in several)."""
        out = {"T": 0, "E": 0, "P": 0, "X": 0, "B": 0, "S": 0}
        run_stream = self.IDX if self.LN is None else self.LN
        for i in range(n_frames):
            if not self._bad(i):
                continue
            c, e = int(self.cnt[i]), int(self.ec[i])
            nck = min(int(self.nc[i]), self.pal_k)
            if c > self.cap or (c > 0
                                and self.off[i] + c > run_stream.shape[0]):
                out["T"] += 1
            if e > 0 and self.eoff[i] + e > self.ESC.shape[0]:
                out["E"] += 1
            if nck > 0 and self.poff[i] + nck > self.PAL.shape[0]:
                out["P"] += 1
            if (self.xc is not None and int(self.xc[i]) > 0
                    and self.xoff[i] + int(self.xc[i]) > self.LNX.shape[0]):
                out["X"] += 1
            if self.BM is not None:
                bc = (c + 7) // 8
                if bc > 0 and self.bmoff[i] + bc > self.BM.shape[0]:
                    out["B"] += 1
                s = int(self.sc[i])
                if s > 0 and self.soff[i] + s > self.LNS.shape[0]:
                    out["S"] += 1
        return {k: v for k, v in out.items() if v}

    def frame(self, i: int):
        """(lengths, rgb) of frame i; delta streams also return the per-run
        copy mask."""
        if self._bad(i):
            raise OverflowError(f"rle3 frame {i} overflowed")
        c, e = int(self.cnt[i]), int(self.ec[i])
        nck = min(int(self.nc[i]), self.pal_k)
        o = int(self.off[i])
        if self.BM is not None:
            # v5: lengths from the length-1 bitmask and the != 1 stream
            bc = (c + 7) // 8
            bo = int(self.bmoff[i])
            bits = np.unpackbits(self.BM[bo:bo + bc],
                                 bitorder="little")[:c].astype(bool)
            s = int(self.sc[i])
            if int((~bits).sum()) != s:
                raise OverflowError(
                    f"rle5 frame {i}: non-one count mismatch")
            so = int(self.soff[i])
            ln8s = self.LNS[so:so + s]
            ln_no = ln8s.astype(np.uint16)
            ext = ln8s == 0
            x = int(self.xc[i])
            if int(ext.sum()) != x:
                raise OverflowError(
                    f"rle5 frame {i}: extension count mismatch")
            if x:
                xo = int(self.xoff[i])
                ln_no[ext] = self.LNX[xo:xo + x]
            ln = np.ones(c, np.uint16)
            ln[~bits] = ln_no
        else:
            ln = self.LN[o:o + c]
            if self.LNX is not None:
                # v4: extended lengths over the u8 stream's 0 markers
                ln8 = ln
                ln = ln8.astype(np.uint16)
                ext = ln8 == 0
                x = int(self.xc[i])
                if int(ext.sum()) != x:
                    raise OverflowError(
                        f"rle4 frame {i}: extension count mismatch")
                if x:
                    xo = int(self.xoff[i])
                    ln[ext] = self.LNX[xo:xo + x]
        ix = self.IDX[o:o + c].astype(np.int64)
        pal = self.PAL[int(self.poff[i]):int(self.poff[i]) + nck]
        if nck:
            rgb = pal[np.minimum(ix, nck - 1)]
        else:
            # no palette at all: every run is a copy (a delta frame equal to
            # its base) or an escape
            rgb = np.zeros((c, 3), np.uint8)
        m = ix == ESC_MARK
        if int(m.sum()) != e:
            raise OverflowError(f"rle3 frame {i}: escape count mismatch")
        if e:
            eo = int(self.eoff[i])
            rgb = rgb.copy()
            rgb[m] = self.ESC[eo:eo + e]
        if self.delta:
            return (np.ascontiguousarray(ln), np.ascontiguousarray(rgb),
                    ix == COPY_MARK)
        return np.ascontiguousarray(ln), np.ascontiguousarray(rgb)

    def unpack(self, i: int, shape) -> np.ndarray:
        if self.delta:
            raise ValueError("delta stream: use unpack_delta(i, base, ...)")
        ln, rgb = self.frame(i)
        return unpack_frame_rle2(ln, rgb, ln.shape[0], shape)

    def unpack_delta(self, i: int, base: np.ndarray, shape) -> np.ndarray:
        """Frame i of a delta stream against `base`, the previous frame's
        pixels (anything of that shape for a keyframe, which has no copy
        runs)."""
        ln, rgb, copy = self.frame(i)
        H, W = shape[:2]
        n = H * W
        l64 = np.asarray(ln, np.int64)
        if int(l64.sum()) != n:
            raise OverflowError(f"rle3d frame {i} length sum != {n}")
        flat = np.repeat(rgb, l64, axis=0)
        if copy.any():
            px_copy = np.repeat(copy, l64)
            bflat = np.asarray(base, np.uint8).reshape(n, 3)
            flat[px_copy] = bflat[px_copy]
        return flat.reshape(H, W, 3)

    def nbytes_shipped(self) -> int:
        n = (self.IDX.nbytes + self.PAL.nbytes + self.ESC.nbytes
             + self.cnt.nbytes + self.nc.nbytes + self.ec.nbytes)
        if self.LN is not None:
            n += self.LN.nbytes
        if self.BM is not None:
            n += self.BM.nbytes + self.LNS.nbytes + self.sc.nbytes
        if self.LNX is not None:
            n += self.LNX.nbytes + self.xc.nbytes
        return n
