# png.py — RGB8 PNG writer: the C encoder in csrc/fastpng.c, or zlib.
"""``write_png`` encodes with ``csrc/fastpng.c`` (row filters and zlib in C,
with the GIL released, so the export threads encode in parallel).  The C
source is built at first use with the system C compiler into ``_build/``
by ``ops/cuda_build.py``.  Where no C compiler is found, or the build
fails, ``write_png`` falls back to ``encode_png_zlib``.  Either way it
logs the encoder it picked, once per process.  Both write the same pixels;
the bytes differ.

``write_png_rle`` and ``write_png_rle3`` write a frame straight from the
transfer codecs' run streams (ops/rle.py): the C encoder decodes the runs
itself, as an indexed-colour PNG where the frame has at most 256 colours,
and blends a static overlay with the device's integer formula.  Without
the C encoder they decode on the host and call ``write_png``.
"""
from __future__ import annotations

import ctypes
import logging
import os
import shutil
import struct
import threading
import zlib

import numpy as np

from ..ops import cuda_build

logger = logging.getLogger(__name__)

SOURCE = os.path.join(cuda_build.CSRC, "fastpng.c")

_lock = threading.Lock()
_encoder = None     # the fastpng library, or False for zlib, once picked


def encode_png_zlib(img: np.ndarray, level: int = 3) -> bytes:
    """Minimal RGB8 PNG encoder (filter 0 rows + one IDAT)."""
    img = np.ascontiguousarray(img, np.uint8)
    H, W = img.shape[:2]
    raw = np.empty((H, 1 + W * 3), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(H, W * 3)
    comp = zlib.compress(raw.tobytes(), level)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", comp) + chunk(b"IEND", b""))


def build() -> str:
    """Compile csrc/fastpng.c with the C compiler ($CC, default cc)."""
    cc = os.environ.get("CC", "cc")
    if shutil.which(cc) is None:
        raise RuntimeError(f"no C compiler {cc!r} on PATH")
    return cuda_build.build(SOURCE, [cc, "-O3", "-shared", "-fPIC"],
                            libs=["-lz"])


def encoder() -> str:
    """'fastpng' or 'zlib': the encoder write_png uses in this process."""
    global _encoder
    with _lock:
        if _encoder is None:
            try:
                p, i = ctypes.c_void_p, ctypes.c_int
                _encoder = cuda_build.load(build(), {
                    "fastpng_write": [ctypes.c_char_p, p, i, i, i],
                    "fastpng_write_rle": [ctypes.c_char_p, p, p, i, i, i, i],
                    "fastpng_write_rle_overlay": [
                        ctypes.c_char_p, p, p, i, i, i, p, p, i]})
                logger.info("PNG encoder: fastpng (csrc/fastpng.c)")
            except (RuntimeError, OSError) as e:
                _encoder = False
                logger.warning("PNG encoder: zlib (fastpng unavailable: %s)",
                               e)
    return "fastpng" if _encoder else "zlib"


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Write an RGB u8 ``[H, W, 3]`` image to `path` as PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png wants [H, W, 3] u8, got {img.shape}")
    if encoder() == "fastpng":
        h, w = img.shape[:2]
        rc = _encoder.fastpng_write(path.encode(), img.ctypes.data, h, w,
                                    level)
        if rc != 0:
            raise IOError(f"fastpng_write failed with code {rc} for {path}")
    else:
        with open(path, "wb") as f:
            f.write(encode_png_zlib(img))


def write_png_rle(path: str, lengths: np.ndarray, colors: np.ndarray,
                  count: int, h: int, w: int, overlay=None,
                  level: int = 1) -> None:
    """Write a PNG from a v2 run stream (u16 lengths ``[>= count]``, u8 RGB
    ``[>= count, 3]``); `overlay=(rgb u8 [h, w, 3], alpha u8 [h, w])` is
    blended after the decode as ops/compose.apply_overlay_u8 blends it.
    OverflowError for a truncated stream (callers fetch the frame raw)."""
    from ..ops.rle import unpack_frame_rle2
    if count > lengths.shape[0]:
        raise OverflowError(f"rle2 frame overflow: {count} > "
                            f"{lengths.shape[0]}")
    if encoder() == "fastpng":
        ln = np.ascontiguousarray(lengths[:count], np.uint16)
        co = np.ascontiguousarray(colors[:count], np.uint8)
        if overlay is not None:
            ov_rgb = np.ascontiguousarray(overlay[0], np.uint8)
            ov_a = np.ascontiguousarray(overlay[1], np.uint8)
            assert ov_rgb.shape == (h, w, 3) and ov_a.shape == (h, w)
            rc = _encoder.fastpng_write_rle_overlay(
                path.encode(), ln.ctypes.data, co.ctypes.data, int(count), h,
                w, ov_rgb.ctypes.data, ov_a.ctypes.data, level)
        else:
            rc = _encoder.fastpng_write_rle(path.encode(), ln.ctypes.data,
                                            co.ctypes.data, int(count), h, w,
                                            level)
        if rc == 0:
            return
        # e.g. lengths that do not sum to the frame: the decode re-checks
    img = unpack_frame_rle2(lengths, colors, int(count), (h, w))
    if overlay is not None:
        import torch
        from ..ops.compose import apply_overlay_u8
        img = apply_overlay_u8(*(torch.from_numpy(np.asarray(a)) for a in (
            img, overlay[0], overlay[1]))).numpy()
    write_png(path, img)


def write_png_rle3(path: str, frames, i: int, h: int, w: int,
                   overlay=None) -> None:
    """Write frame i of a compacted transfer (ops/rle.Rle3Frames): the
    palette and escape lookup runs here, in the export thread."""
    ln, rgb = frames.frame(i)
    write_png_rle(path, ln, rgb, int(ln.shape[0]), h, w, overlay=overlay)
