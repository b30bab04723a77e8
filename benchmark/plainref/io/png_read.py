# png_read.py — minimal PNG reader for checking exported images.
"""Decodes the 8-bit RGB (colour type 2) and palette (colour type 3) PNGs
that ``reasoning_image_generation_tpu.io.png`` writes, with zlib and numpy
alone (the card's machine has no OpenCV or PIL)."""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    data = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, row = int(data[y, 0]), data[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = row
        elif ftype == 1:
            cur = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif ftype == 2:
            cur = (row + prev) % 256
        elif ftype in (3, 4):
            cur = np.zeros(stride, np.int64)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) // 2
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (row[x] + pred) % 256
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """PNG file -> u8 [H, W, 3] RGB."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, plte = 8, [], None
    w = h = ctype = None
    while pos < len(buf):
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(
                ">I", buf[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if depth != 8 or ctype not in (2, 3) or body[12] != 0:
                raise ValueError(f"{path}: unsupported PNG format")
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    bpp = 3 if ctype == 2 else 1
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if ctype == 3:
        return plte[px]
    return px.reshape(h, w, 3)
