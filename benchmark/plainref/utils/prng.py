# prng.py — threefry2x32 key streams, bit-compatible with jax.random.
"""The seven ``jax.random`` calls the RPM pipeline makes, as integer tensor
code on any torch device.

Matches jax's threefry2x32 implementation with
``jax_threefry_partitionable=True`` and 32-bit default types, so every
key, bit and draw equals what the JAX package computes for the same seed
and sample id.  That lets the port be held to the JAX package byte for
byte instead of by distribution.

Keys are int64 tensors ``[..., 2]`` holding the two uint32 words.  uint32
arithmetic runs in int64 with ``& 0xFFFFFFFF`` after every add and
multiply (``torch.uint32`` lacks most operators).  Leading key dims are
batch dims: every sampler returns ``[*key_batch, *shape]``, the explicit
form of ``jax.vmap`` over keys.
"""
from __future__ import annotations

import math

import torch

from ..device import upload

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) of the count pair (x0, x1) under key
    (k1, k2); all operands broadcast, values in [0, 2**32)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``."""
    # jax converts a Python seed to int32 when x64 is off, so the high
    # word is always 0
    return upload([0, int(seed) & M32], torch.int64, device)


def _key_words(keys, ndim_extra: int):
    k = keys.reshape(keys.shape[:-1] + (1,) * ndim_extra + (2,))
    return k[..., 0], k[..., 1]


def _iota(shape, device):
    n = math.prod(shape)
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; `data` is an int or an integer tensor that
    broadcasts against the key batch."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & M32
    k1, k2 = keys[..., 0], keys[..., 1]
    zero = torch.zeros_like(data)
    a, b = threefry2x32(k1, k2, zero, data)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` -> keys ``[..., num, 2]``."""
    k1, k2 = _key_words(keys, 1)
    cnt = _iota((num,), keys.device)
    a, b = threefry2x32(k1, k2, torch.zeros_like(cnt), cnt)
    return torch.stack([a, b], dim=-1)


def random_bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits per element -> int64 ``[..., *shape]``."""
    shape = tuple(shape)
    k1, k2 = _key_words(keys, len(shape))
    cnt = _iota(shape, keys.device) if shape else torch.zeros(
        (), dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(k1, k2, torch.zeros_like(cnt), cnt)
    return a ^ b


def _param(v, keys, dtype):
    """A bound: a scalar or a tensor that broadcasts against the draw
    ``[*key_batch, *shape]`` (a per-key bound with a non-scalar shape
    carries trailing singleton dims).  A Python scalar becomes a 0-d
    tensor filled on the keys' device: nothing is copied from the host."""
    if torch.is_tensor(v):
        return v.to(device=keys.device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=keys.device)


def uniform(keys: torch.Tensor, shape=(), minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32: the 23 mantissa bits of a float in
    [1, 2), minus one, scaled into [minval, maxval).  XLA's CPU backend
    contracts the scale-and-shift into one fused multiply-add; it runs here
    in float64 (the float32 product is exact there) and rounds once."""
    shape = tuple(shape)
    bits = random_bits(keys, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    mn = _param(minval, keys, torch.float32)
    mx = _param(maxval, keys, torch.float32)
    scaled = (floats.double() * (mx - mn).double() + mn.double()).float()
    return torch.maximum(mn, scaled)


def _mul32(a, b):
    """(a * b) mod 2**32 for a, b in [0, 2**32) without int64 overflow."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & M32


def _wrap_i32(x):
    return ((x + 2 ** 31) & M32) - 2 ** 31


def randint(keys: torch.Tensor, shape=(), minval=0, maxval=1):
    """``jax.random.randint`` with int32 bounds (int64 result tensor)."""
    shape = tuple(shape)
    sub = split(keys, 2)
    hi_bits = random_bits(sub[..., 0, :], shape)
    lo_bits = random_bits(sub[..., 1, :], shape)
    i32 = (-2 ** 31, 2 ** 31 - 1)
    mn = _param(minval, keys, torch.int64).clamp(*i32)
    mx = _param(maxval, keys, torch.int64).clamp(*i32)
    span = (mx - mn) & M32
    span = torch.where(mx <= mn, torch.ones_like(span), span)
    mult = (2 ** 16) % span
    mult = _mul32(mult, mult) % span
    off = (_mul32(hi_bits % span, mult) + lo_bits % span) & M32
    off = off % span
    return _wrap_i32(mn + off)


def bernoulli(keys: torch.Tensor, p: float = 0.5, shape=()):
    """``jax.random.bernoulli`` (mode 'low'): uniform < p."""
    return uniform(keys, shape) < _param(p, keys, torch.float32)


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: rounds of stable sorts by fresh
    32-bit keys (one round for n < ~1600)."""
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(M32))
    x = torch.arange(n, dtype=torch.int64, device=keys.device).expand(
        keys.shape[:-1] + (n,))
    for _ in range(rounds):
        ks = split(keys, 2)
        keys, sub = ks[..., 0, :], ks[..., 1, :]
        order = torch.argsort(random_bits(sub, (n,)), dim=-1, stable=True)
        x = torch.gather(x, -1, order)
    return x
