# prng_cuda.py — build, bind and launch the threefry key-stream kernel.
"""``fold_in``, ``split`` and ``random_bits`` of utils/prng.py on a card:
one launch of csrc/threefry.cu a call, where the integer tensor code runs
171 int64 elementwise kernels.  utils/prng.py calls them for CUDA keys and
keeps its integer code for every other device; nothing falls back: a CUDA
call either launches the kernel or raises.

The kernel reads the keys (and fold_in's data) in place through their
strides (``layout``), makes its counters itself and writes one new int64
tensor in the layout of the integer code's result.  It is built at first
use by ``ops/cuda_build.py`` and loaded with ctypes.  ``LAUNCHES`` counts
the launches the card ran, as ``raster_cuda.LAUNCHES`` does: a launch
captured into a CUDA graph counts at every replay (utils/graphs.py).
"""
from __future__ import annotations

import ctypes
import math
import numbers

import torch

from . import cuda_build

M32 = 0xFFFFFFFF
MAX_DIMS = 8          # batch dims the kernel takes (RIG_TF_MAX_DIMS)

LAUNCHES = 0

_Dims = ctypes.c_int64 * MAX_DIMS


class Batch(ctypes.Structure):
    """The kernel's by-value argument (``RigTfBatch``): the key batch's
    dims, the strides in int64 words of the keys' rows and of fold_in's
    data along each (0 where one broadcasts), and the stride between a
    key's two words."""
    _fields_ = [("ndim", ctypes.c_int64), ("size", _Dims), ("key", _Dims),
                ("data", _Dims), ("word", ctypes.c_int64)]


def build() -> str:
    """Compile csrc/threefry.cu (if this source hash is not built yet) and
    return the shared library's path."""
    return cuda_build.build_cuda("threefry.cu")


_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# the library's entry points and their argument types; each launches once
# and returns a cudaError
SIGNATURES = {"rig_threefry_fold_in": [_P, _P, _I64, Batch, _P, _P],
              "rig_threefry_split": [_P, Batch, _I64, _P, _P],
              "rig_threefry_random_bits": [_P, Batch, _I64, _P, _P]}


def layout(keys: torch.Tensor, shape, data=None) -> Batch:
    """The batch `shape` of a call on `keys` ``[..., 2]`` (and on fold_in's
    `data` tensor), both broadcast to it; nothing is copied."""
    shape = tuple(shape)
    n = len(shape)
    if n > MAX_DIMS:
        raise ValueError(f"the kernel takes at most {MAX_DIMS} batch dims, "
                         f"got {n}")
    ks = keys.expand(shape + (2,)).stride()
    ds = data.expand(shape).stride() if data is not None else (0,) * n
    pad = (0,) * (MAX_DIMS - n)
    return Batch(n, _Dims(*shape, *(1,) * (MAX_DIMS - n)),
                 _Dims(*ks[:-1], *pad), _Dims(*ds, *pad), ks[-1])


def _check(keys: torch.Tensor) -> torch.device:
    if keys.dtype != torch.int64 or keys.ndim < 1 or keys.shape[-1] != 2:
        raise ValueError(f"want int64 keys [..., 2], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    return keys.device


def _launch(fn: str, out: torch.Tensor, *args) -> torch.Tensor:
    """One launch of the entry point `fn` with `args`, then `out` and the
    current stream; an empty `out` launches nothing."""
    global LAUNCHES
    if out.numel() == 0:
        return out
    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"the threefry kernel needs CUDA tensors, got {dev}")
    lib = cuda_build.load(build(), SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):    # the runtime launches on its current card
        rc = getattr(lib, fn)(*args, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"threefry kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: `data` an int (passed by value) or an
    integer tensor that broadcasts against the key batch."""
    dev = _check(keys)
    if isinstance(data, numbers.Integral):
        d, value, shape = None, int(data) & M32, keys.shape[:-1]
    else:
        d = torch.as_tensor(data, dtype=torch.int64, device=dev)
        # views, no kernel (torch.broadcast_shapes imports sympy at its
        # first call: seconds of a generator's set-up)
        value, shape = 0, torch.broadcast_tensors(keys[..., 0], d)[0].shape
    out = torch.empty(tuple(shape) + (2,), dtype=torch.int64, device=dev)
    return _launch("rig_threefry_fold_in", out, keys.data_ptr(),
                   None if d is None else d.data_ptr(), value,
                   layout(keys, shape, d))


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` -> keys ``[..., num, 2]``."""
    dev = _check(keys)
    shape = tuple(keys.shape[:-1])
    out = torch.empty(shape + (num, 2), dtype=torch.int64, device=dev)
    return _launch("rig_threefry_split", out, keys.data_ptr(),
                   layout(keys, shape), num)


def random_bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits per element -> int64 ``[..., *shape]``."""
    dev = _check(keys)
    batch = tuple(keys.shape[:-1])
    out = torch.empty(batch + tuple(shape), dtype=torch.int64, device=dev)
    return _launch("rig_threefry_random_bits", out, keys.data_ptr(),
                   layout(keys, batch), math.prod(shape))
