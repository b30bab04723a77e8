# raster_cuda.py — build, bind and launch the CUDA frame rasterizer (K1).
"""``render_frames`` dispatches on where its tensors lie: CPU tensors go to
the plain PyTorch version (ops/raster.py), CUDA tensors to the hand-written
kernel in csrc/raster.cu.  Nothing falls back: a CUDA tensor either
launches the kernel or raises.

The kernel is built at first use with nvcc for sm_90a into
``reasoning_image_generation_tpu_torch/_build/``, keyed by a hash of the
source, and loaded with ctypes.  ``LAUNCHES`` counts kernel launches, so a
caller can show that its path really went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..utils.state import ElementState
from . import raster

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "raster.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

MAX_ELEMS = 16        # element slots per frame the kernel stages (MAX_E)

LAUNCHES = 0

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA rasterizer is built from "
                       "csrc/raster.cu at first use and needs the CUDA toolkit")


def build() -> str:
    """Compile csrc/raster.cu (if this source hash is not built yet) and
    return the shared library's path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libraster_{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p = ctypes.c_void_p
            i = ctypes.c_int
            lib.rig_raster_render.argtypes = [p, p, p, p, p, i, i, p, i, i,
                                              i, i, p]
            lib.rig_raster_render.restype = ctypes.c_int
            _lib = lib
    return _lib


def _grid_lines(W: int, H: int, grid_size: int, device) -> torch.Tensor:
    """x then y positions of the interior grid lines, as the plain version
    draws them."""
    xs = [float(round(i * W / grid_size)) for i in range(1, grid_size)]
    ys = [float(round(i * H / grid_size)) for i in range(1, grid_size)]
    return torch.tensor(xs + ys, dtype=torch.float32, device=device)


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def render_prepared_cuda(meta, vx, vy, use_grid, W: int, H: int,
                         grid_size: int = 3) -> torch.Tensor:
    """Launch the kernel on prepared data (ops/raster.prepare_render_data)
    -> u8 ``[N, H, W, 3]``."""
    global LAUNCHES
    dev = meta.device
    if dev.type != "cuda":
        raise ValueError(f"render_prepared_cuda needs CUDA tensors, got {dev}")
    N, E = meta.shape[:2]
    if not 0 < E <= MAX_ELEMS:
        raise ValueError(f"the kernel takes 1..{MAX_ELEMS} element slots, "
                         f"got {E}")
    _check("meta", meta, torch.float32, (N, E, raster.NMETA), dev)
    _check("vx", vx, torch.float32, (N, E, 2, 64), dev)
    _check("vy", vy, torch.float32, (N, E, 2, 64), dev)
    ug = use_grid.to(torch.uint8).contiguous()
    _check("use_grid", ug, torch.uint8, (N,), dev)
    lines = _grid_lines(W, H, grid_size, dev)
    out = torch.empty((N, H, W, 3), dtype=torch.uint8, device=dev)
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rig_raster_render(
        meta.data_ptr(), vx.data_ptr(), vy.data_ptr(), ug.data_ptr(),
        lines.data_ptr(), grid_size - 1, grid_size - 1, out.data_ptr(),
        N, E, W, H, stream)
    if rc != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def render_frames(states: ElementState, W: int, H: int, use_grid,
                  grid_size: int = 3) -> torch.Tensor:
    """Render frames ``[N, E]`` -> u8 ``[N, H, W, 3]``: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if states.cx.device.type == "cpu":
        return raster.render_frames(states, W, H, use_grid, grid_size)
    meta, vx, vy = raster.prepare_render_data(states, W, H, use_grid,
                                              grid_size)
    return render_prepared_cuda(meta, vx, vy, use_grid, W, H, grid_size)
