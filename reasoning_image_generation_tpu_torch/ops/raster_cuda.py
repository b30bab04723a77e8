# raster_cuda.py — build, bind and launch the CUDA frame rasterizer (K1).
"""``render_frames`` dispatches on where its tensors lie: CPU tensors go to
the plain PyTorch version (ops/raster.py), CUDA tensors to the hand-written
kernel in csrc/raster.cu.  Nothing falls back: a CUDA tensor either
launches the kernel or raises.

The kernel is built at first use by ``ops/cuda_build.py`` (nvcc for sm_90a,
into ``reasoning_image_generation_tpu_torch/_build/``, keyed by a hash of
the source) and loaded with ctypes.  ``LAUNCHES`` counts the kernel
launches the card ran, so a caller can show that its path really went
through the kernel; a launch captured into a CUDA graph counts at every
replay instead (utils/graphs.py).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.state import ElementState
from . import cuda_build, raster

MAX_ELEMS = 16        # element slots per frame the kernel stages (MAX_E)
MAX_GRID_LINES = 15   # interior grid lines per axis the kernel takes

LAUNCHES = 0


class GridLines(ctypes.Structure):
    """The kernel's by-value argument: x and y positions of the interior
    grid lines."""
    _fields_ = [("nx", ctypes.c_int), ("ny", ctypes.c_int),
                ("x", ctypes.c_float * MAX_GRID_LINES),
                ("y", ctypes.c_float * MAX_GRID_LINES)]


def build() -> str:
    """Compile csrc/raster.cu (if this source hash is not built yet) and
    return the shared library's path."""
    return cuda_build.build_cuda("raster.cu")


def _load():
    p = ctypes.c_void_p
    i = ctypes.c_int
    return cuda_build.load(build(), {
        "rig_raster_render": [p, p, p, p, GridLines, p, i, i, i, i, p]})


@functools.lru_cache(maxsize=None)
def grid_lines(W: int, H: int, grid_size: int) -> GridLines:
    """Positions of the interior grid lines, as the plain version draws
    them (host values: they travel as kernel arguments)."""
    n = grid_size - 1
    if not 0 <= n <= MAX_GRID_LINES:
        raise ValueError(f"the kernel takes grid_size 1..{MAX_GRID_LINES + 1},"
                         f" got {grid_size}")
    xs = [float(round(i * W / grid_size)) for i in range(1, grid_size)]
    ys = [float(round(i * H / grid_size)) for i in range(1, grid_size)]
    pad = [0.0] * (MAX_GRID_LINES - n)
    F = ctypes.c_float * MAX_GRID_LINES
    return GridLines(n, n, F(*xs, *pad), F(*ys, *pad))


def render_prepared_cuda(meta, vx, vy, use_grid, W: int, H: int,
                         grid_size: int = 3) -> torch.Tensor:
    """Launch the kernel on prepared data (ops/raster.prepare_render_data,
    `use_grid` the bool tensor it took) -> u8 ``[N, H, W, 3]``.  One
    allocation and one launch: no copy, no other kernel."""
    global LAUNCHES
    dev = meta.device
    if dev.type != "cuda":
        raise ValueError(f"render_prepared_cuda needs CUDA tensors, got {dev}")
    N, E = meta.shape[:2]
    if not 0 < E <= MAX_ELEMS:
        raise ValueError(f"the kernel takes 1..{MAX_ELEMS} element slots, "
                         f"got {E}")
    f32 = torch.float32
    cuda_build.check_arg("meta", meta, f32, (N, E, raster.NMETA), dev)
    cuda_build.check_arg("vx", vx, f32, (N, E, 2, 64), dev)
    cuda_build.check_arg("vy", vy, f32, (N, E, 2, 64), dev)
    # a bool tensor holds one byte, 0 or 1, per value: the kernel reads it
    cuda_build.check_arg("use_grid", use_grid, torch.bool, (N,), dev)
    lines = grid_lines(W, H, grid_size)
    lib = _load()
    out = torch.empty((N, H, W, 3), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):    # the runtime launches on its current card
        rc = lib.rig_raster_render(
            meta.data_ptr(), vx.data_ptr(), vy.data_ptr(),
            use_grid.data_ptr(), lines, out.data_ptr(), N, E, W, H, stream)
    if rc != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def render_frames(states: ElementState, W: int, H: int, use_grid,
                  grid_size: int = 3, honor_flip: bool = False) -> torch.Tensor:
    """Render frames ``[N, E]`` -> u8 ``[N, H, W, 3]``: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if states.cx.device.type == "cpu":
        return raster.render_frames(states, W, H, use_grid, grid_size,
                                    honor_flip)
    meta, vx, vy = raster.prepare_render_data(states, W, H, use_grid,
                                              grid_size, honor_flip)
    return render_prepared_cuda(meta, vx, vy, use_grid, W, H, grid_size)
