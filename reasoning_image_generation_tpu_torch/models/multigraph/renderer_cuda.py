# renderer_cuda.py — build, bind and launch the CUDA scene renderer (K2).
"""``render_prepared_cuda`` launches the hand-written kernel in
``csrc/mg_render.cu`` on the prepared inputs of
``renderer.prepare_scene_batch``.  It takes CUDA tensors only: a CPU
tensor, or a CUDA tensor the kernel cannot take, raises, and nothing falls
back to the plain version (``renderer.render_scene_tensors`` picks the plain
version for CPU tensors).

The kernel is built at first use by ``ops/cuda_build.py`` (nvcc for
sm_90a, into ``reasoning_image_generation_tpu_torch/_build/``) and loaded
with ctypes.  ``LAUNCHES`` counts the kernel launches the card ran, so a
caller can show that its path really went through the kernel; a launch
captured into a CUDA graph counts at every replay instead
(utils/graphs.py).
"""
from __future__ import annotations

import ctypes

import torch

from ...ops import cuda_build
from .scene import MAX_LINES, MAX_MASKS, MAX_SHAPES, NV

NMETA = 20        # meta rows per scene
NCOL = 8          # meta columns (shape, or mask for row 1)
NLIN = 16         # fields per decoration line

LAUNCHES = 0


def build() -> str:
    """Compile csrc/mg_render.cu (if this source hash is not built yet) and
    return the shared library's path."""
    return cuda_build.build_cuda("mg_render.cu")


def _load():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load(build(), {
        "rig_mg_render": [p, p, p, p, p, p, p, i, i, i, p]})


def render_prepared_cuda(meta, svx, svy, mvx, mvy, lin, H: int,
                         W: int) -> torch.Tensor:
    """Launch the kernel -> u8 ``[N, H, W, 3]`` on the inputs' card."""
    global LAUNCHES
    dev = meta.device
    if dev.type != "cuda":
        raise ValueError(f"render_prepared_cuda needs CUDA tensors, got {dev}")
    N = meta.shape[0]
    if N <= 0 or H <= 0 or W <= 0:
        raise ValueError(f"empty render: N={N}, H={H}, W={W}")
    for name, t, shape in (("meta", meta, (N, NMETA, NCOL)),
                           ("svx", svx, (N, MAX_SHAPES, NV)),
                           ("svy", svy, (N, MAX_SHAPES, NV)),
                           ("mvx", mvx, (N, MAX_MASKS, NV)),
                           ("mvy", mvy, (N, MAX_MASKS, NV)),
                           ("lin", lin, (N, MAX_LINES, NLIN))):
        cuda_build.check_arg(name, t, torch.float32, shape, dev)
    out = torch.empty((N, H, W, 3), dtype=torch.uint8, device=dev)
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):    # the runtime launches on its current card
        rc = lib.rig_mg_render(meta.data_ptr(), svx.data_ptr(),
                               svy.data_ptr(), mvx.data_ptr(), mvy.data_ptr(),
                               lin.data_ptr(), out.data_ptr(), N, H, W,
                               stream)
    if rc != 0:
        raise RuntimeError(f"mg render kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
