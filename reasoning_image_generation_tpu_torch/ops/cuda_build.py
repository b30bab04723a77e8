# cuda_build.py — build the port's native sources at first use and load them.
"""One build helper for every source under ``csrc/``.

``build`` compiles one source into a shared library in
``reasoning_image_generation_tpu_torch/_build/``, named by a hash of the
source, the headers it includes (``deps``) and the command, so a library is
rebuilt exactly when one of them changes and never lands in a source tree.
``load`` builds, opens the library with ctypes and declares the C functions
it exports.

CUDA sources are compiled by nvcc for sm_90a with ``NVCC_FLAGS``:
``-fmad=false`` keeps nvcc from fusing multiply-adds on its own, so the
kernels round where their plain PyTorch versions round; ``-Xptxas -v``
makes it print each kernel's registers and spills, which
``compiler_output`` keeps for whoever built the library in this process.
Nothing falls back: a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
_built: dict = {}
compiler_output: dict = {}   # source file name -> what its compiler printed


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def build(source: str, cmd, libs=(), deps=()) -> str:
    """Compile `source` with ``cmd + ['-o', lib, source] + libs`` unless a
    library built from this source, these `deps` (files it includes) and
    this command exists; returns its path."""
    h = hashlib.sha256()
    for path in (source, *deps):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join([*cmd, *libs]).encode())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    lib = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if not os.path.exists(lib):
        _compile(source, cmd, libs, lib)
    return lib


def _compile(source: str, cmd, libs, lib: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([*cmd, "-o", tmp, source, *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed on {source} "
                           f"({proc.returncode}):\n{proc.stderr}")
    compiler_output[os.path.basename(source)] = proc.stdout + proc.stderr
    os.replace(tmp, lib)


def build_cuda(name: str) -> str:
    """Build ``csrc/<name>`` with nvcc for sm_90a, once per process (a
    launch asks for its library every time).  Every header in ``csrc/``
    counts as included, so a change to one rebuilds every kernel."""
    if name not in _built:
        headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                         if f.endswith(".cuh"))
        _built[name] = build(os.path.join(CSRC, name), [nvcc(), *NVCC_FLAGS],
                             deps=headers)
    return _built[name]


def check_arg(name: str, t, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device`: what a kernel is handed as a bare pointer."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def load(path: str, functions: dict) -> ctypes.CDLL:
    """Open the library at `path` once per process and declare each
    exported function: ``functions`` maps its name to its argtypes; every
    function returns an int status."""
    with _lock:
        if path not in _libs:
            lib = ctypes.CDLL(path)
            for name, argtypes in functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[path] = lib
    return _libs[path]
