"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc + ctypes.

All kernel sources are compiled by one nvcc call into one shared
library with a plain C interface, at first use, into
`pbrt_tpu_torch/_build/<hash of sources and flags>/` (listed in
.gitignore). Nothing is built at import time: the CPU tests import every
module and this machine class may have no nvcc.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")

# sm_90a (Hopper); -fmad=false and no fast math keep every multiply and
# add rounded as the plain torch versions round them.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None


class BuildInfo:
    """What the last build did: library path, seconds, ptxas report."""

    path = ""
    seconds = 0.0
    ptxas = ""
    cached = False


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def load_kernels() -> ctypes.CDLL:
    """-> the kernel library, building it first if needed. Raises on any
    build or load failure."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            with open(s, "rb") as f:
                h.update(os.path.basename(s).encode() + f.read())
        out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
        so = os.path.join(out_dir, "libpbrt_kernels.so")
        log = os.path.join(out_dir, "ptxas.log")
        BuildInfo.cached = os.path.exists(so)
        t0 = time.perf_counter()
        if not BuildInfo.cached:
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            with open(log, "w") as f:
                f.write(proc.stderr + proc.stdout)
            os.replace(tmp, so)
        BuildInfo.seconds = time.perf_counter() - t0
        BuildInfo.path = so
        BuildInfo.ptxas = open(log).read() if os.path.exists(log) else ""
        lib = ctypes.CDLL(so)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.pbrt_tri_t_pass.restype = i
        lib.pbrt_tri_t_pass.argtypes = [vp, i, vp, i, i, vp, vp, vp]
        lib.pbrt_wide_sweep.restype = i
        lib.pbrt_wide_sweep.argtypes = [vp, vp, vp, i, vp, vp, i, i, vp, vp, vp]
        _LIB = lib
        return lib


def check_cuda(t, name: str, dtype, shape=None):
    """Raise unless t is a contiguous CUDA tensor of dtype (and shape)."""
    import torch

    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def raise_on_launch_error(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
