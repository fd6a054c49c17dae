"""Build the CUDA kernels of ``csrc/`` with nvcc at first use, and load them.

All ``csrc/*.cu`` files compile into one shared library with a plain C
interface, loaded with ctypes. The library goes to
``simpleslam_tpu_torch/build/`` under a name keyed by a hash of the sources
(with the headers they include) and flags, so a changed source rebuilds and
an unchanged one loads the existing file. A failed build raises with nvcc's
output; there is no fallback.
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
from typing import Optional

from .. import native

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# -fmad=false: no multiply-add is contracted implicitly, so the kernels round
# like the plain PyTorch versions they are compared against (see
# csrc/loam_kernels.cu). -Xptxas -v reports registers and spills per kernel.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_LOG = ""       # nvcc's output from this process's build ("" if loaded)
BUILD_SECONDS = 0.0  # wall time of that build (0.0 if loaded)
BUILDS = 0           # compiler runs of this process: this library and the
                     # host helpers of ``native`` (a steady state adds none)


def note_build() -> None:
    """Count one compiler run (nvcc here, g++ in ``native``)."""
    global BUILDS
    with _count_lock:
        BUILDS += 1



def _nvcc() -> str:
    cands = [os.path.join(os.environ[k], "bin", "nvcc")
             for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.loam_k4_blocks.argtypes = [ci]
    lib.loam_k4_blocks.restype = ci
    lib.loam_max_candidates.argtypes = []
    lib.loam_max_candidates.restype = ci
    lib.loam_fit_and_linearize_merged.argtypes = [
        vp, ci, vp, vp, vp, ci, ci, ci, vp, vp, vp, ci, vp, vp, vp, vp, vp,
        vp, vp, vp, vp]
    lib.loam_fit_and_linearize_merged.restype = ci
    lib.loam_fit_and_linearize_candidates.argtypes = [
        vp, vp, ci, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.loam_fit_and_linearize_candidates.restype = ci
    lib.loam_plane_normal_equations.argtypes = [
        vp, vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp]
    lib.loam_plane_normal_equations.restype = ci
    lib.loam_gn_loop_grid.argtypes = []
    lib.loam_gn_loop_grid.restype = ci
    lib.loam_gn_loop_partial_stride.argtypes = []
    lib.loam_gn_loop_partial_stride.restype = ci
    lib.loam_gn_loop_smem.argtypes = [ci, ci]
    lib.loam_gn_loop_smem.restype = ctypes.c_longlong
    lib.loam_gn_loop.argtypes = [
        vp, ci, vp, vp, vp, ci, ci, ci, vp, vp, ci, vp, ci, ctypes.c_float,
        vp, vp, vp, vp]
    lib.loam_gn_loop.restype = ci
    lib.loam_gn_loop_dense.argtypes = [
        vp, ci, vp, vp, ci, ci, ci, vp, vp, ci, vp, ci, ctypes.c_float, vp,
        vp, vp, vp]
    lib.loam_gn_loop_dense.restype = ci
    lib.loam_gn_loop_table.argtypes = [
        vp, ci, vp, vp, ci, vp, vp, vp, vp, ci, vp, ci, ctypes.c_float, vp,
        vp, vp, vp]
    lib.loam_gn_loop_table.restype = ci
    native.bind_pose_chain(lib)
    lib.loam_empty.argtypes = [vp]
    lib.loam_empty.restype = ci
    lib.loam_barrier_probe.argtypes = [vp, ci, vp]
    lib.loam_barrier_probe.restype = ci


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, BUILD_LOG, BUILD_SECONDS
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        if not srcs:
            raise RuntimeError(f"no CUDA sources in {CSRC}")
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.h"))):
            with open(s, "rb") as f:
                h.update(f.read())
        path = os.path.join(BUILD_DIR, f"libloam_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_SECONDS = time.perf_counter() - t0
            BUILD_LOG = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n{BUILD_LOG}")
            os.replace(tmp, path)
            note_build()
        lib = ctypes.CDLL(path)
        _bind(lib)
        _lib = lib
        return _lib
