"""ctypes loader for the C++ host helpers, with a reported numpy fallback.

The host helpers (NaN-strip + padding, first-point voxel downsample of
keyframe clouds, submap transform + concat) share one C++ source with the
reference package, ``simpleslam_tpu/native/hostops.cpp``. It is read as a
file and compiled with g++ at first use into ``simpleslam_tpu_torch/build/``,
under a name keyed by the source's hash, so both packages run the same host
code. These are host-only helpers, not device kernels: where no compiler is
present each entry point falls back to numpy with the same semantics.

Unlike the reference loader, the fallback is never silent: ``backend()``
says which path runs ("cpp" or "numpy"), and the first fallback logs a
warning with the reason.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG), "simpleslam_tpu", "native",
                   "hostops.cpp")
BUILD_DIR = os.path.join(_PKG, "build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_why_numpy = ""


def _build(out: str) -> str:
    """Compile SRC into ``out``; returns "" on success, else the reason."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", SRC, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ could not run: {e!r}"
    if r.returncode != 0:
        return "g++ failed: " + r.stderr.decode(errors="replace")[-2000:]
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return ""


def _bind(lib: ctypes.CDLL) -> None:
    i64, f32p, u8p, i64p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(ctypes.c_int64))
    lib.voxel_downsample_first.restype = i64
    lib.voxel_downsample_first.argtypes = [f32p, i64, ctypes.c_float, f32p]
    lib.pad_cloud.restype = i64
    lib.pad_cloud.argtypes = [f32p, i64, i64, ctypes.c_float, f32p, u8p]
    lib.transform_concat.restype = i64
    lib.transform_concat.argtypes = [f32p, i64p, f32p, i64, f32p]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _why_numpy
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.isfile(SRC):
            _why_numpy = f"C++ source not found: {SRC}"
        else:
            with open(SRC, "rb") as f:
                tag = hashlib.sha256(f.read()).hexdigest()[:16]
            path = os.path.join(BUILD_DIR, f"libhostops_{tag}.so")
            if not os.path.isfile(path):
                _why_numpy = _build(path)
            if not _why_numpy:
                try:
                    lib = ctypes.CDLL(path)
                    _bind(lib)
                    _lib = lib
                except (OSError, AttributeError) as e:
                    _why_numpy = f"could not load {path}: {e!r}"
        if _lib is None:
            from ..utils.logging import Logger

            Logger.get_instance().warn(
                "native host helpers run in numpy: %s", _why_numpy)
        return _lib


def backend() -> str:
    """Which implementation the host helpers run: "cpp" or "numpy"."""
    return "cpp" if _load() is not None else "numpy"


def _f32c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def voxel_downsample_first(xyz: np.ndarray, grid: float) -> np.ndarray:
    """First-point-per-voxel downsample (keyframe storage semantics)."""
    xyz = _f32c(xyz.reshape(-1, 3))
    if len(xyz) == 0:
        return xyz
    lib = _load()
    if lib is None:
        xyz = xyz[np.isfinite(xyz).all(axis=1)]
        keys = np.floor(xyz * np.float32(1.0 / grid)).astype(np.int64)
        _, first = np.unique(keys, axis=0, return_index=True)
        return xyz[np.sort(first)]
    out = np.empty_like(xyz)
    m = lib.voxel_downsample_first(_fp(xyz), len(xyz), ctypes.c_float(grid),
                                   _fp(out))
    return out[:m].copy()


def pad_cloud(xyz: np.ndarray, capacity: int, pad_coord: float):
    """NaN-strip + pad to (capacity, 3); returns (padded, mask(bool), count)."""
    xyz = _f32c(xyz.reshape(-1, 3))
    lib = _load()
    if lib is None:
        v = xyz[np.isfinite(xyz).all(axis=1)][:capacity]
        out = np.full((capacity, 3), pad_coord, np.float32)
        out[: len(v)] = v
        mask = np.zeros(capacity, bool)
        mask[: len(v)] = True
        return out, mask, len(v)
    out = np.empty((capacity, 3), np.float32)
    mask = np.empty(capacity, np.uint8)
    m = lib.pad_cloud(_fp(xyz), len(xyz), capacity, ctypes.c_float(pad_coord),
                      _fp(out),
                      mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out, mask.astype(bool), int(m)


def transform_concat(clouds: list, poses: np.ndarray) -> np.ndarray:
    """Transform each cloud by its (4, 4) pose and concatenate (submap
    gather)."""
    if not clouds:
        return np.zeros((0, 3), np.float32)
    lib = _load()
    if lib is None:
        return np.concatenate([
            c.astype(np.float32) @ p[:3, :3].T.astype(np.float32)
            + p[:3, 3].astype(np.float32)
            for c, p in zip(clouds, poses)
        ])
    counts = np.array([len(c) for c in clouds], np.int64)
    flat = _f32c(np.concatenate([_f32c(c) for c in clouds]))
    pose_arr = _f32c(np.asarray(poses, np.float32).reshape(len(clouds), 16))
    out = np.empty_like(flat)
    lib.transform_concat(
        _fp(flat), counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _fp(pose_arr), len(clouds), _fp(out))
    return out
