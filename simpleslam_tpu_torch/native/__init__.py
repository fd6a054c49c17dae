"""ctypes loader for the C++ host helpers, with a reported numpy fallback.

The host helpers (NaN-strip + padding, first-point voxel downsample of
keyframe clouds, submap transform + concat, the streamed executor's
downsample + spatial sort + int16 quantization of scan batches, and the lio
mode's EKF replay over a chunk of the wheel+IMU tape) live in the package's
own C++ source, ``csrc/hostops.cpp``: a copy of the reference package's host
runtime plus the EKF step, so the port builds with no other package beside
it. It is compiled with g++ at first use into ``simpleslam_tpu_torch/build/``,
under a name keyed by the source's hash. These are host-only helpers, not
device kernels: where no compiler is present each entry point falls back to
numpy with the same semantics.

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
SRC = os.path.join(_PKG, "csrc", "hostops.cpp")
BUILD_DIR = os.path.join(_PKG, "build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_why_numpy = ""


def _build(out: str, src: Optional[str] = None,
           flags: tuple = ("-fopenmp",)) -> str:
    """Compile ``src`` (SRC by default) into ``out``; returns "" on success,
    else the reason."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", *flags, src or SRC, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ could not run: {e!r}"
    if r.returncode != 0:
        return "g++ failed: " + r.stderr.decode(errors="replace")[-2000:]
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    from ..ops import _build as kernel_build

    kernel_build.note_build()
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
    lib.voxel_downsample_centroid_pad.restype = i64
    lib.voxel_downsample_centroid_pad.argtypes = [
        f32p, i64, ctypes.c_float, i64, i64, ctypes.c_float, f32p]
    lib.voxel_downsample_centroid_pad_batch.restype = None
    lib.voxel_downsample_centroid_pad_batch.argtypes = [
        f32p, i64p, i64, ctypes.c_float, i64, i64, ctypes.c_float, f32p,
        i64p, i64]
    lib.voxel_downsample_sort_quant_batch.restype = None
    lib.voxel_downsample_sort_quant_batch.argtypes = [
        f32p, i64p, i64, ctypes.c_float, i64, i64, ctypes.c_float,
        ctypes.c_float, ctypes.POINTER(ctypes.c_int16), i64p, i64]
    lib.ekf_replay_chunk.restype = None
    lib.ekf_replay_chunk.argtypes = [
        f32p, f32p, ctypes.POINTER(ctypes.c_int32), f32p, f32p, f32p, u8p,
        f32p, f32p, f32p, i64, f32p, u8p]


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


def available() -> bool:
    """Whether the C++ host helpers are built and loaded."""
    return _load() is not None


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


def _centroids_first_seen(xyz: np.ndarray, grid: float, capacity: int,
                          max_pts: int) -> np.ndarray:
    """numpy form of the C++ ``voxel_downsample_centroid_pad`` without the
    padding: f32 sums of each voxel's first ``max_pts`` finite points in
    input order, voxels in first-seen order, stride-subsampled past
    ``capacity``."""
    xyz = xyz[np.isfinite(xyz).all(axis=1)]
    if len(xyz) == 0:
        return xyz
    keys = np.floor(xyz * (np.float32(1.0) / np.float32(grid))).astype(np.int64)
    _, first, vid = np.unique(keys, axis=0, return_index=True,
                              return_inverse=True)
    vid = vid.reshape(-1)
    order = np.argsort(vid, kind="stable")
    starts = np.searchsorted(vid[order], np.arange(len(first)))
    rank = np.empty(len(vid), np.int64)
    rank[order] = np.arange(len(vid)) - starts[vid[order]]
    take = rank < max_pts
    sums = np.zeros((len(first), 3), np.float32)
    np.add.at(sums, vid[take], xyz[take])   # unbuffered: input order, in f32
    cnt = np.bincount(vid[take], minlength=len(first)).astype(np.float32)
    cents = (sums * (np.float32(1.0) / cnt)[:, None])[np.argsort(first)]
    nv = len(cents)
    if nv > capacity:
        cents = cents[np.arange(capacity) * nv // capacity]
    return cents


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _flatten_scans(scans):
    """A batch of clouds as one (sum n, 3) f32 array and their (B,) sizes."""
    flat = [_f32c(np.asarray(s).reshape(-1, 3)) for s in scans]
    concat = (np.concatenate(flat, axis=0) if flat
              else np.zeros((0, 3), np.float32))
    return concat, np.asarray([len(f) for f in flat], np.int64)


def _omp_threads() -> int:
    """OpenMP width of a batch call: one core stays free for the thread
    that feeds the device."""
    return max(1, (os.cpu_count() or 2) - 1)


def voxel_downsample_centroid_pad(xyz: np.ndarray, grid: float, capacity: int,
                                  pad_coord: float, max_pts: int = 20):
    """Centroid-per-voxel downsample into the padded layout: the centroid of
    each voxel's first ``max_pts`` finite points, voxels in first-seen order,
    stride-subsampled past ``capacity``, ``pad_coord`` beyond the valid
    count. Returns (padded (capacity, 3) f32, valid count)."""
    xyz = _f32c(xyz.reshape(-1, 3))
    lib = _load()
    out = np.empty((capacity, 3), np.float32)
    if lib is None:
        cents = _centroids_first_seen(xyz, grid, capacity, max_pts)
        out[: len(cents)] = cents
        out[len(cents):] = pad_coord
        return out, len(cents)
    m = lib.voxel_downsample_centroid_pad(
        _fp(xyz), len(xyz), ctypes.c_float(grid), max_pts, capacity,
        ctypes.c_float(pad_coord), _fp(out))
    return out, int(m)


def voxel_downsample_centroid_pad_batch(scans, grid: float, capacity: int,
                                        pad_coord: float, max_pts: int = 20):
    """``voxel_downsample_centroid_pad`` of a batch of independent scans in
    one GIL-released call, parallel over scans. Returns ((B, capacity, 3)
    f32, (B,) int64 valid counts)."""
    b = len(scans)
    out = np.empty((b, capacity, 3), np.float32)
    cnts = np.empty(b, np.int64)
    lib = _load()
    if lib is None:
        for i, s in enumerate(scans):
            out[i], cnts[i] = voxel_downsample_centroid_pad(
                np.asarray(s), grid, capacity, pad_coord, max_pts)
        return out, cnts
    concat, counts = _flatten_scans(scans)
    lib.voxel_downsample_centroid_pad_batch(
        _fp(concat), _i64p(counts), b, ctypes.c_float(grid), max_pts,
        capacity, ctypes.c_float(pad_coord), _fp(out), _i64p(cnts),
        _omp_threads())
    return out, cnts


def voxel_downsample_sort_quant_batch(scans, grid: float, capacity: int,
                                      sort_grid: float, quant_scale: float,
                                      max_pts: int = 20):
    """The streamed producer's prep of a chunk of scans in one GIL-released
    call: centroid downsample, spatial sort by voxel key at ``sort_grid``,
    and int16 quantization at ``quant_scale`` metres per count (returns
    beyond +-32766 counts are dropped, 32767 pads).

    Returns ((B, capacity, 3) int16, (B,) int64 valid counts).
    """
    b = len(scans)
    lib = _load()
    out = np.full((b, capacity, 3), np.int16(32767), np.int16)
    counts_out = np.zeros(b, np.int64)
    if lib is None:
        inv_s = np.float32(1.0) / np.float32(sort_grid) if sort_grid > 0 else 0
        qinv = np.float32(1.0) / np.float32(quant_scale)
        for k, scan in enumerate(scans):
            pts = _centroids_first_seen(
                _f32c(np.asarray(scan).reshape(-1, 3)), grid, capacity,
                max_pts)
            if sort_grid > 0 and len(pts) > 1:
                v = np.floor(pts * inv_s).astype(np.int64) + (1 << 20)
                key = (v[:, 0] << 42) | (v[:, 1] << 21) | v[:, 2]
                pts = pts[np.argsort(key, kind="stable")]
            q = np.rint(pts * qinv)
            q = q[np.all(np.abs(q) <= 32766, axis=1)]
            out[k, : len(q)] = q.astype(np.int16)
            counts_out[k] = len(q)
        return out, counts_out
    concat, counts = _flatten_scans(scans)
    lib.voxel_downsample_sort_quant_batch(
        _fp(concat), _i64p(counts), b, ctypes.c_float(grid), max_pts,
        capacity, ctypes.c_float(sort_grid), ctypes.c_float(quant_scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        _i64p(counts_out), _omp_threads())
    return out, counts_out


def ekf_replay_chunk(x: np.ndarray, P: np.ndarray, flags: np.ndarray,
                     scal: np.ndarray, var: np.ndarray, stamps: np.ndarray,
                     is_wheel: np.ndarray, xy: np.ndarray, wyaw: np.ndarray,
                     iyaw: np.ndarray):
    """The planar EKF over one chunk of the event tape, in f32 (see
    ``csrc/hostops.cpp``). The carry arrays ``x`` (3,), ``P`` (3, 3) f32,
    ``flags`` (3,) int32 and ``scal`` (6,) f32 are updated in place. Returns
    (states (n, 3) f32, emitted (n,) bool), or None where the C++ helpers are
    not built: the caller then runs its numpy step."""
    lib = _load()
    if lib is None:
        return None
    n = len(stamps)
    stamps, xy = _f32c(stamps), _f32c(xy)
    wyaw, iyaw = _f32c(wyaw), _f32c(iyaw)
    isw = np.ascontiguousarray(is_wheel, dtype=np.uint8)
    states = np.empty((n, 3), np.float32)
    emitted = np.empty(n, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ekf_replay_chunk(
        _fp(x), _fp(P), flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _fp(scal), _fp(_f32c(var)), _fp(stamps), isw.ctypes.data_as(u8p),
        _fp(xy), _fp(wyaw), _fp(iyaw), n, _fp(states),
        emitted.ctypes.data_as(u8p))
    return states, emitted.astype(bool)


# ---------------------------------------------------------------------------
# the GN loop kernel's host-testable headers, compiled for the host: its
# small step (csrc/gn_step.h) and its candidate index math
# (csrc/target_gather.h)
# ---------------------------------------------------------------------------

GN_SRC = os.path.join(_PKG, "csrc", "gn_step_host.cpp")
GN_HEADER = os.path.join(_PKG, "csrc", "gn_step.h")
TG_SRC = os.path.join(_PKG, "csrc", "target_gather_host.cpp")
TG_HEADER = os.path.join(_PKG, "csrc", "target_gather.h")
_kernel_libs: dict = {}


def _kernel_host_lib(name: str, src: str, header: str, bind) -> ctypes.CDLL:
    """``src`` (which includes ``header``) built with g++ into the build dir
    under a name keyed by both files' hash, loaded and bound by ``bind``."""
    with _lock:
        lib = _kernel_libs.get(name)
        if lib is not None:
            return lib
        h = hashlib.sha256()
        for path in (src, header):
            with open(path, "rb") as f:
                h.update(f.read())
        out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
        if not os.path.isfile(out):
            # no multiply-add contraction, as the kernels' -fmad=false
            why = _build(out, src, ("-ffp-contract=off",))
            if why:
                raise RuntimeError(f"{name} host build failed: {why}")
        lib = ctypes.CDLL(out)
        bind(lib)
        _kernel_libs[name] = lib
        return lib


def _bind_gn(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.gn_step_host.restype = ctypes.c_int
    lib.gn_step_host.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float,
                                 f32p, f32p, ctypes.c_float, f32p, f32p, f32p]
    lib.gn_finish_host.restype = None
    lib.gn_finish_host.argtypes = [f32p, f32p]
    lib.gn_jacobi_eig6_host.restype = None
    lib.gn_jacobi_eig6_host.argtypes = [f32p, f32p, f32p]


def _bind_tg(lib: ctypes.CDLL) -> None:
    f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
    ci = ctypes.c_int
    lib.tg_corner_rows.restype = None
    lib.tg_corner_rows.argtypes = [f32p, u8p, ci, f32p, ctypes.c_float, ci,
                                   ci, ci, ctypes.POINTER(ctypes.c_int64)]
    lib.tg_table_rows.restype = None
    lib.tg_table_rows.argtypes = [f32p, u8p, ci, f32p, ctypes.c_float,
                                  ctypes.POINTER(ctypes.c_int32), ci,
                                  ctypes.POINTER(ctypes.c_int32), u8p]


def _gn_load() -> ctypes.CDLL:
    return _kernel_host_lib("gnstep", GN_SRC, GN_HEADER, _bind_gn)


def _tg_load() -> ctypes.CDLL:
    return _kernel_host_lib("targetgather", TG_SRC, TG_HEADER, _bind_tg)


def gn_step(jtj: np.ndarray, jte: np.ndarray, n_valid: int,
            degen_per_row: float, pose: np.ndarray, anchor: np.ndarray,
            r_max: float):
    """One Gauss-Newton step of ``csrc/gn_step.h`` on the host: (dx (6,),
    pose after the step (4, 4), converged-test flag, enough-rows flag, motion
    since ``anchor``), all f32. The pose is unchanged when the loop stops at
    this step (converged or starved)."""
    lib = _gn_load()
    jtj, jte = _f32c(jtj).reshape(36), _f32c(jte).reshape(6)
    pose, anchor = _f32c(pose).reshape(16), _f32c(anchor).reshape(16)
    dx = np.empty(6, np.float32)
    out = np.empty(16, np.float32)
    moved = np.empty(1, np.float32)
    flags = lib.gn_step_host(_fp(jtj), _fp(jte), int(n_valid),
                             ctypes.c_float(degen_per_row), _fp(pose),
                             _fp(anchor), ctypes.c_float(r_max), _fp(dx),
                             _fp(out), _fp(moved))
    return (dx, out.reshape(4, 4), bool(flags & 1), bool(flags & 2),
            float(moved[0]))


def gn_finish(pose: np.ndarray) -> np.ndarray:
    """The loop's epilogue of ``csrc/gn_step.h``: ``pose`` (4, 4) with its
    rotation re-orthonormalized by the quaternion round trip."""
    lib = _gn_load()
    pose = _f32c(pose).reshape(16)
    out = np.empty(16, np.float32)
    lib.gn_finish_host(_fp(pose), _fp(out))
    return out.reshape(4, 4)


def jacobi_eig6(a: np.ndarray):
    """The cyclic Jacobi eigensolve of ``csrc/gn_step.h``: (w (6,), V (6, 6))
    with ``a = V diag(w) V^T``, eigenvalues in no particular order."""
    lib = _gn_load()
    a = _f32c(a).reshape(36)
    w = np.empty(6, np.float32)
    v = np.empty(36, np.float32)
    lib.gn_jacobi_eig6_host(_fp(a), _fp(w), _fp(v))
    return w, v.reshape(6, 6)


def _u8(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def corner_rows(q: np.ndarray, mask: np.ndarray, corner: np.ndarray,
                grid: float, dims) -> np.ndarray:
    """Rows of the 8 corner-block cells of each query, x outermost, as the
    kernel ``loam_gn_loop`` finds them in a dense map (``csrc/
    target_gather.h``): (Q, 8) int64, the sentinel row gx * gy * gz for a
    masked-out query or a cell outside the window."""
    lib = _tg_load()
    q, mask = _f32c(q).reshape(-1, 3), _u8(mask)
    out = np.empty((len(q), 8), np.int64)
    gx, gy, gz = (int(d) for d in dims)
    lib.tg_corner_rows(_fp(q), mask.ctypes.data_as(ctypes.POINTER(
        ctypes.c_uint8)), len(q), _fp(_f32c(corner)), ctypes.c_float(grid),
        gx, gy, gz, _i64p(out))
    return out


def table_rows(q: np.ndarray, mask: np.ndarray, origin: np.ndarray,
               grid: float, keys: np.ndarray):
    """Rows and found flags of the 27 cells of each query, as the kernel
    ``loam_gn_loop`` finds them in a sorted voxel table (``csrc/
    target_gather.h``): ((Q, 27) int32, (Q, 27) bool)."""
    lib = _tg_load()
    q, mask = _f32c(q).reshape(-1, 3), _u8(mask)
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    if len(keys) < 1:
        raise ValueError("table_rows: the table has no row")
    idx = np.empty((len(q), 27), np.int32)
    found = np.empty((len(q), 27), np.uint8)
    i32p, u8p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    lib.tg_table_rows(_fp(q), mask.ctypes.data_as(u8p), len(q),
                      _fp(_f32c(origin)), ctypes.c_float(grid),
                      keys.ctypes.data_as(i32p), len(keys),
                      idx.ctypes.data_as(i32p), found.ctypes.data_as(u8p))
    return idx, found.astype(bool)
