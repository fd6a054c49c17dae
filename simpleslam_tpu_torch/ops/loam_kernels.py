"""Wrappers of the LOAM CUDA kernels (``csrc/loam_kernels.cu``), their plain
PyTorch versions, and launch counters.

The kernels replace the Pallas TPU kernel
``simpleslam_tpu/ops/loam_pallas.py::_kernel`` (via ``normal_equations_t``):

- K1 ``fit_and_linearize_merged``: the whole TPU kernel with the merged-row
  gather folded in — per query, read one int16 merged row, pick the 5
  nearest candidates, fit and gate the plane, and reduce J^T J, J^T e and
  n_valid; also returns the plane set. Bound on the card: Q scattered
  1,152 B row reads plus per-query selection work.
- K2 ``plane_normal_equations``: the TPU kernel's second half against a
  frozen plane set. Bound on the card: launch overhead and a (Q, 6) stream.
- K3 ``gn_loop_fused``: a scan's whole Gauss-Newton registration in one
  cooperative launch, with K1's and K2's bodies as its phases and the 6x6
  solve, the pose update and the loop tests (``csrc/gn_step.h``) between
  them, where the TPU package wraps the kernel in one ``lax.while_loop``;
  on any of the three LOAM targets (its K1 phase reads the merged map's
  int16 rows, the dense map's corner block or the sorted table's 27 cells,
  by the index math of ``csrc/target_gather.h``). Bound on the card: the
  candidate reads of its K1 phases. Its plain version is
  ``loam.gn_loop_stepwise``, the same loop driven from Python through K1
  (merged map) or the torch gather and K4 (the other two), and K2, with one
  host read per iteration.

- K4 ``fit_and_linearize_candidates``: the TPU kernel in its own form,
  candidates in, normal equations out (what a shard of the sharded path
  linearizes, and the gather + K4 of K3's plain version on a dense or table
  target); the plane set for K2. One launch: queries staged in shared
  memory by a cp.async pipeline (flags first, then only the coordinates of
  set candidates), the warp's selection as in K1, the scalar tail one lane
  per query. Bound on the card: the candidate stream, a 1-byte flag for
  every candidate of a valid query and 12 bytes of coordinates for every
  candidate whose flag is set.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (built at first use) or raises. Nothing falls back.
The counters count kernel launches, and plain-version calls on CUDA tensors
(which the main path never makes).
"""

from __future__ import annotations

import threading

import torch

from . import loam
from .loam import Planes
from .voxel import (DenseVoxelMap, MergedDenseVoxelMap, VoxelMap,
                    gather_neighbors_merged)

K1_LAUNCHES = 0
K2_LAUNCHES = 0
K3_LAUNCHES = 0
K4_LAUNCHES = 0
K1_PLAIN_CUDA_CALLS = 0
K2_PLAIN_CUDA_CALLS = 0
K3_PLAIN_CUDA_CALLS = 0   # loam.gn_loop_stepwise on CUDA, any target
K4_PLAIN_CUDA_CALLS = 0

# K3's result row: the pose (4x4 row-major), then these
GN_ROW = 20
GN_CONVERGED, GN_ITERS, GN_GATHERS, GN_N_VALID = 16, 17, 18, 19

def reset_counts() -> None:
    global K1_LAUNCHES, K2_LAUNCHES, K3_LAUNCHES, K4_LAUNCHES
    global K1_PLAIN_CUDA_CALLS, K2_PLAIN_CUDA_CALLS, K3_PLAIN_CUDA_CALLS
    global K4_PLAIN_CUDA_CALLS
    K1_LAUNCHES = K2_LAUNCHES = K3_LAUNCHES = K4_LAUNCHES = 0
    K1_PLAIN_CUDA_CALLS = K2_PLAIN_CUDA_CALLS = K3_PLAIN_CUDA_CALLS = 0
    K4_PLAIN_CUDA_CALLS = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fit_and_linearize_merged_plain(vm: MergedDenseVoxelMap, p_map: torch.Tensor,
                                   sqrt_r: torch.Tensor, mask: torch.Tensor):
    """``gather_neighbors_merged`` + ``fit_planes`` + ``plane_normal_equations``
    at one pose: (J^T J, J^T e, n_valid, Planes)."""
    global K1_PLAIN_CUDA_CALLS
    if p_map.is_cuda:
        K1_PLAIN_CUDA_CALLS += 1
    cand, cand_ok = gather_neighbors_merged(vm, p_map, mask)
    planes = loam.fit_planes_at(p_map, mask, cand, cand_ok)
    return (*loam.plane_rows(planes, p_map, sqrt_r), planes)


def fit_and_linearize_candidates_plain(cand: torch.Tensor,
                                       cand_ok: torch.Tensor,
                                       p_map: torch.Tensor,
                                       sqrt_r: torch.Tensor,
                                       mask: torch.Tensor):
    """``fit_planes_at`` + ``plane_rows`` on gathered candidates:
    (J^T J, J^T e, n_valid, Planes). A masked-out query's flags count as
    off, so its plane is the zero plane whatever they hold."""
    global K4_PLAIN_CUDA_CALLS
    if p_map.is_cuda:
        K4_PLAIN_CUDA_CALLS += 1
    planes = loam.fit_planes_at(p_map, mask, cand, cand_ok & mask[:, None])
    return (*loam.plane_rows(planes, p_map, sqrt_r), planes)


def plane_normal_equations_plain(planes: Planes, p_map: torch.Tensor,
                                 sqrt_r: torch.Tensor):
    """Point-to-plane normal equations against frozen planes:
    (J^T J, J^T e, n_valid)."""
    global K2_PLAIN_CUDA_CALLS
    if p_map.is_cuda:
        K2_PLAIN_CUDA_CALLS += 1
    return loam.plane_rows(planes, p_map, sqrt_r)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _outputs(dev: torch.device):
    return (torch.empty((6, 6), dtype=torch.float32, device=dev),
            torch.empty((6,), dtype=torch.float32, device=dev),
            torch.empty((), dtype=torch.int32, device=dev))


def _check_map(vm: MergedDenseVoxelMap, lib, dev) -> int:
    """Validate the merged map for the kernels; returns candidates per query."""
    gx, gy, gz = vm.dims
    n_cand = 8 * vm.slab_pts
    if n_cand > lib.loam_max_candidates():
        raise ValueError(f"{n_cand} candidates per query exceed the kernel's "
                         f"{lib.loam_max_candidates()}")
    _check("vm.rows", vm.rows, torch.int16,
           ((gx + 1) * (gy + 1) * (gz + 1) + 1, n_cand * 3), dev)
    if vm.rows.data_ptr() % 16 or (n_cand * 3 * 2) % 16:
        raise ValueError("vm.rows must be 16-byte aligned, row by row")
    _check("vm.scale", vm.scale, torch.float32, (), dev)
    _check("vm.corner", vm.corner, torch.float32, (3,), dev)
    _check("vm.grid", vm.grid, torch.float32, (), dev)
    return n_cand


def fit_and_linearize_merged(vm: MergedDenseVoxelMap, p_map: torch.Tensor,
                             sqrt_r: torch.Tensor, mask: torch.Tensor):
    """K1: gather + 5-NN + plane fit + normal equations at the pose that
    produced ``p_map`` (Q, 3) map-frame queries; ``sqrt_r`` (Q,) is
    ``loam.source_sqrt_range``, ``mask`` (Q,) the query validity.
    Returns (J^T J (6, 6), J^T e (6,), n_valid () int32, Planes)."""
    global K1_LAUNCHES
    dev = p_map.device
    if dev.type == "cpu":
        return fit_and_linearize_merged_plain(vm, p_map, sqrt_r, mask)
    if dev.type != "cuda":
        raise ValueError(f"fit_and_linearize_merged: unsupported device {dev}")
    from ._build import library

    lib = library()
    n_q = p_map.shape[0]
    gx, gy, gz = vm.dims
    n_cand = _check_map(vm, lib, dev)
    _check("p_map", p_map, torch.float32, (n_q, 3), dev)
    _check("sqrt_r", sqrt_r, torch.float32, (n_q,), dev)
    _check("mask", mask, torch.bool, (n_q,), dev)
    centroid = torch.empty((n_q, 3), dtype=torch.float32, device=dev)
    normal = torch.empty((n_q, 3), dtype=torch.float32, device=dev)
    ok = torch.empty((n_q,), dtype=torch.bool, device=dev)
    partials = torch.empty((lib.loam_k1_blocks(n_q), 28), dtype=torch.float32,
                           device=dev)
    jtj, jte, nv = _outputs(dev)
    err = lib.loam_fit_and_linearize_merged(
        vm.rows.data_ptr(), n_cand, vm.scale.data_ptr(), vm.corner.data_ptr(),
        vm.grid.data_ptr(), gx, gy, gz, p_map.data_ptr(), sqrt_r.data_ptr(),
        mask.data_ptr(), n_q, centroid.data_ptr(), normal.data_ptr(),
        ok.data_ptr(), partials.data_ptr(), jtj.data_ptr(), jte.data_ptr(),
        nv.data_ptr(), _stream(dev))
    _raise_on(err, "fit_and_linearize_merged")
    K1_LAUNCHES += 1
    return jtj, jte, nv, Planes(centroid, normal, ok)


# K4's and K3's workspaces per (device, stream): K4's block partials and
# last-block counter; K3's partial sums (two alternating buffers) and grid
# barrier counters. Both kernels leave their counters at zero; launches on
# one stream run in order, so they share a workspace; another stream
# (another thread's work) gets its own.
_k4_workspaces: dict = {}
_gn_workspaces: dict = {}
_ws_lock = threading.Lock()


def _k4_workspace(dev: torch.device, stream: int, n_blocks: int):
    key = (dev.index, stream)
    with _ws_lock:
        ws = _k4_workspaces.get(key)
        if ws is None or ws[0].shape[0] < n_blocks:
            ws = _k4_workspaces[key] = (
                torch.empty((n_blocks, 28), dtype=torch.float32, device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev))
        return ws


def fit_and_linearize_candidates(cand: torch.Tensor, cand_ok: torch.Tensor,
                                 p_map: torch.Tensor, sqrt_r: torch.Tensor,
                                 mask: torch.Tensor):
    """K4: 5-NN + plane fit + normal equations of ``p_map`` (Q, 3) map-frame
    queries against their gathered candidates ``cand`` (Q, C, 3) f32 with
    validity ``cand_ok`` (Q, C) bool, both contiguous; ``sqrt_r`` and
    ``mask`` as for K1. C above the kernel's 256 candidates per query is
    refused, not cut. A masked-out query's candidates and flags are not
    read: its plane is the zero plane (ok false), as in the plain version.
    Returns (J^T J (6, 6), J^T e (6,), n_valid () int32, Planes)."""
    global K4_LAUNCHES
    dev = p_map.device
    if dev.type == "cpu":
        return fit_and_linearize_candidates_plain(cand, cand_ok, p_map,
                                                  sqrt_r, mask)
    if dev.type != "cuda":
        raise ValueError(
            f"fit_and_linearize_candidates: unsupported device {dev}")
    from ._build import library

    lib = library()
    n_q = p_map.shape[0]
    if cand.dim() != 3:
        raise ValueError(f"cand has shape {tuple(cand.shape)}, expected "
                         f"({n_q}, C, 3)")
    n_cand = cand.shape[1]
    if not 1 <= n_cand <= lib.loam_max_candidates():
        raise ValueError(f"{n_cand} candidates per query: the kernel takes 1 "
                         f"to {lib.loam_max_candidates()}")
    _check("cand", cand, torch.float32, (n_q, n_cand, 3), dev)
    _check("cand_ok", cand_ok, torch.bool, (n_q, n_cand), dev)
    _check("p_map", p_map, torch.float32, (n_q, 3), dev)
    _check("sqrt_r", sqrt_r, torch.float32, (n_q,), dev)
    _check("mask", mask, torch.bool, (n_q,), dev)
    n_blocks = lib.loam_k4_blocks(n_q)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        partials, counter = _k4_workspace(dev, stream, n_blocks)
        # the plane set and the sums in one f32 buffer, cut into views
        buf = torch.empty((6 * n_q + 42,), dtype=torch.float32, device=dev)
        centroid = buf[:3 * n_q].view(n_q, 3)
        normal = buf[3 * n_q:6 * n_q].view(n_q, 3)
        jtj = buf[6 * n_q:6 * n_q + 36].view(6, 6)
        jte = buf[6 * n_q + 36:]
        ok = torch.empty((n_q,), dtype=torch.bool, device=dev)
        nv = torch.empty((), dtype=torch.int32, device=dev)
        err = lib.loam_fit_and_linearize_candidates(
            cand.data_ptr(), cand_ok.data_ptr(), n_cand, p_map.data_ptr(),
            sqrt_r.data_ptr(), mask.data_ptr(), n_q,
            centroid.data_ptr(), normal.data_ptr(), ok.data_ptr(),
            partials.data_ptr(), counter.data_ptr(), jtj.data_ptr(),
            jte.data_ptr(), nv.data_ptr(), stream)
    _raise_on(err, "fit_and_linearize_candidates")
    K4_LAUNCHES += 1
    return jtj, jte, nv, Planes(centroid, normal, ok)


def plane_normal_equations(planes: Planes, p_map: torch.Tensor,
                           sqrt_r: torch.Tensor):
    """K2: normal equations of ``p_map`` (Q, 3) against frozen ``planes``.
    Returns (J^T J (6, 6), J^T e (6,), n_valid () int32)."""
    global K2_LAUNCHES
    dev = p_map.device
    if dev.type == "cpu":
        return plane_normal_equations_plain(planes, p_map, sqrt_r)
    if dev.type != "cuda":
        raise ValueError(f"plane_normal_equations: unsupported device {dev}")
    from ._build import library

    lib = library()
    n_q = p_map.shape[0]
    _check("planes.centroid", planes.centroid, torch.float32, (n_q, 3), dev)
    _check("planes.normal", planes.normal, torch.float32, (n_q, 3), dev)
    _check("planes.ok", planes.ok, torch.bool, (n_q,), dev)
    _check("p_map", p_map, torch.float32, (n_q, 3), dev)
    _check("sqrt_r", sqrt_r, torch.float32, (n_q,), dev)
    partials = torch.empty((lib.loam_k2_blocks(n_q), 28), dtype=torch.float32,
                           device=dev)
    jtj, jte, nv = _outputs(dev)
    err = lib.loam_plane_normal_equations(
        planes.centroid.data_ptr(), planes.normal.data_ptr(),
        planes.ok.data_ptr(), p_map.data_ptr(), sqrt_r.data_ptr(), n_q,
        partials.data_ptr(), jtj.data_ptr(), jte.data_ptr(), nv.data_ptr(),
        _stream(dev))
    _raise_on(err, "plane_normal_equations")
    K2_LAUNCHES += 1
    return jtj, jte, nv


# dynamic shared memory a block can get on Hopper (227 KB)
_SMEM_MAX = 232448

# K3's target kinds, as loam_gn_loop_smem numbers them
_KIND = {MergedDenseVoxelMap: 0, DenseVoxelMap: 1, VoxelMap: 2}


def _gn_workspace(lib, dev: torch.device, stream: int):
    key = (dev.index, stream)
    with _ws_lock:
        ws = _gn_workspaces.get(key)
        if ws is None:
            grid = lib.loam_gn_loop_grid()
            if grid <= 0:
                raise RuntimeError("gn_loop_fused: could not size the "
                                   "cooperative grid on this device")
            partials = torch.zeros(
                (2, grid, lib.loam_gn_loop_partial_stride()),
                dtype=torch.float32, device=dev)
            counters = torch.zeros((2,), dtype=torch.int32, device=dev)
            ws = _gn_workspaces[key] = (partials, counters)
        return ws


# candidates per query the kernels take (csrc/loam_kernels.cu kMaxCand)
MAX_CANDIDATES = 256


def target_kind(vm) -> int:
    """K3's number for a LOAM target (0 merged map, 1 dense map, 2 sorted
    table), after the rules the kernel sets: at most MAX_CANDIDATES
    candidates per query (8 M on a dense map, 27 M on a table) and a table
    with at least one row. Raises TypeError for anything else."""
    kind = _KIND.get(type(vm))
    if kind is None:
        raise TypeError(f"gn_loop_fused: not a LOAM target: "
                        f"{type(vm).__name__}")
    if kind == 2 and vm.keys.shape[0] < 1:
        raise ValueError("gn_loop_fused: the sorted table has no row")
    n_cand = 27 * vm.slab.shape[1] if kind == 2 else 8 * vm.slab_pts
    if not 1 <= n_cand <= MAX_CANDIDATES:
        raise ValueError(f"gn_loop_fused: {n_cand} candidates per query: the "
                         f"kernel takes 1 to {MAX_CANDIDATES}")
    return kind


def _check_dense(dm: DenseVoxelMap, dev) -> None:
    gx, gy, gz = dm.dims
    m = dm.slab_pts
    _check("dm.slab", dm.slab, torch.float32, (gx * gy * gz + 1, 3 * m), dev)
    _check("dm.corner", dm.corner, torch.float32, (3,), dev)
    _check("dm.grid", dm.grid, torch.float32, (), dev)


def _check_table(vm: VoxelMap, dev) -> None:
    n, m = vm.keys.shape[0], vm.slab_size
    _check("vm.keys", vm.keys, torch.int32, (n,), dev)
    _check("vm.slab", vm.slab, torch.float32, (n, m, 3), dev)
    _check("vm.counts", vm.counts, torch.int32, (n,), dev)
    _check("vm.origin", vm.origin, torch.float32, (3,), dev)
    _check("vm.grid", vm.grid, torch.float32, (), dev)


def gn_loop_fused(xyz: torch.Tensor, mask: torch.Tensor, vm,
                  init_pose: torch.Tensor, max_iters: int,
                  degen_per_row: float) -> torch.Tensor:
    """K3: the whole GN registration of one scan, ``xyz`` (Q, 3) sensor-frame
    points with validity ``mask`` (Q,), against ``vm`` (a merged map, a
    dense map or a sorted voxel table) from ``init_pose`` (4, 4), in one
    launch. Returns the (GN_ROW,) f32 result row on the device: the
    re-orthonormalized pose (16), then converged, iterations, gathers and
    the last linearization's n_valid.

    CUDA tensors only: the plain version of this kernel is the Python loop
    ``loam.gn_loop_stepwise``, which ``loam.gn_loop`` runs for CPU tensors.
    A target the kernel cannot take (more than 256 candidates per query,
    more shared memory than a block has) raises.
    """
    global K3_LAUNCHES
    kind = target_kind(vm)
    dev = xyz.device
    if dev.type != "cuda":
        raise ValueError(f"gn_loop_fused: unsupported device {dev}")
    if max_iters < 1:
        raise ValueError("gn_loop_fused: max_iters must be at least 1")
    from ._build import library

    lib = library()
    n_q = xyz.shape[0]
    if kind == 0:
        n_cand = _check_map(vm, lib, dev)
    elif kind == 1:
        _check_dense(vm, dev)
    else:
        _check_table(vm, dev)
    _check("xyz", xyz, torch.float32, (n_q, 3), dev)
    _check("mask", mask, torch.bool, (n_q,), dev)
    _check("init_pose", init_pose, torch.float32, (4, 4), dev)
    with torch.cuda.device(dev):
        smem = lib.loam_gn_loop_smem(n_q, kind)
        if not 0 <= smem <= _SMEM_MAX:
            raise ValueError(f"gn_loop_fused: {n_q} queries need {smem} bytes "
                             f"of shared memory per block (limit {_SMEM_MAX})")
        stream = _stream(dev)
        partials, counters = _gn_workspace(lib, dev, stream)
        out = torch.empty((GN_ROW,), dtype=torch.float32, device=dev)
        common = (xyz.data_ptr(), mask.data_ptr(), n_q, init_pose.data_ptr(),
                  int(max_iters), float(degen_per_row), partials.data_ptr(),
                  counters.data_ptr(), out.data_ptr(), stream)
        if kind == 0:
            gx, gy, gz = vm.dims
            err = lib.loam_gn_loop(
                vm.rows.data_ptr(), n_cand, vm.scale.data_ptr(),
                vm.corner.data_ptr(), vm.grid.data_ptr(), gx, gy, gz,
                *common)
        elif kind == 1:
            gx, gy, gz = vm.dims
            err = lib.loam_gn_loop_dense(
                vm.slab.data_ptr(), vm.slab_pts, vm.corner.data_ptr(),
                vm.grid.data_ptr(), gx, gy, gz, *common)
        else:
            err = lib.loam_gn_loop_table(
                vm.keys.data_ptr(), vm.keys.shape[0], vm.slab.data_ptr(),
                vm.counts.data_ptr(), vm.slab_size, vm.origin.data_ptr(),
                vm.grid.data_ptr(), *common)
    _raise_on(err, "gn_loop_fused")
    K3_LAUNCHES += 1
    return out


def barrier_probe(dev: torch.device, n: int) -> None:
    """Launch ``n`` grid barriers on K3's grid and nothing else (a
    measurement aid: the barrier's cost per GN iteration)."""
    from ._build import library

    lib = library()
    with torch.cuda.device(dev):
        stream = _stream(dev)
        _, counters = _gn_workspace(lib, dev, stream)
        err = lib.loam_barrier_probe(counters.data_ptr(), int(n), stream)
    _raise_on(err, "barrier_probe")


def empty_launch(dev: torch.device) -> None:
    """Launch a kernel that does nothing (a measurement aid: the device time
    of a bare launch, beside which K4's is read)."""
    from ._build import library

    lib = library()
    with torch.cuda.device(dev):
        err = lib.loam_empty(_stream(dev))
    _raise_on(err, "empty_launch")
