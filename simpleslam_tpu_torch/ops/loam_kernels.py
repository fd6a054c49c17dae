"""Wrappers of the LOAM CUDA kernels (``csrc/loam_kernels.cu``), their plain
PyTorch versions, and launch counters.

Both kernels replace the Pallas TPU kernel
``simpleslam_tpu/ops/loam_pallas.py::_kernel`` (via ``normal_equations_t``):

- K1 ``fit_and_linearize_merged``: the whole TPU kernel with the merged-row
  gather folded in — per query, read one int16 merged row, pick the 5
  nearest candidates, fit and gate the plane, and reduce J^T J, J^T e and
  n_valid; also returns the plane set. Bound on the card: Q scattered
  1,152 B row reads plus per-query selection work.
- K2 ``plane_normal_equations``: the TPU kernel's second half against a
  frozen plane set. Bound on the card: launch overhead and a (Q, 6) stream.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (built at first use) or raises. Nothing falls back.
The counters count kernel launches, and plain-version calls on CUDA tensors
(which the main path never makes).
"""

from __future__ import annotations

import torch

from . import loam
from .loam import Planes
from .voxel import MergedDenseVoxelMap, gather_neighbors_merged

K1_LAUNCHES = 0
K2_LAUNCHES = 0
K1_PLAIN_CUDA_CALLS = 0
K2_PLAIN_CUDA_CALLS = 0


def reset_counts() -> None:
    global K1_LAUNCHES, K2_LAUNCHES, K1_PLAIN_CUDA_CALLS, K2_PLAIN_CUDA_CALLS
    K1_LAUNCHES = K2_LAUNCHES = K1_PLAIN_CUDA_CALLS = K2_PLAIN_CUDA_CALLS = 0


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
    n_cand = 8 * vm.slab_pts
    if n_cand > lib.loam_max_candidates():
        raise ValueError(f"{n_cand} candidates per query exceed the kernel's "
                         f"{lib.loam_max_candidates()}")
    _check("vm.rows", vm.rows, torch.int16,
           ((gx + 1) * (gy + 1) * (gz + 1) + 1, n_cand * 3), dev)
    if vm.rows.data_ptr() % 16:
        raise ValueError("vm.rows must be 16-byte aligned")
    _check("vm.scale", vm.scale, torch.float32, (), dev)
    _check("vm.corner", vm.corner, torch.float32, (3,), dev)
    _check("vm.grid", vm.grid, torch.float32, (), dev)
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
