"""Point-cloud registration behind one scan2Map-shaped API.

Port of ``simpleslam_tpu/models/registration.py``: each register owns its
target builder, and the per-scan step is downsample -> compact -> scan2map
-> planar clamp. LOAM (``PCR/src/LoamRegister.cpp:99-223``), NDT and VGICP
are odometry registers, selected by ``frontend.pcr``; VGICP also verifies
loop closures (``VgicpRegister.init_for_lc``). Every tensor lives on the
device named by the config key ``torch.device``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import geometry as geo
from ..ops import loam as loam_ops
from ..ops import ndt as ndt_ops
from ..ops import pointcloud as pcops
from ..ops import vgicp as vgicp_ops
from ..ops import voxel as vox
from ..ops.pointcloud import PointCloud
from ..utils.config import Params


def _fetch_pose(pose: torch.Tensor) -> np.ndarray:
    """A (4, 4) pose read to the host as f64."""
    return pose.cpu().numpy().astype(np.float64)


def _fetch_result(pose: torch.Tensor, converged: torch.Tensor,
                  fitness: torch.Tensor) -> Tuple[np.ndarray, bool, float]:
    """The one host read of a registration result: the pose, the converged
    flag and the fitness, packed."""
    packed = torch.cat([pose.reshape(16), converged.reshape(1).to(pose.dtype),
                        fitness.reshape(1).to(pose.dtype)]).cpu().numpy()
    return (packed[:16].reshape(4, 4).astype(np.float64),
            bool(packed[16] > 0.5), float(packed[17]))


def register_kind(ds: PointCloud, target, init_pose: torch.Tensor, kind: str,
                  degen: float = 0.0):
    """Dispatch to the configured backend: (pose (4, 4), converged () bool,
    fitness (), iters (), gathers (), support ()), all tensors on the pose's
    device, so the caller decides when to read them. ``gathers`` counts
    neighbourhood sweeps (== iters for NDT and VGICP); ``support`` is the
    final normal-equation row count (0 where the backend has none). Nothing
    in here reads the device: LOAM's loop runs inside one kernel, NDT and
    VGICP run their step a fixed number of times."""
    dev = init_pose.device
    fit = torch.zeros((), dtype=torch.float32, device=dev)
    if kind == "loam":
        res = loam_ops.gn_loop(ds, target, init_pose, degen_per_row=degen)
        return (res.pose, res.converged, fit, res.iters, res.n_gathers,
                res.n_valid)
    no_support = torch.zeros((), dtype=torch.int32, device=dev)
    if kind == "ndt":
        res = ndt_ops.align(ds, target, init_pose)
        return (res.pose, res.converged, fit, res.iters, res.iters,
                no_support)
    if kind == "vgicp":
        res = vgicp_ops.align(ds, target, init_pose)
        return (res.pose, res.converged, res.fitness, res.iters, res.iters,
                no_support)
    raise ValueError(f"unknown registration kind {kind!r}")


def _fused_window_target(kf_buf: torch.Tensor, idx: torch.Tensor,
                         poses: torch.Tensor, kf_mask: torch.Tensor,
                         center: torch.Tensor, grid: float, builder):
    """Submap target rebuild on the device from resident keyframe clouds
    (MapManager::updateMap semantics, MapManager.cpp:151-201): gather the
    window's keyframes, transform them to the map frame, concatenate,
    voxel-downsample at the map grid about ``center`` and build the
    register's target.

    kf_buf: (MAXKF, C, 3) resident clouds (PAD_COORD padded, sensor frame);
    idx/poses/kf_mask: (W,), (W, 4, 4), (W,) window selection.
    """
    pts = kf_buf[idx]                                     # (W, C, 3)
    valid = (pts[..., 0] < 0.5 * pcops.PAD_COORD) & kf_mask[:, None]
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    ptsw = torch.einsum("wij,wcj->wci", R, pts) + t[:, None, :]
    xyz = torch.where(valid[..., None], ptsw,
                      torch.full_like(ptsw, pcops.PAD_COORD)).reshape(-1, 3)
    mask = valid.reshape(-1)
    merged = PointCloud(xyz, torch.zeros_like(xyz[:, 0]), mask)
    ds = vox.voxel_downsample(merged, grid, center)
    return builder(ds, center)


class PointCloudRegister:
    """Abstract register (PointCloudRegister.hpp:12-38)."""

    def __init__(self) -> None:
        cfg = Params.get_instance()
        self.tpu_cfg = cfg["tpu"]
        self.device = torch.device(cfg["torch"]["device"])
        self.planar_clamp = bool(cfg["frontend"].get("planar_clamp", True))
        self.degen_per_row = (
            loam_ops.DEGEN_EIGEN_PER_ROW
            if cfg["frontend"].get("degeneracy_guard", False) else 0.0)
        self._fitness: float = float("inf")
        self.is_converge: bool = False

    KIND = ""

    def build_target(self, submap: PointCloud, origin: torch.Tensor):
        raise NotImplementedError

    def _align(self, src: PointCloud, target, pose: torch.Tensor,
               degen_per_row: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(refined pose (4, 4), converged () bool, fitness ()), all on the
        device. The per-scan paths call it: it may read the device to stop
        its loop early."""
        raise NotImplementedError

    def scan2map(self, src: PointCloud, target,
                 pose: np.ndarray) -> Tuple[np.ndarray, bool]:
        """Refine ``pose`` (4, 4 numpy) registering ``src`` to ``target``.
        Returns (refined pose, converged)."""
        return self._finish(*self._align(src, target, self.pose_tensor(pose),
                                         0.0))

    def _finish(self, p: torch.Tensor, conv: torch.Tensor,
                fit: torch.Tensor) -> Tuple[np.ndarray, bool]:
        out, self.is_converge, fitness = _fetch_result(p, conv, fit)
        if self.KIND == "vgicp":
            self._fitness = fitness
        return out, self.is_converge

    def get_fitness_score(self) -> float:
        """The last VGICP registration's fitness (inf before one ran, and
        for the registers that compute none)."""
        return self._fitness

    def pose_tensor(self, pose: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(pose, np.float32), device=self.device)

    def clamp(self, pose: np.ndarray) -> np.ndarray:
        """The planar clamp alone (SixDof2Mobile), computed in f32 on the
        device like the registered poses."""
        return _fetch_pose(geo.six_dof_to_mobile(self.pose_tensor(pose)))

    def odometry_step(self, raw: PointCloud, target, pose: np.ndarray,
                      grid: float, ds_capacity: int):
        """Per-scan path: (clamped pose f64, converged, ds_scan)."""
        ds = pcops.compact(vox.voxel_downsample(raw, grid), ds_capacity)
        p, conv, fit = self._align(ds, target, self.pose_tensor(pose),
                                   float(self.degen_per_row))
        if self.planar_clamp:
            p = geo.six_dof_to_mobile(p)
        out, conv = self._finish(p, conv, fit)
        return out, conv, ds

    def build_target_from_window(self, kf_buf: torch.Tensor, idx: np.ndarray,
                                 poses: np.ndarray, kf_mask: np.ndarray,
                                 center: np.ndarray, grid: float):
        """Device-side submap rebuild from resident keyframe clouds; only
        indices and poses come from the host (``_fused_window_target``)."""
        dev = self.device
        return _fused_window_target(
            kf_buf, torch.as_tensor(idx, dtype=torch.int64).to(dev),
            torch.as_tensor(poses, dtype=torch.float32).to(dev),
            torch.as_tensor(kf_mask).to(dev),
            torch.as_tensor(center, dtype=torch.float32).to(dev), grid,
            self.build_target)

    def build_target_from_raw(self, pc: PointCloud, grid: float,
                              origin: torch.Tensor, cap: int):
        """Submap rebuild: downsample + compact + target build.
        Returns (ds_submap, target)."""
        ds = pcops.compact(vox.voxel_downsample(pc, grid, origin), cap)
        return ds, self.build_target(ds, origin)


class LoamRegister(PointCloudRegister):
    """LOAM point-to-plane GN on SE(3) (PCR/src/LoamRegister.cpp:99-223)."""

    KIND = "loam"

    # neighbour-search voxel size: twice the 1.0 m kNN gate radius, so the
    # corner-selected 2x2x2 block covers the search ball
    TARGET_GRID = 2.0

    def build_target(self, submap: PointCloud,
                     origin: torch.Tensor) -> vox.MergedDenseVoxelMap:
        # the config's dims are in 1 m voxels; the target grid is 2 m
        dims = tuple(max(int(d) // 2, 1)
                     for d in self.tpu_cfg["dense_grid_dims"])
        return vox.build_merged_dense_voxel_map(
            submap, self.TARGET_GRID, origin, dims=dims,
            slab_size=int(self.tpu_cfg.get("loam_slab_size", 24)))

    def _align(self, src, target, pose, degen_per_row):
        res = loam_ops.scan2map(src, target, pose, degen_per_row=degen_per_row)
        return res.pose, res.converged, torch.zeros_like(res.pose[0, 0])


class NdtRegister(PointCloudRegister):
    """OpenMP-NDT equivalent: Gaussian-voxel Newton over the 27-cell
    neighbourhood (adapter parity: PCR/src/NdtRegister.cpp:6-35, resolution
    1.0)."""

    KIND = "ndt"
    RESOLUTION = 1.0

    def build_target(self, submap: PointCloud,
                     origin: torch.Tensor) -> ndt_ops.NdtTarget:
        return ndt_ops.build_target(
            submap, self.RESOLUTION, origin,
            dims=tuple(int(d) for d in self.tpu_cfg["dense_grid_dims"]))

    def _align(self, src, target, pose, degen_per_row):
        res = ndt_ops.align(src, target, pose, early_exit=True)
        return res.pose, res.converged, torch.zeros_like(res.score)


class VgicpRegister(PointCloudRegister):
    """FastVGICP equivalent: voxelized distribution-to-distribution GICP
    (adapter parity: PCR/src/VgicpRegister.cpp:6-48, resolution 1.0): an
    odometry register, and the loop-closure verifier after
    ``init_for_lc``."""

    KIND = "vgicp"
    RESOLUTION = 1.0

    def __init__(self) -> None:
        super().__init__()
        self._lc_mode = False

    def init_for_lc(self) -> None:
        """Loosen for loop-closure verification (VgicpRegister.cpp:26-33)."""
        self._lc_mode = True

    def build_target(self, submap: PointCloud,
                     origin: torch.Tensor) -> vgicp_ops.VgicpTarget:
        return vgicp_ops.build_target(
            submap, self.RESOLUTION, origin,
            dims=tuple(int(d) for d in self.tpu_cfg["dense_grid_dims"]))

    def _align(self, src, target, pose, degen_per_row):
        res = vgicp_ops.align(src, target, pose, lc_mode=self._lc_mode,
                              early_exit=True)
        return res.pose, res.converged, res.fitness


def make_register(pcr_type: Optional[str] = None) -> PointCloudRegister:
    """Config-driven factory (LidarOdometry.cpp:44-54 semantics incl. the
    unknown-type error)."""
    if pcr_type is None:
        pcr_type = Params.get_instance()["frontend"]["pcr"]
    if pcr_type == "loam":
        return LoamRegister()
    if pcr_type == "ndt":
        return NdtRegister()
    if pcr_type == "vgicp":
        return VgicpRegister()
    raise ValueError(
        f"such pcr type({pcr_type}) is not exist, please implemented your self!"
    )
