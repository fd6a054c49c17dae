"""Point-cloud registration behind one scan2Map-shaped API (LOAM).

Port of ``simpleslam_tpu/models/registration.py`` for the LOAM backend
(``PCR/src/LoamRegister.cpp:99-223``): the register owns its target builder
(the merged dense voxel map) and the per-scan step downsample -> compact ->
scan2map -> planar clamp. Every tensor lives on the device named by the
config key ``torch.device``. NDT and VGICP are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import geometry as geo
from ..ops import loam as loam_ops
from ..ops import pointcloud as pcops
from ..ops import voxel as vox
from ..ops.pointcloud import PointCloud
from ..utils.config import Params


def _fetch_pose(pose: torch.Tensor) -> np.ndarray:
    """The one host read of a registration result."""
    return pose.cpu().numpy().astype(np.float64)


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
        self.is_converge: bool = False

    def build_target(self, submap: PointCloud, origin: torch.Tensor):
        raise NotImplementedError

    def _align(self, src: PointCloud, target, pose: torch.Tensor,
               degen_per_row: float) -> Tuple[torch.Tensor, bool]:
        raise NotImplementedError

    def scan2map(self, src: PointCloud, target,
                 pose: np.ndarray) -> Tuple[np.ndarray, bool]:
        """Refine ``pose`` (4, 4 numpy) registering ``src`` to ``target``.
        Returns (refined pose, converged)."""
        p, self.is_converge = self._align(src, target, self.pose_tensor(pose),
                                          0.0)
        return _fetch_pose(p), self.is_converge

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
        p, self.is_converge = self._align(ds, target, self.pose_tensor(pose),
                                          float(self.degen_per_row))
        if self.planar_clamp:
            p = geo.six_dof_to_mobile(p)
        return _fetch_pose(p), self.is_converge, ds

    def build_target_from_raw(self, pc: PointCloud, grid: float,
                              origin: torch.Tensor, cap: int):
        """Submap rebuild: downsample + compact + target build.
        Returns (ds_submap, target)."""
        ds = pcops.compact(vox.voxel_downsample(pc, grid, origin), cap)
        return ds, self.build_target(ds, origin)


class LoamRegister(PointCloudRegister):
    """LOAM point-to-plane GN on SE(3) (PCR/src/LoamRegister.cpp:99-223)."""

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
        return res.pose, res.converged


def make_register(pcr_type: Optional[str] = None) -> PointCloudRegister:
    """Config-driven factory (LidarOdometry.cpp:44-54 semantics incl. the
    unknown-type error)."""
    if pcr_type is None:
        pcr_type = Params.get_instance()["frontend"]["pcr"]
    if pcr_type == "loam":
        return LoamRegister()
    if pcr_type in ("ndt", "vgicp"):
        raise NotImplementedError(
            f"pcr type {pcr_type!r} is not ported to simpleslam_tpu_torch yet "
            "(ROADMAP item 10); use 'loam'")
    raise ValueError(
        f"such pcr type({pcr_type}) is not exist, please implemented your self!"
    )
