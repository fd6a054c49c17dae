"""Fixed-capacity padded point clouds as torch tensors.

Port of ``simpleslam_tpu/ops/pointcloud.py``: a cloud is (capacity, 3) f32
coordinates plus a validity mask; padding rows carry the far sentinel
``PAD_COORD`` so they can never win a nearest-neighbour race. The fixed
capacities are the reference's, so shapes stay static scan to scan.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Sentinel coordinate for padding rows: far from any plausible scan content
# but small enough that squared distances stay finite in f32.
PAD_COORD = 1.0e6


class PointCloud(NamedTuple):
    """Padded cloud: xyz (N, 3) f32, intensity (N,) f32, mask (N,) bool."""

    xyz: torch.Tensor
    intensity: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


def from_arrays(xyz: np.ndarray, intensity: np.ndarray, mask: np.ndarray,
                device) -> PointCloud:
    """Wrap already-padded host arrays (e.g. a reference-package cloud's
    ``np.asarray`` leaves) as a cloud on ``device``."""
    return PointCloud(
        torch.tensor(np.asarray(xyz, np.float32), device=device),
        torch.tensor(np.asarray(intensity, np.float32), device=device),
        torch.tensor(np.asarray(mask, bool), device=device))


def from_numpy(xyz: np.ndarray, capacity: int, device,
               intensity: Optional[np.ndarray] = None) -> PointCloud:
    """Pad/truncate a host (n, 3) array to a cloud of ``capacity`` on
    ``device``. NaN rows are dropped (the reference strips NaNs on ingest)."""
    from .. import native

    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    if intensity is None:
        out, mask, _ = native.pad_cloud(xyz, capacity, PAD_COORD)
        inten = np.zeros((capacity,), dtype=np.float32)
        return from_arrays(out, inten, mask, device)
    intensity = np.asarray(intensity, dtype=np.float32).reshape(-1)
    finite = np.isfinite(xyz).all(axis=1)
    xyz, intensity = xyz[finite], intensity[finite]
    n = min(xyz.shape[0], capacity)
    out = np.full((capacity, 3), PAD_COORD, dtype=np.float32)
    out[:n] = xyz[:n]
    inten = np.zeros((capacity,), dtype=np.float32)
    inten[:n] = intensity[:n]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return from_arrays(out, inten, mask, device)


def to_numpy(pc: PointCloud) -> np.ndarray:
    """Extract the valid points as a host (n, 3) array."""
    return pc.xyz[pc.mask].cpu().numpy()


def compact(pc: PointCloud, out_capacity: Optional[int] = None) -> PointCloud:
    """Stable-move valid points to the front; optionally shrink capacity.

    A stable sort on the inverted mask, as the reference does: valid points
    keep their relative order, so a cut to ``out_capacity`` drops the same
    points in both packages.
    """
    out_capacity = out_capacity or pc.capacity
    order = torch.sort((~pc.mask).to(torch.uint8), stable=True).indices
    order = order[:out_capacity]
    mask = pc.mask[order]
    xyz = torch.where(mask[:, None], pc.xyz[order],
                      torch.full_like(pc.xyz[order], PAD_COORD))
    return PointCloud(xyz, pc.intensity[order], mask)
