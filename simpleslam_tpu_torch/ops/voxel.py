"""Voxel-grid machinery on torch tensors: downsampling and the merged dense
voxel map that LOAM registers against.

Port of the main-path subset of ``simpleslam_tpu/ops/voxel.py``. Every
reduction here runs in a fixed order with static shapes: segments come from a
stable sort plus ``searchsorted`` on the sorted keys (no ``unique``, no
boolean indexing, so no hidden host sync), and each voxel's sum is taken over
its first points in sorted order by a loop over ranks (no float atomics, so
results repeat bit for bit run to run on the GPU).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .pointcloud import PAD_COORD, PointCloud

_BITS = 10
_HALF = 1 << (_BITS - 1)  # 512
_RANGE = 1 << _BITS  # 1024
INVALID_KEY = 1 << 30  # sorts after any packed key (max 2^30 - 1)


def voxel_coords(xyz: torch.Tensor, origin: torch.Tensor,
                 grid: torch.Tensor) -> torch.Tensor:
    """(..., 3) points -> (..., 3) int32 voxel coords, offset to [0, 1024)."""
    return torch.floor((xyz - origin) / grid).to(torch.int32) + _HALF


def pack_coords(c: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., 3) int32 coords + validity -> packed int32 key (INVALID if out
    of range)."""
    in_range = torch.all((c >= 0) & (c < _RANGE), dim=-1)
    key = (c[..., 0] << (2 * _BITS)) | (c[..., 1] << _BITS) | c[..., 2]
    return torch.where(valid & in_range, key,
                       torch.full_like(key, INVALID_KEY))


def voxel_keys(xyz: torch.Tensor, mask: torch.Tensor, origin: torch.Tensor,
               grid) -> torch.Tensor:
    grid = torch.as_tensor(grid, dtype=xyz.dtype, device=xyz.device)
    return pack_coords(voxel_coords(xyz, origin, grid), mask)


def _sorted_segments(keys: torch.Tensor, xyz: torch.Tensor,
                     intensity: torch.Tensor):
    """Sort points by voxel key and derive the segment structure.

    Returns (xyz_s, inten_s, seg_start, seg_count, num_segments): segment s
    (voxels in ascending key order) holds sorted points
    [seg_start[s], seg_start[s] + seg_count[s]); segments at or past
    ``num_segments`` (a device scalar) are empty.
    """
    n = keys.shape[0]
    keys_s, order = torch.sort(keys, stable=True)
    prev = torch.cat([keys_s.new_full((1,), -1), keys_s[:-1]])
    is_new = keys_s != prev
    invalid = keys_s == INVALID_KEY
    seg_id = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    # invalid keys sort last, so seg_id stays nondecreasing after this
    seg_id = torch.where(invalid, torch.full_like(seg_id, n), seg_id)
    num_segments = torch.max(torch.where(invalid, torch.zeros_like(seg_id),
                                         seg_id + 1))
    ids = torch.arange(n, dtype=torch.int32, device=keys.device)
    seg_start = torch.searchsorted(seg_id, ids)
    seg_count = torch.searchsorted(seg_id, ids, right=True) - seg_start
    return xyz[order], intensity[order], seg_start, seg_count, num_segments


def voxel_downsample(pc: PointCloud, grid, origin: Optional[torch.Tensor] = None,
                     max_pts_per_voxel: int = 20,
                     min_pts_per_voxel: int = 0) -> PointCloud:
    """Centroid-per-voxel downsample (VoxelDownSampleV2 semantics).

    Each voxel gives the centroid of its first ``max_pts_per_voxel`` points
    in stable key order and the intensity of its first point; voxels with
    ``<= min_pts_per_voxel`` points are dropped. Output keeps the input
    capacity, compacted to the front in voxel-key order.
    """
    xyz = pc.xyz
    n = pc.capacity
    if origin is None:
        origin = torch.zeros(3, dtype=xyz.dtype, device=xyz.device)
    keys = voxel_keys(xyz, pc.mask, origin, grid)
    xyz_s, inten_s, start, count, num_segments = _sorted_segments(
        keys, xyz, pc.intensity)
    last = n - 1
    used = torch.clamp(count, max=max_pts_per_voxel)
    # rank-ordered accumulation: sum = ((p0 + p1) + p2) + ..., the order a
    # sequential segment sum over the sorted points takes
    sums = torch.zeros_like(xyz_s)
    for r in range(max_pts_per_voxel):
        p = xyz_s[torch.clamp(start + r, max=last)]
        sums = sums + torch.where((r < used)[:, None], p, torch.zeros_like(p))
    centroids = sums / torch.clamp(used, min=1)[:, None].to(sums.dtype)
    seg_ids = torch.arange(n, device=xyz.device)
    out_mask = (seg_ids < num_segments) & (count > min_pts_per_voxel)
    out_xyz = torch.where(out_mask[:, None], centroids,
                          torch.full_like(centroids, PAD_COORD))
    first_inten = torch.where(seg_ids < num_segments,
                              inten_s[torch.clamp(start, max=last)],
                              torch.zeros_like(inten_s))
    return PointCloud(out_xyz, first_inten, out_mask)


# ---------------------------------------------------------------------------
# Dense local voxel grid and its merged 2x2x2 form (the LOAM target)
# ---------------------------------------------------------------------------


class DenseVoxelMap(NamedTuple):
    """Dense voxel grid with per-voxel point slabs in flat rows.

    slab:   (Gx*Gy*Gz + 1, M*3) f32 — row v holds voxel v's points as
            [x0 y0 z0 x1 ...], PAD_COORD filling unused lanes; the last row
            is the all-padding sentinel
    counts: (Gx*Gy*Gz + 1,) int32 points per row (<= M)
    corner: (3,) f32 window minimum corner; grid: () f32
    """

    slab: torch.Tensor
    counts: torch.Tensor
    corner: torch.Tensor
    grid: torch.Tensor
    dims: Tuple[int, int, int]
    slab_pts: int


def _dense_flat(c: torch.Tensor, dims: Tuple[int, int, int],
                valid: torch.Tensor) -> torch.Tensor:
    """(..., 3) int voxel coords -> flat index, sentinel G for invalid."""
    gx, gy, gz = dims
    in_range = (
        (c[..., 0] >= 0) & (c[..., 0] < gx)
        & (c[..., 1] >= 0) & (c[..., 1] < gy)
        & (c[..., 2] >= 0) & (c[..., 2] < gz)
    )
    flat = (c[..., 0] * gy + c[..., 1]) * gz + c[..., 2]
    return torch.where(valid & in_range, flat,
                       torch.full_like(flat, gx * gy * gz))


def build_dense_voxel_map(pc: PointCloud, grid, center: torch.Tensor,
                          dims: Tuple[int, int, int],
                          slab_size: int) -> DenseVoxelMap:
    """Sort a padded cloud into a dense grid window centred at ``center``.

    Points outside the window are dropped; each voxel keeps its first
    ``slab_size`` points in stable sort order. Row starts and counts come
    from ``searchsorted`` on the sorted voxel ids.
    """
    dev = pc.xyz.device
    grid = torch.as_tensor(grid, dtype=pc.xyz.dtype, device=dev)
    gx, gy, gz = dims
    g_total = gx * gy * gz
    dims_t = torch.tensor([gx, gy, gz], dtype=pc.xyz.dtype, device=dev)
    corner = center - dims_t * grid / 2.0
    c = torch.floor((pc.xyz - corner) / grid).to(torch.int32)
    flat = _dense_flat(c, dims, pc.mask)
    flat_s, order = torch.sort(flat, stable=True)
    xyz_s = pc.xyz[order]
    n = flat_s.shape[0]
    vids = torch.arange(g_total + 1, dtype=flat_s.dtype, device=dev)
    start = torch.searchsorted(flat_s, vids)
    counts = torch.searchsorted(flat_s, vids, right=True) - start
    m = slab_size
    lanes = torch.arange(m, device=dev)
    src = torch.clamp(torch.clamp(start, max=n - 1)[:, None] + lanes[None, :],
                      max=n - 1)
    valid = lanes[None, :] < torch.clamp(counts, max=m)[:, None]
    pts = xyz_s[src]                                          # (G+1, M, 3)
    pts = torch.where(valid[..., None], pts, torch.full_like(pts, PAD_COORD))
    pts[g_total] = PAD_COORD                    # sentinel row: pure padding
    counts = torch.clamp(counts, max=m).to(torch.int32)
    counts[g_total] = 0
    return DenseVoxelMap(pts.reshape(g_total + 1, m * 3), counts, corner,
                         grid, dims, slab_size)


# int16 quantization of merged rows, corner-relative: a position is stored
# as round((p - corner) / scale) - 2^14 with scale = extent / 32767 (about
# 5.9 mm over a 192 m window); 32767 marks padding.
MERGED_PAD_Q = 32767
MERGED_Q_OFF = 1 << 14


class MergedDenseVoxelMap(NamedTuple):
    """Dense grid whose row b holds the 2x2x2 block at base = b - 1, merged.

    rows:  ((Gx+1)*(Gy+1)*(Gz+1) + 1, 8*M*3) int16 corner-relative
           quantized coords (MERGED_PAD_Q padding; the last row is the
           all-padding sentinel). Row b serves base = b - 1, so queries in
           the low half-voxel shell (base = -1) still find a real row.
    scale: () f32 metres per quantization count
    corner: (3,) f32; grid: () f32; dims: the underlying grid dims;
    slab_pts: points per voxel M
    """

    rows: torch.Tensor
    scale: torch.Tensor
    corner: torch.Tensor
    grid: torch.Tensor
    dims: Tuple[int, int, int]
    slab_pts: int

    @classmethod
    def from_numpy(cls, rows: np.ndarray, scale, corner, grid,
                   dims: Tuple[int, int, int], slab_pts: int,
                   device) -> "MergedDenseVoxelMap":
        """A map from host arrays (e.g. one the reference package built)."""
        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        return cls(torch.tensor(np.asarray(rows, np.int16), device=device),
                   f32(scale), f32(corner), f32(grid),
                   tuple(int(d) for d in dims), int(slab_pts))


def build_merged_dense_voxel_map(pc: PointCloud, grid, center: torch.Tensor,
                                 dims: Tuple[int, int, int],
                                 slab_size: int) -> MergedDenseVoxelMap:
    """Dense slab build, int16 quantization and 2x2x2 neighbourhood merge."""
    dm = build_dense_voxel_map(pc, grid, center, dims, slab_size)
    gx, gy, gz = dims
    m3 = slab_size * 3
    dev = pc.xyz.device
    scale = torch.tensor(float(max(dims)), dtype=torch.float32,
                         device=dev) * dm.grid / 32767.0
    flat = dm.slab[:-1].reshape(-1, 3)
    valid = flat[:, 0] < 0.5 * PAD_COORD
    q = torch.clamp(torch.round((flat - dm.corner) / scale), 0, 32766
                    ).to(torch.int16) - MERGED_Q_OFF
    q = torch.where(valid[:, None], q, torch.full_like(q, MERGED_PAD_Q))
    corner, grid_t = dm.corner, dm.grid
    del dm, flat, valid  # free the f32 slab before the merged rows exist
    # one voxel of padding on both sides: the low side makes row 0 serve
    # base = -1, the high side closes the block at base = G - 1
    padded = torch.full((gx + 2, gy + 2, gz + 2, m3), MERGED_PAD_Q,
                        dtype=torch.int16, device=dev)
    padded[1:-1, 1:-1, 1:-1] = q.reshape(gx, gy, gz, m3)
    del q
    n_rows = (gx + 1) * (gy + 1) * (gz + 1)
    rows = torch.empty((n_rows + 1, 8 * m3), dtype=torch.int16, device=dev)
    body = rows[:n_rows].view(gx + 1, gy + 1, gz + 1, 8 * m3)
    k = 0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                body[..., k * m3:(k + 1) * m3] = padded[
                    dx:dx + gx + 1, dy:dy + gy + 1, dz:dz + gz + 1]
                k += 1
    rows[n_rows] = MERGED_PAD_Q
    return MergedDenseVoxelMap(rows, scale, corner, grid_t, dims, slab_size)


def gather_neighbors_merged(mm: MergedDenseVoxelMap, queries: torch.Tensor,
                            q_mask: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner-selected 2x2x2 candidate gather, ONE merged row per query.

    queries (Q, 3) -> (candidates (Q, 8M, 3) f32 metres, PAD_COORD where
    invalid; validity (Q, 8M)). Rows are indexed at base + 1 in the
    (G+1)-per-axis merged index space.
    """
    base = torch.floor((queries - mm.corner) / mm.grid - 0.5).to(torch.int32)
    gx, gy, gz = mm.dims
    flat = _dense_flat(base + 1, (gx + 1, gy + 1, gz + 1), q_mask)
    q = mm.rows[flat]                                   # (Q, 8*M*3) int16
    qp = q.reshape(q.shape[0], 8 * mm.slab_pts, 3)
    valid = qp[..., 0] != MERGED_PAD_Q
    # dequantize with one fused multiply-add, as the reference's compiled
    # program and the CUDA kernel do, so candidates agree bit for bit
    pts = torch.addcmul(mm.corner, qp.to(torch.float32) + float(MERGED_Q_OFF),
                        mm.scale)
    pts = torch.where(valid[..., None], pts, torch.full_like(pts, PAD_COORD))
    return pts, valid
