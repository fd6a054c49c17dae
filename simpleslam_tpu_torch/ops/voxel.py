"""Voxel-grid machinery on torch tensors: downsampling, the merged dense
voxel map that LOAM registers against, and the dense point and Gaussian
maps that VGICP verifies loop closures with.

Port of ``simpleslam_tpu/ops/voxel.py``: the dense grids, and the
sorted-table ``VoxelMap`` / ``GaussianVoxelMap`` whose lookups are a key
search (``torch.searchsorted``) instead of index arithmetic. Every
reduction here runs in a fixed order with static shapes: segments come from a
stable sort plus ``searchsorted`` on the sorted keys (no ``unique``, no
boolean indexing, so no hidden host sync), and each voxel's sum is taken over
its first points in sorted order by a loop over ranks (no float atomics, so
results repeat bit for bit run to run on the GPU).
"""

from __future__ import annotations

import functools
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


def _scalar_tensor(v, dtype, device) -> torch.Tensor:
    """``v`` (a number or a tensor) as a 0-dim tensor on ``device``. A number
    is written by a fill on the device: ``torch.as_tensor`` would copy it
    from host memory, which synchronises (the VGICP register builds a voxel
    map of the source inside the streamed batch)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=device)
    return torch.full((), float(v), dtype=dtype, device=device)


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _i32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.int32), device=device)


def voxel_keys(xyz: torch.Tensor, mask: torch.Tensor, origin: torch.Tensor,
               grid) -> torch.Tensor:
    grid = _scalar_tensor(grid, xyz.dtype, xyz.device)
    return pack_coords(voxel_coords(xyz, origin, grid), mask)


def _sorted_keys(keys: torch.Tensor):
    """Stable sort of the packed keys: (keys_s, order, seg_id,
    num_segments). ``seg_id`` is each sorted point's voxel in ascending key
    order, and ``n`` for invalid keys (which sort last, so it stays
    nondecreasing); ``num_segments`` is a device scalar."""
    n = keys.shape[0]
    keys_s, order = torch.sort(keys, stable=True)
    prev = torch.cat([keys_s.new_full((1,), -1), keys_s[:-1]])
    is_new = keys_s != prev
    invalid = keys_s == INVALID_KEY
    seg_id = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    seg_id = torch.where(invalid, torch.full_like(seg_id, n), seg_id)
    num_segments = torch.max(torch.where(invalid, torch.zeros_like(seg_id),
                                         seg_id + 1))
    return keys_s, order, seg_id, num_segments


def _segment_ranges(seg_id: torch.Tensor, n_ids: int):
    """(start, count) of segments 0 .. n_ids - 1 in the sorted points."""
    ids = torch.arange(n_ids, dtype=torch.int32, device=seg_id.device)
    start = torch.searchsorted(seg_id, ids)
    return start, torch.searchsorted(seg_id, ids, right=True) - start


def _sorted_segments(keys: torch.Tensor, xyz: torch.Tensor,
                     intensity: torch.Tensor):
    """Sort points by voxel key and derive the segment structure.

    Returns (xyz_s, inten_s, seg_start, seg_count, num_segments): segment s
    (voxels in ascending key order) holds sorted points
    [seg_start[s], seg_start[s] + seg_count[s]); segments at or past
    ``num_segments`` (a device scalar) are empty.
    """
    _, order, seg_id, num_segments = _sorted_keys(keys)
    seg_start, seg_count = _segment_ranges(seg_id, keys.shape[0])
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
# Point-slab voxel map on a sorted key table (the compact target that the
# reference's sharded registration path splits across devices)
# ---------------------------------------------------------------------------


class VoxelMap(NamedTuple):
    """Sorted voxel table with per-voxel point slabs.

    keys:   (V,) int32 ascending valid prefix, INVALID_KEY tail
    slab:   (V, M, 3) f32 points (PAD_COORD padding)
    counts: (V,) int32 valid points per voxel (<= M)
    origin: (3,) f32; grid: () f32
    """

    keys: torch.Tensor
    slab: torch.Tensor
    counts: torch.Tensor
    origin: torch.Tensor
    grid: torch.Tensor

    @property
    def num_voxels(self) -> int:
        return self.keys.shape[0]

    @property
    def slab_size(self) -> int:
        return self.slab.shape[1]

    @classmethod
    def from_numpy(cls, keys, slab, counts, origin, grid,
                   device) -> "VoxelMap":
        """A map from host arrays (e.g. one the reference package built)."""
        return cls(_i32(keys, device), _f32(slab, device),
                   _i32(counts, device), _f32(origin, device),
                   _f32(grid, device))


def build_voxel_map(pc: PointCloud, grid, origin: torch.Tensor,
                    num_voxels: int, slab_size: int) -> VoxelMap:
    """Build the sorted voxel-slab table from a padded cloud.

    One stable sort; each voxel keeps its first ``slab_size`` points by
    rank, voxels beyond ``num_voxels`` are dropped. Row v gathers its points
    from the sorted array (no scatter). As in the reference, a table longer
    than the cloud's capacity n gets the padding points in row n, under an
    INVALID key that no lookup finds.
    """
    dev = pc.xyz.device
    n = pc.capacity
    keys = voxel_keys(pc.xyz, pc.mask, origin, grid)
    keys_s, order, seg_id, _ = _sorted_keys(keys)
    xyz_s = pc.xyz[order]
    start, count = _segment_ranges(seg_id, num_voxels)
    lanes = torch.arange(slab_size, device=dev)
    first = torch.clamp(start, max=n - 1)
    src = torch.clamp(first[:, None] + lanes[None, :], max=n - 1)
    counts = torch.clamp(count, max=slab_size).to(torch.int32)
    valid = lanes[None, :] < counts[:, None]
    pts = xyz_s[src]                                          # (V, M, 3)
    slab = torch.where(valid[..., None], pts, torch.full_like(pts, PAD_COORD))
    table_keys = torch.where(count > 0, keys_s[first],
                             torch.full_like(keys_s[first], INVALID_KEY))
    return VoxelMap(table_keys.to(torch.int32), slab, counts, origin,
                    _scalar_tensor(grid, pc.xyz.dtype, dev))


DIRECT7_OFFSETS = np.array(
    [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
     (0, 0, -1)], dtype=np.int32)


def lookup_voxels(keys_table: torch.Tensor, nkeys: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find packed keys in the sorted table: -> (index, found_mask). The
    INVALID tail keeps the table ascending; an index past the end is clipped
    to the last row, whose key then decides."""
    idx = torch.searchsorted(keys_table, nkeys.contiguous())
    idx = torch.clamp(idx, 0, keys_table.shape[0] - 1)
    found = (keys_table[idx] == nkeys) & (nkeys != INVALID_KEY)
    return idx, found


def gather_neighbors(vm: VoxelMap, queries: torch.Tensor,
                     q_mask: torch.Tensor, radius: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-radius candidate gather from the sorted table: queries (Q, 3)
    -> (candidates (Q, K*M, 3), validity (Q, K*M)), K = (2 radius + 1)^3."""
    offs = _neighbor_offsets(radius, queries.device)           # (K, 3)
    c = voxel_coords(queries, vm.origin, vm.grid)
    nc = c[:, None, :] + offs[None, :, :]                       # (Q, K, 3)
    nkeys = pack_coords(nc, q_mask[:, None])
    idx, found = lookup_voxels(vm.keys, nkeys)                  # (Q, K)
    pts = vm.slab[idx]                                          # (Q, K, M, 3)
    m = vm.slab_size
    lane = torch.arange(m, dtype=torch.int32, device=queries.device)
    valid = found[:, :, None] & (lane[None, None, :]
                                 < vm.counts[idx][:, :, None])
    q_, k_ = pts.shape[0], pts.shape[1]
    return pts.reshape(q_, k_ * m, 3), valid.reshape(q_, k_ * m)


def _k_nearest(cand: torch.Tensor, valid: torch.Tensor,
               queries: torch.Tensor, k: int):
    """The k nearest valid candidates per query, ties to the lower candidate
    index as the reference's ``top_k`` (a stable sort; ``torch.topk``
    promises no order among equals)."""
    d2 = torch.sum((cand - queries[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    sq, idx = torch.sort(d2, dim=1, stable=True)
    sq, idx = sq[:, :k], idx[:, :k]
    nbrs = torch.gather(cand, 1, idx[:, :, None].expand(-1, -1, 3))
    return sq, nbrs, torch.isfinite(sq)


def knn(vm: VoxelMap, queries: torch.Tensor, q_mask: torch.Tensor, k: int,
        radius: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest neighbours from the voxel neighbourhood: (sq_dists (Q, k),
    neighbours (Q, k, 3), valid (Q, k)). Neighbours beyond the neighbourhood
    are not seen: callers choose ``radius`` * grid >= their search radius."""
    cand, valid = gather_neighbors(vm, queries, q_mask, radius)
    return _k_nearest(cand, valid, queries, k)


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

    @classmethod
    def from_numpy(cls, slab, counts, corner, grid,
                   dims: Tuple[int, int, int], slab_pts: int,
                   device) -> "DenseVoxelMap":
        """A map from host arrays (e.g. one the reference package built; its
        rows may be padded past M*3 columns, which are cut here)."""
        slab = np.asarray(slab, np.float32)[:, :int(slab_pts) * 3]
        return cls(_f32(slab, device), _i32(counts, device),
                   _f32(corner, device), _f32(grid, device),
                   tuple(int(d) for d in dims), int(slab_pts))


@functools.lru_cache(maxsize=None)
def _dims_tensor(dims: Tuple[int, int, int], dtype, device) -> torch.Tensor:
    """``dims`` as a (3,) tensor on ``device``, uploaded once and shared."""
    return torch.tensor(dims, dtype=dtype, device=device)


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
    grid = _scalar_tensor(grid, pc.xyz.dtype, dev)
    gx, gy, gz = dims
    g_total = gx * gy * gz
    dims_t = _dims_tensor(tuple(dims), pc.xyz.dtype, dev)
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
    # sentinel row: pure padding. Written as fills of one-row views: a
    # scalar assigned to a 0-dim element goes through a host copy, which
    # synchronises
    pts.narrow(0, g_total, 1).fill_(PAD_COORD)
    counts = torch.clamp(counts, max=m).to(torch.int32)
    counts.narrow(0, g_total, 1).zero_()
    return DenseVoxelMap(pts.reshape(g_total + 1, m * 3), counts, corner,
                         grid, dims, slab_size)


@functools.lru_cache(maxsize=None)
def _neighbor_offsets(radius: int, device) -> torch.Tensor:
    """The (2r+1)^3 voxel offsets, (K, 3) int32 on ``device``. Uploaded once
    per (radius, device) and shared, never written: a host-to-device copy at
    every lookup would synchronise the streamed batch."""
    r = range(-radius, radius + 1)
    return torch.tensor([(x, y, z) for x in r for y in r for z in r],
                        dtype=torch.int32, device=device)


def _rows_to_points(rows: torch.Tensor, slab_pts: int):
    """(..., M*3) flat rows -> ((..., M, 3) points, (..., M) validity), the
    validity read from the PAD_COORD sentinel."""
    pts = rows.reshape(*rows.shape[:-1], slab_pts, 3)
    return pts, pts[..., 0] < 0.5 * PAD_COORD


def gather_neighbors_dense(dm: DenseVoxelMap, queries: torch.Tensor,
                           q_mask: torch.Tensor, radius: int = 1
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-radius candidate gather from the dense grid (no key search):
    queries (Q, 3) -> (candidates (Q, K*M, 3), validity (Q, K*M))."""
    offs = _neighbor_offsets(radius, queries.device)           # (K, 3)
    c = torch.floor((queries - dm.corner) / dm.grid).to(torch.int32)
    nc = c[:, None, :] + offs[None, :, :]                       # (Q, K, 3)
    flat = _dense_flat(nc, dm.dims, q_mask[:, None])            # (Q, K)
    pts, valid = _rows_to_points(dm.slab[flat], dm.slab_pts)
    q_, k_, m = pts.shape[0], pts.shape[1], dm.slab_pts
    return pts.reshape(q_, k_ * m, 3), valid.reshape(q_, k_ * m)


def knn_dense(dm: DenseVoxelMap, queries: torch.Tensor, q_mask: torch.Tensor,
              k: int, radius: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest neighbours from the dense grid neighbourhood: (sq_dists
    (Q, k), neighbours (Q, k, 3), valid (Q, k)). Ties go to the lower
    candidate index, as the reference's ``top_k`` does."""
    cand, valid = gather_neighbors_dense(dm, queries, q_mask, radius)
    return _k_nearest(cand, valid, queries, k)


@functools.lru_cache(maxsize=None)
def _corner_offsets(device) -> torch.Tensor:
    """The 2x2x2 block's offsets, (8, 3) int32 on ``device`` (x outermost)."""
    return torch.tensor([(x, y, z) for x in (0, 1) for y in (0, 1)
                         for z in (0, 1)], dtype=torch.int32, device=device)


def gather_neighbors_corner(dm: DenseVoxelMap, queries: torch.Tensor,
                            q_mask: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner-selected 2x2x2 neighbourhood gather: 8 rows per query.

    The two-voxel block whose minimum corner is ``floor((q - g/2) / g)``
    covers the cube [q - g/2, q + g/2], so a map built with ``grid >= 2 *
    search radius`` (LOAM: 2.0 for the 1 m gate) loses no neighbour.
    Candidates come in the order of the 8 offsets (x outermost), M points
    each, which decides ties in the 5-NN rounds downstream.
    """
    offs = _corner_offsets(queries.device)
    base = torch.floor((queries - dm.corner) / dm.grid - 0.5).to(torch.int32)
    nc = base[:, None, :] + offs[None, :, :]                    # (Q, 8, 3)
    flat = _dense_flat(nc, dm.dims, q_mask[:, None])
    pts, valid = _rows_to_points(dm.slab[flat], dm.slab_pts)    # (Q, 8, M, *)
    q_, k_, m = pts.shape[0], pts.shape[1], dm.slab_pts
    return pts.reshape(q_, k_ * m, 3), valid.reshape(q_, k_ * m)


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
        return cls(torch.tensor(np.asarray(rows, np.int16), device=device),
                   _f32(scale, device), _f32(corner, device),
                   _f32(grid, device), tuple(int(d) for d in dims),
                   int(slab_pts))


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


# ---------------------------------------------------------------------------
# Dense Gaussian voxel map (the VGICP target)
# ---------------------------------------------------------------------------


class DenseGaussianVoxelMap(NamedTuple):
    """Dense grid of Gaussian moments; row G is the zeroed padding sentinel."""

    means: torch.Tensor   # (G+1, 3)
    covs: torch.Tensor    # (G+1, 3, 3)
    counts: torch.Tensor  # (G+1,) int32
    corner: torch.Tensor  # (3,)
    grid: torch.Tensor    # ()
    dims: Tuple[int, int, int]

    @classmethod
    def from_numpy(cls, means, covs, counts, corner, grid,
                   dims: Tuple[int, int, int],
                   device) -> "DenseGaussianVoxelMap":
        """A map from host arrays (e.g. one the reference package built)."""
        return cls(_f32(means, device), _f32(covs, device),
                   _i32(counts, device), _f32(corner, device),
                   _f32(grid, device), tuple(int(d) for d in dims))


def build_dense_gaussian_voxel_map(pc: PointCloud, grid, center: torch.Tensor,
                                   dims: Tuple[int, int, int]
                                   ) -> DenseGaussianVoxelMap:
    """Per-voxel Gaussian moments (mean, E[x x^T] - mean mean^T) in a dense
    window centred at ``center``.

    Points are sorted by voxel id; each occupied voxel sums its points in
    sorted order by a loop over ranks (no float atomics, so the map repeats
    bit for bit on the GPU), and the per-voxel moments are then written to
    their dense rows. The loop bound is the largest in-window voxel
    occupancy, read once to the host; the padding and out-of-window points
    share the sentinel row, whose moments are zeroed.
    """
    dev = pc.xyz.device
    grid = _scalar_tensor(grid, pc.xyz.dtype, dev)
    gx, gy, gz = dims
    g_total = gx * gy * gz
    dims_t = _dims_tensor(tuple(dims), pc.xyz.dtype, dev)
    corner = center - dims_t * grid / 2.0
    c = torch.floor((pc.xyz - corner) / grid).to(torch.int32)
    flat = _dense_flat(c, dims, pc.mask)
    flat_s, order = torch.sort(flat, stable=True)
    mask_s = pc.mask[order]
    xyz = torch.where(mask_s[:, None], pc.xyz[order], torch.zeros_like(pc.xyz))
    outer = (xyz[:, :, None] * xyz[:, None, :]).reshape(-1, 9)
    n = flat_s.shape[0]
    prev = torch.cat([flat_s.new_full((1,), -1), flat_s[:-1]])
    seg_id = torch.cumsum((flat_s != prev).to(torch.int32), 0,
                          dtype=torch.int32) - 1
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    start = torch.searchsorted(seg_id, ids)
    count = torch.searchsorted(seg_id, ids, right=True) - start
    last = n - 1
    # empty segment slots and the out-of-window segment land on the sentinel
    vox = torch.where(count > 0, flat_s[torch.clamp(start, max=last)],
                      torch.full_like(flat_s, g_total)).to(torch.int64)
    sums = torch.zeros_like(xyz)
    sums2 = torch.zeros_like(outer)
    n_iter = int(torch.amax(torch.where(vox < g_total, count,
                                        torch.zeros_like(count))))
    for r in range(n_iter):
        sel = torch.clamp(start + r, max=last)
        take = (r < count)[:, None]
        sums = sums + torch.where(take, xyz[sel], torch.zeros_like(sums))
        sums2 = sums2 + torch.where(take, outer[sel], torch.zeros_like(sums2))
    cnt = torch.clamp(count, min=1).to(sums.dtype)
    means_s = sums / cnt[:, None]
    covs_s = sums2.reshape(n, 3, 3) / cnt[:, None, None] \
        - means_s[:, :, None] * means_s[:, None, :]
    means = torch.zeros((g_total + 1, 3), dtype=xyz.dtype, device=dev)
    covs = torch.zeros((g_total + 1, 3, 3), dtype=xyz.dtype, device=dev)
    counts = torch.zeros((g_total + 1,), dtype=torch.int32, device=dev)
    means[vox] = means_s
    covs[vox] = covs_s
    counts[vox] = count.to(torch.int32)
    means[g_total] = 0.0
    covs[g_total] = 0.0
    counts[g_total] = 0
    return DenseGaussianVoxelMap(means, covs, counts, corner, grid, dims)


def lookup_gaussians_dense(dgm: DenseGaussianVoxelMap, queries: torch.Tensor,
                           q_mask: torch.Tensor, offsets: torch.Tensor,
                           min_points: int = 6):
    """Dense indices of the voxels at ``queries`` + ``offsets`` (K, 3):
    -> (valid (Q, K), flat_idx (Q, K)). ``flat_idx`` gathers any table laid
    out like the map's (means, covariances, precomputed precisions)."""
    c = torch.floor((queries - dgm.corner) / dgm.grid).to(torch.int32)
    nc = c[:, None, :] + offsets[None, :, :]
    flat = _dense_flat(nc, dgm.dims, q_mask[:, None])
    return dgm.counts[flat] >= min_points, flat


def gather_gaussians_dense(dgm: DenseGaussianVoxelMap, queries: torch.Tensor,
                           q_mask: torch.Tensor, offsets: torch.Tensor,
                           min_points: int = 6):
    """Dense-index Gaussian lookup at ``queries`` + ``offsets`` (K, 3):
    -> (means (Q, K, 3), covs (Q, K, 3, 3), valid (Q, K), flat_idx (Q, K))."""
    valid, flat = lookup_gaussians_dense(dgm, queries, q_mask, offsets,
                                         min_points)
    return dgm.means[flat], dgm.covs[flat], valid, flat


# ---------------------------------------------------------------------------
# Gaussian voxel map on a sorted key table
# ---------------------------------------------------------------------------


class GaussianVoxelMap(NamedTuple):
    """Sorted voxel table of Gaussian moments (mean, covariance, count)."""

    keys: torch.Tensor    # (V,) int32
    means: torch.Tensor   # (V, 3)
    covs: torch.Tensor    # (V, 3, 3)
    counts: torch.Tensor  # (V,) int32
    origin: torch.Tensor  # (3,)
    grid: torch.Tensor    # ()

    @classmethod
    def from_numpy(cls, keys, means, covs, counts, origin, grid,
                   device) -> "GaussianVoxelMap":
        """A map from host arrays (e.g. one the reference package built)."""
        return cls(_i32(keys, device), _f32(means, device),
                   _f32(covs, device), _i32(counts, device),
                   _f32(origin, device), _f32(grid, device))


def build_gaussian_voxel_map(pc: PointCloud, grid, origin: torch.Tensor,
                             num_voxels: int,
                             min_points: int = 6) -> GaussianVoxelMap:
    """Per-voxel Gaussian moments in a sorted key table (the
    VoxelGridCovariance role).

    Voxels with fewer than ``min_points`` points keep their count and are
    skipped by ``gather_gaussians``. Covariances are raw (E[x x^T] - mean
    mean^T); NDT and VGICP condition them. Each voxel sums its points in
    sorted order by a loop over ranks (no float atomics); the loop bound is
    the largest occupancy, read once to the host.
    """
    del min_points  # a gather-time threshold, kept for the reference's signature
    dev = pc.xyz.device
    n = pc.capacity
    keys = voxel_keys(pc.xyz, pc.mask, origin, grid)
    keys_s, order, seg_id, _ = _sorted_keys(keys)
    xyz_s = pc.xyz[order]
    outer = (xyz_s[:, :, None] * xyz_s[:, None, :]).reshape(-1, 9)
    start, count = _segment_ranges(seg_id, num_voxels)
    first = torch.clamp(start, max=n - 1)
    table_keys = torch.where(count > 0, keys_s[first],
                             torch.full_like(keys_s[first], INVALID_KEY))
    real = table_keys != INVALID_KEY
    count = torch.where(real, count, torch.zeros_like(count))
    sums = torch.zeros((num_voxels, 3), dtype=xyz_s.dtype, device=dev)
    sums2 = torch.zeros((num_voxels, 9), dtype=xyz_s.dtype, device=dev)
    for r in range(int(torch.amax(count)) if num_voxels else 0):
        sel = torch.clamp(start + r, max=n - 1)
        take = (r < count)[:, None]
        sums = sums + torch.where(take, xyz_s[sel], torch.zeros_like(sums))
        sums2 = sums2 + torch.where(take, outer[sel], torch.zeros_like(sums2))
    cnt = torch.clamp(count, min=1).to(sums.dtype)
    means = sums / cnt[:, None]
    covs = sums2.reshape(num_voxels, 3, 3) / cnt[:, None, None] \
        - means[:, :, None] * means[:, None, :]
    return GaussianVoxelMap(table_keys.to(torch.int32), means, covs,
                            count.to(torch.int32), origin,
                            _scalar_tensor(grid, pc.xyz.dtype, dev))


def gather_gaussians(gvm: GaussianVoxelMap, queries: torch.Tensor,
                     q_mask: torch.Tensor, offsets: torch.Tensor,
                     min_points: int = 6):
    """Gaussian voxels at ``queries`` + ``offsets`` (K, 3) int32 (e.g.
    DIRECT7_OFFSETS): (means (Q, K, 3), covs (Q, K, 3, 3), valid (Q, K))."""
    c = voxel_coords(queries, gvm.origin, gvm.grid)
    nc = c[:, None, :] + offsets[None, :, :]
    nkeys = pack_coords(nc, q_mask[:, None])
    idx, found = lookup_voxels(gvm.keys, nkeys)
    valid = found & (gvm.counts[idx] >= min_points)
    return gvm.means[idx], gvm.covs[idx], valid
