"""LOAM-style point-to-plane Gauss-Newton registration on SE(3), in torch.

Port of ``simpleslam_tpu/ops/loam.py`` with the reference's thresholds
(``PCR/include/PCR/LoamRegister.hpp:30-40``):
- 5-NN gated by 5th-neighbour sq-dist < 1.0,
- plane through the centred 5-point scatter's smallest eigenvector, with
  the planar / thickness / residual gates,
- residual d = n . (p - c), weight s = 1 - 0.9 |d| / sqrt(|p_src|),
  accepted when s > 0.1,
- J row = s n^T [I | -skew(p_map)], solve J^T J dx = -J^T e,
- pose <- exp(dx) pose, converged when |dx_t|, |dx_r| <= 5e-3 BEFORE the
  step is applied; at most 8 iterations; >= 6 valid rows; rotation
  re-orthonormalized after the loop.

Three kinds of target serve the candidate gather, as in the reference: the
merged dense map (one int16 row per query, the production target), the
dense map (corner-selected 2x2x2 gather, 8 rows per query) and the sorted
voxel table (27-cell key search, the compact target of the sharded path).

On CUDA tensors the GN loop against any of the three targets is one launch
of the kernel K3 (``loam_kernels.gn_loop_fused``), as the reference runs it
as one ``lax.while_loop``; its plain version ``gn_loop_stepwise`` is the
same loop driven from Python through the linearization kernels (their
plain versions for CPU tensors): K1 on a merged map, the torch gather plus
K4 on the other two targets, and K2 against the frozen planes in between.
The functions below (``fit_planes``, ``plane_normal_equations``,
``normal_equations_from_candidates``) are the same math on an explicit
candidate tensor, as the reference package states it.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from . import geometry as geo
from .linalg3 import div_const, symeig3x3_smallest
from .pointcloud import PointCloud
from .voxel import (DenseVoxelMap, MergedDenseVoxelMap, VoxelMap,
                    gather_neighbors, gather_neighbors_corner,
                    gather_neighbors_merged)

Target = Union[MergedDenseVoxelMap, DenseVoxelMap, VoxelMap]

PLANE_PTS = 5
MAX_SEARCH_SQ = 1.0
PLANE_VALID_THRESH = 0.2
POINT_VALID_THRESH = 0.1
POS_CONVERGE = 5e-3
ROT_CONVERGE = 5e-3
MAX_ITERS = 8
MIN_VALID_ROWS = 6

# Eigenvalue gates of the centred 5-point scatter (sum, not mean):
# lambda_1 > MIN_PLANAR_EV rejects collinear sets, lambda_0 <
# MAX_THICKNESS_EV rejects sets mixing two surfaces.
MIN_PLANAR_EV = 1e-2
MAX_THICKNESS_EV = 2e-2

# Refresh the gather + plane fit once the pose has moved this far (per-point
# bound |dt| + r_max * dtheta) from the pose the planes were fit at: the
# 2x2x2 corner gather covers 1.0 m around the ORIGINAL query, so 0.2 m keeps
# >= 0.8 m of the 1.0 m search radius.
REGATHER_DIST = 0.2

# Degeneracy guard floor per valid row (frontend.degeneracy_guard, off by
# default): eigen-directions of J^T J weaker than this times n_valid get no
# update.
DEGEN_EIGEN_PER_ROW = 0.02


class LoamResult(NamedTuple):
    """All fields stay on the pose's device (the counts as 0-dim tensors), so
    a caller decides when to read them."""

    pose: torch.Tensor       # (4, 4) refined pose
    converged: torch.Tensor  # () bool
    iters: torch.Tensor      # () int32 iterations executed
    n_valid: torch.Tensor    # () int32 valid rows in the last normal equations
    n_gathers: torch.Tensor  # () int32 gather + plane-fit passes (incl. the first)


class Planes(NamedTuple):
    """Per-query frozen plane set."""

    centroid: torch.Tensor  # (Q, 3)
    normal: torch.Tensor    # (Q, 3) unit
    ok: torch.Tensor        # (Q,) bool — 5-NN gate & eigen gates & residual gate


def source_sqrt_range(src: PointCloud) -> torch.Tensor:
    """sqrt(max(|p_src|, 1e-6)) per point: the denominator of the weight s.
    Pose-independent, so it is computed once per scan."""
    return torch.sqrt(torch.clamp(torch.linalg.norm(src.xyz, dim=-1), min=1e-6))


def fit_planes_at(p_map: torch.Tensor, mask: torch.Tensor, cand: torch.Tensor,
                  cand_ok: torch.Tensor) -> Planes:
    """5-NN selection + plane fit of queries ``p_map`` (map frame) against
    their candidates (Q, C, 3) / (Q, C)."""
    diff = cand - p_map[:, None, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
        + diff[..., 2] * diff[..., 2]
    inf = torch.full_like(d2, float("inf"))
    dd = torch.where(cand_ok, d2, inf)
    # k rounds of "min, then the first index among hits"; torch.argmin does
    # not promise the first index on CUDA, so the tie-break is explicit
    n_c = d2.shape[1]
    iota = torch.arange(n_c, device=d2.device)
    d_k = torch.zeros_like(d2[:, 0])
    sel = []
    for _ in range(PLANE_PTS):
        d_k = torch.amin(dd, dim=1)
        hit = (dd == d_k[:, None]) & torch.isfinite(d_k)[:, None]
        first = torch.amin(torch.where(hit, iota, n_c), dim=1)  # n_c: no hit
        sel.append(first)
        dd = torch.where(iota == first[:, None], inf, dd)
    # the selected points in candidate-index order, summed one by one: the
    # order of a masked sum over the candidate axis (the reference's einsum)
    # and of the CUDA kernel, so all three round alike
    sel = torch.sort(torch.stack(sel, dim=1), dim=1).values    # (Q, 5)
    has = sel < n_c
    gate = mask & (d_k < MAX_SEARCH_SQ) & (torch.sum(has, dim=1) >= PLANE_PTS)
    pts = torch.gather(cand, 1, torch.clamp(sel, max=n_c - 1)[..., None]
                       .expand(-1, -1, 3))
    pts = torch.where(has[..., None], pts, torch.zeros_like(pts))
    total = torch.zeros_like(pts[:, 0])
    for k in range(PLANE_PTS):
        total = total + pts[:, k]
    centroid = div_const(total, PLANE_PTS)
    b = torch.where(has[..., None], pts - centroid[:, None, :],
                    torch.zeros_like(pts))
    M = torch.zeros(b.shape[0], 3, 3, dtype=b.dtype, device=b.device)
    for k in range(PLANE_PTS):
        M = M + b[:, k, :, None] * b[:, k, None, :]
    lam, n_hat = symeig3x3_smallest(M)
    fit_ok = (lam[:, 1] > MIN_PLANAR_EV) & (lam[:, 0] < MAX_THICKNESS_EV)
    resid = b[..., 0] * n_hat[:, None, 0] + b[..., 1] * n_hat[:, None, 1] \
        + b[..., 2] * n_hat[:, None, 2]
    plane_ok = torch.amax(torch.abs(resid), dim=1) <= PLANE_VALID_THRESH
    return Planes(centroid, n_hat, gate & fit_ok & plane_ok)


def plane_rows(planes: Planes, p_map: torch.Tensor, sqrt_r: torch.Tensor):
    """Point-to-plane normal equations against a frozen plane set:
    (J^T J (6, 6), J^T e (6,), n_valid () int32)."""
    dp = p_map - planes.centroid
    n = planes.normal
    d = dp[:, 0] * n[:, 0] + dp[:, 1] * n[:, 1] + dp[:, 2] * n[:, 2]
    s = 1.0 - 0.9 * torch.abs(d) / sqrt_r
    valid = planes.ok & (s > POINT_VALID_THRESH)
    px, py, pz = p_map[:, 0], p_map[:, 1], p_map[:, 2]
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    # n^T [I | -skew(p)] = [n, p x n]
    J = s[:, None] * torch.stack(
        [nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx],
        dim=1)
    e = s * d
    Jw = J * valid[:, None].to(J.dtype)
    return Jw.T @ J, Jw.T @ e, torch.sum(valid, dtype=torch.int32)


def fit_planes(src: PointCloud, cand: torch.Tensor, cand_ok: torch.Tensor,
               pose: torch.Tensor) -> Planes:
    """5-NN selection + plane fit at ``pose`` — the pose-independent half of
    the linearization, evaluated once per candidate gather."""
    return fit_planes_at(geo.transform_points(pose, src.xyz), src.mask, cand,
                         cand_ok)


def plane_normal_equations(src: PointCloud, planes: Planes, pose: torch.Tensor):
    """The pose-dependent half: residuals, weights and J^T J / J^T e against
    a frozen plane set."""
    return plane_rows(planes, geo.transform_points(pose, src.xyz),
                      source_sqrt_range(src))


def normal_equations_from_candidates(src: PointCloud, cand: torch.Tensor,
                                     cand_ok: torch.Tensor, pose: torch.Tensor):
    """GN linearization against an already-gathered candidate set: the plane
    fit and the normal equations at the same pose (what the TPU kernel and
    K1 compute in one pass)."""
    return plane_normal_equations(src, fit_planes(src, cand, cand_ok, pose),
                                  pose)


def gather_candidates_at(vm: Target, p_map: torch.Tensor, mask: torch.Tensor):
    """Candidate gather of map-frame queries ``p_map`` (Q, 3), by the kind of
    target: one merged row per query, the corner-selected 2x2x2 block of a
    dense map (both need a map grid >= 2 * sqrt(MAX_SEARCH_SQ); LOAM uses
    2.0), or the 27-cell key search of a sorted table (grid >= 1.0)."""
    if isinstance(vm, MergedDenseVoxelMap):
        return gather_neighbors_merged(vm, p_map, mask)
    if isinstance(vm, DenseVoxelMap):
        return gather_neighbors_corner(vm, p_map, mask)
    if isinstance(vm, VoxelMap):
        return gather_neighbors(vm, p_map, mask, 1)
    raise TypeError(f"not a LOAM target: {type(vm).__name__}")


def gather_candidates(src: PointCloud, vm: Target, pose: torch.Tensor):
    """Candidate gather at ``pose`` (see ``gather_candidates_at``)."""
    return gather_candidates_at(vm, geo.transform_points(pose, src.xyz),
                                src.mask)


def build_normal_equations(src: PointCloud, vm: Target, pose: torch.Tensor):
    """One GN linearization: masked J^T J (6, 6), J^T e (6,), n_valid."""
    cand, cand_ok = gather_candidates(src, vm, pose)
    return normal_equations_from_candidates(src, cand, cand_ok, pose)


def _solve(JtJ: torch.Tensor, JtE: torch.Tensor, n_valid: torch.Tensor,
           enough: torch.Tensor, degen_per_row: float) -> torch.Tensor:
    """The GN step dx (6,), with the padding-only case damped so the solve
    stays finite, and the optional eigenbasis degeneracy guard."""
    eye = torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
    JtJ_safe = JtJ + eye * (~enough).to(JtJ.dtype)
    if degen_per_row > 0:
        w_eig, V = torch.linalg.eigh(JtJ_safe)
        y = V.T @ (-JtE)
        floor = degen_per_row * n_valid.to(JtJ.dtype) * enough.to(JtJ.dtype)
        strong = w_eig > floor
        return V @ torch.where(strong, y / torch.clamp(w_eig, min=1e-12),
                               torch.zeros_like(y))
    return torch.linalg.solve(JtJ_safe, -JtE)


def gn_loop_stepwise(src: PointCloud, vm: Target,
                     init_pose: torch.Tensor, max_iters: int = MAX_ITERS,
                     degen_per_row: float = 0.0) -> LoamResult:
    """The GN loop driven from Python: the plain version of the kernel K3.

    At the start pose and on every refresh the plane set is fitted and
    linearized in one pass: K1 (``fit_and_linearize_merged``) on a merged
    map, else the torch gather and K4 (``fit_and_linearize_candidates``); K2
    (``plane_normal_equations``) linearizes against the frozen planes on the
    other iterations. This is the reference loop's schedule exactly: it fits
    at the start pose and at every refresh pose and linearizes at that same
    pose in the same iteration.

    One host read per iteration decides the loop (converged, starved, moved
    past REGATHER_DIST). ``gn_loop`` takes this path for CPU tensors; on
    CUDA tensors it is counted in ``K3_PLAIN_CUDA_CALLS``, which the main
    paths keep at zero.
    """
    from . import loam_kernels as lk

    merged = isinstance(vm, MergedDenseVoxelMap)
    if init_pose.is_cuda:
        lk.K3_PLAIN_CUDA_CALLS += 1

    def fit_and_linearize(p_map):
        if merged:
            return lk.fit_and_linearize_merged(vm, p_map, sqrt_r, src.mask)
        cand, cand_ok = gather_candidates_at(vm, p_map, src.mask)
        return lk.fit_and_linearize_candidates(cand, cand_ok, p_map, sqrt_r,
                                               src.mask)

    pose = init_pose.to(torch.float32)
    sqrt_r = source_sqrt_range(src)
    r_max = torch.amax(torch.where(src.mask, torch.linalg.norm(src.xyz, dim=-1),
                                   torch.zeros_like(sqrt_r)))
    anchor = pose
    p_map = geo.transform_points(pose, src.xyz)
    JtJ, JtE, n_valid, planes = fit_and_linearize(p_map)
    gathers, iters = 1, 0
    while True:
        enough = n_valid >= MIN_VALID_ROWS
        dx = _solve(JtJ, JtE, n_valid, enough, degen_per_row)
        conv = (torch.linalg.norm(dx[:3]) <= POS_CONVERGE) & (
            torch.linalg.norm(dx[3:]) <= ROT_CONVERGE)
        stop = conv | ~enough  # the reference breaks before the update
        pose = torch.where(stop, pose,
                           geo.pose_compose(geo.se3_exp(dx), pose))
        iters += 1
        # motion since the plane fit, for the next iteration's refresh test
        dt = torch.linalg.norm(pose[:3, 3] - anchor[:3, 3])
        cos_a = (torch.trace(anchor[:3, :3].T @ pose[:3, :3]) - 1.0) * 0.5
        moved = dt + r_max * torch.arccos(torch.clamp(cos_a, -1.0, 1.0))
        converged = conv & enough
        state = torch.stack([converged.to(torch.float32),
                             (~enough).to(torch.float32), moved]).cpu()
        if bool(state[0]) or bool(state[1]) or iters >= max_iters:
            break
        p_map = geo.transform_points(pose, src.xyz)
        if float(state[2]) > REGATHER_DIST:
            JtJ, JtE, n_valid, planes = fit_and_linearize(p_map)
            anchor = pose
            gathers += 1
        else:
            JtJ, JtE, n_valid = lk.plane_normal_equations(planes, p_map, sqrt_r)
    counts = torch.tensor([iters, gathers], dtype=torch.int32,
                          device=pose.device)
    return LoamResult(geo.reorthonormalize(pose), converged, counts[0],
                      n_valid, counts[1])


def gn_loop(src: PointCloud, vm: Target, init_pose: torch.Tensor,
            max_iters: int = MAX_ITERS,
            degen_per_row: float = 0.0) -> LoamResult:
    """The full GN loop (reference ``LoamRegister::scan2Map``).

    On CUDA tensors the whole loop is one launch of K3
    (``loam_kernels.gn_loop_fused``) on any of the three targets, with no
    host read; a failed build or launch, or a target the kernel cannot
    take, raises. On CPU tensors it is K3's plain version
    ``gn_loop_stepwise``.
    """
    if not init_pose.is_cuda:
        return gn_loop_stepwise(src, vm, init_pose, max_iters, degen_per_row)
    from . import loam_kernels as lk

    row = lk.gn_loop_fused(src.xyz, src.mask, vm,
                           init_pose.to(torch.float32).contiguous(),
                           max_iters, degen_per_row)
    counts = row.to(torch.int32)
    return LoamResult(row[:16].view(4, 4), row[lk.GN_CONVERGED] > 0.5,
                      counts[lk.GN_ITERS], counts[lk.GN_N_VALID],
                      counts[lk.GN_GATHERS])


def scan2map(src: PointCloud, vm: Target, init_pose: torch.Tensor,
             max_iters: int = MAX_ITERS,
             degen_per_row: float = 0.0) -> LoamResult:
    """Register ``src`` to the target map from ``init_pose``. A dense map
    must be built with grid >= 2.0 and a sorted table with grid >= 1.0, so
    the gathered neighbourhood covers the 1 m search radius."""
    return gn_loop(src, vm, init_pose, max_iters, degen_per_row)
