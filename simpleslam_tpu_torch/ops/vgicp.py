"""Voxelized GICP registration (FastVGICP role) + PCL-style fitness score,
on torch tensors.

Port of ``simpleslam_tpu/ops/vgicp.py`` (single device): per-source-point
plane-regularized covariances from a dense-grid neighbourhood, the target
accumulated into Gaussian voxels, and the distribution-to-distribution
Mahalanobis cost minimized by damped GN over SE(3) with center-voxel
correspondences (DIRECT1). It is the VGICP odometry register and, in
``lc_mode``, the loop closure manager's verifier.

The reference's ``lax.while_loop`` is one pure step on tensors here,
``state -> state``, whose state carries its own stop test: a state that is
done (converged, starved, or out of iterations) passes through the step
untouched. The streamed batch runs the step ``max_iters`` times with no host
read; the per-scan paths and the loop-closure verifier run it until done,
reading the stop test once per iteration. Both give the same result bit for
bit, with the iterates of the reference's loop, which a rejected step under
epsilon ends here and not there (``_step``; ROADMAP section 3, F7).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as geo
from .linalg3 import symeig3x3
from .ndt import solve3x3_batch
from .pointcloud import PointCloud
from .voxel import (
    DenseGaussianVoxelMap,
    DenseVoxelMap,
    build_dense_gaussian_voxel_map,
    build_dense_voxel_map,
    gather_gaussians_dense,
    gather_neighbors_dense,
    knn_dense,
)

K_CORRESPONDENCES = 20   # fast_gicp k_correspondences_ (see source_covariances)
MIN_SRC_NEIGHBORS = 6
MAX_ITERS = 30
LC_MAX_ITERS = 100       # VgicpRegister::initForLC max iterations 100
CONVERGE_EPS = 1e-4
LC_CONVERGE_EPS = 1e-6   # initForLC transformation epsilon
# target voxels with >= 3 points contribute (the combined covariance is
# invertible thanks to the plane-regularized source covariances)
MIN_VOXEL_POINTS = 3

# source-covariance neighbourhood (sensor frame): radius-1 lookups in a 2 m
# dense grid sized to the 80 m lidar range cover +-2 m around each point
SRC_GRID = 2.0
SRC_DIMS = (96, 96, 16)
SRC_SLAB = 24
SRC_RADIUS_SQ = 4.0


class VgicpTarget(NamedTuple):
    gauss: DenseGaussianVoxelMap  # Gaussian voxels (means/covs)
    pts: DenseVoxelMap            # raw target points (fitness score NN)


class VgicpResult(NamedTuple):
    pose: torch.Tensor       # (4, 4) refined pose, on the device
    converged: torch.Tensor  # () bool
    iters: torch.Tensor      # () int32, iterations that ran
    fitness: torch.Tensor    # () mean squared NN distance


def build_target(submap: PointCloud, resolution, center: torch.Tensor,
                 dims) -> VgicpTarget:
    """Gaussian voxels at ``resolution`` plus the fitness-score point map at
    twice the resolution over half the voxel counts (same window)."""
    gauss = build_dense_gaussian_voxel_map(submap, resolution, center, dims)
    fdims = (max(dims[0] // 2, 1), max(dims[1] // 2, 1), max(dims[2] // 2, 1))
    pts = build_dense_voxel_map(submap, resolution * 2.0, center, fdims,
                                slab_size=16)
    return VgicpTarget(gauss, pts)


def _plane_regularize(covs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """fast_gicp RegularizationMethod::PLANE: eigenvalues -> (1e-3, 1, 1)."""
    _, V = symeig3x3(covs)
    # made on the device by fills (a host list, or a scalar assigned to one
    # element, would be a blocking copy)
    lam_reg = torch.ones(3, dtype=covs.dtype, device=covs.device)
    lam_reg.narrow(0, 0, 1).fill_(1e-3)
    reg = torch.einsum("...ik,k,...jk->...ij", V, lam_reg, V)
    eye = torch.eye(3, dtype=covs.dtype, device=covs.device).expand_as(reg)
    return torch.where(valid[:, None, None], reg, eye)


def source_covariances(src: PointCloud):
    """Per-source-point plane-regularized covariances from every neighbour
    within +-2 m (dense-grid gather, no kNN search): (covs (N, 3, 3),
    valid (N,)). Points with fewer than MIN_SRC_NEIGHBORS neighbours are
    excluded."""
    svm = build_dense_voxel_map(
        src, SRC_GRID, torch.zeros(3, dtype=src.xyz.dtype, device=src.xyz.device),
        SRC_DIMS, slab_size=SRC_SLAB)
    cand, ok = gather_neighbors_dense(svm, src.xyz, src.mask, radius=1)
    d2 = torch.sum((cand - src.xyz[:, None, :]) ** 2, dim=-1)
    w = (ok & (d2 < SRC_RADIUS_SQ)).to(src.xyz.dtype)
    cnt = torch.sum(w, dim=1)
    mean = torch.sum(cand * w[..., None], dim=1) \
        / torch.clamp(cnt, min=1.0)[:, None]
    d = (cand - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", d, d) \
        / torch.clamp(cnt, min=1.0)[:, None, None]
    valid = src.mask & (cnt >= MIN_SRC_NEIGHBORS)
    return _plane_regularize(cov, valid), valid


def _linearize(src: PointCloud, src_covs: torch.Tensor,
               src_valid: torch.Tensor, target: VgicpTarget,
               pose: torch.Tensor):
    """GN normal equations of the D2D Mahalanobis cost at ``pose``:
    (H (6, 6), g (6,), cost (), n_valid ())."""
    p_map = geo.transform_points(pose, src.xyz)
    offs = torch.zeros((1, 3), dtype=torch.int32, device=pose.device)
    means, covs_t, valid_v, _ = gather_gaussians_dense(
        target.gauss, p_map, src.mask, offs, min_points=MIN_VOXEL_POINTS)
    mu = means[:, 0, :]
    cov_t = covs_t[:, 0, :, :]
    valid = src_valid & valid_v[:, 0]

    R = pose[:3, :3]
    cov_rot = torch.einsum("ij,njk,lk->nil", R, src_covs, R)
    C = cov_t + cov_rot + 1e-6 * torch.eye(3, dtype=cov_t.dtype,
                                           device=cov_t.device)
    W, ok = solve3x3_batch(C)
    valid = valid & ok

    r = mu - p_map                       # (N, 3)
    J = -geo.j_se3(p_map)                # dr/ddelta (N, 3, 6)
    w = valid.to(r.dtype)
    WJ = torch.einsum("nij,njk->nik", W, J)
    H = torch.einsum("nik,nij,n->kj", J, WJ, w)
    Wr = torch.einsum("nij,nj->ni", W, r)
    g = torch.einsum("nik,ni,n->k", J, Wr, w)
    cost = torch.sum(torch.einsum("ni,ni->n", r, Wr) * w)
    n_valid = torch.sum(valid, dtype=torch.int32)
    return H, g, cost, n_valid


class _State(NamedTuple):
    """The damped GN loop's carry, with the carried linearization; ``conv``
    also holds "starved"."""

    pose: torch.Tensor   # (4, 4)
    iters: torch.Tensor  # () int32
    conv: torch.Tensor   # () bool
    lam: torch.Tensor    # () f32 damping
    H: torch.Tensor      # (6, 6)
    g: torch.Tensor      # (6,)
    cost: torch.Tensor   # ()
    n: torch.Tensor      # () int32 rows of the linearization


def _done(state: _State, max_iters: int) -> torch.Tensor:
    return state.conv | (state.iters >= max_iters)


def _step(lin, max_iters: int, eps: float, state: _State) -> _State:
    """One damped GN iteration with a carried linearization: the trial
    evaluation is the next iteration's linearization when accepted (chi2
    drops), else the carried one stays; lambda halves on accept and grows 8x
    on reject. Converged on a small step, taken or not, or a < 1e-4 relative
    chi2 gain; a starved linearization (< 6 rows) stops the loop. A done
    state comes back untouched."""
    pose, it, conv, lam, H, g, cost, n = state
    done = _done(state, max_iters)
    diag = torch.clamp(torch.diagonal(H), min=1e-6)
    # solve_ex: no error check on the host, so no synchronisation
    dx = torch.linalg.solve_ex(H + lam * torch.diag(diag), -g).result
    new_pose = geo.pose_compose(geo.se3_exp(dx), pose)
    H2, g2, cost2, n2 = lin(new_pose)
    improved = cost2 < cost
    gain = cost - cost2
    keep = done | ~improved              # the carried linearization stays
    n_next = torch.where(keep, n, n2)
    # step-norm epsilon OR a chi2 plateau (in f32 the step norm floors
    # near 1e-4, so the LC epsilon alone would always run 100 steps). A
    # rejected step under epsilon ends the loop too, as in LsqRegistration's
    # LM (a rejected delta that is_converged returns converged): at the f32
    # floor every trial can be rejected, lambda then only grows to its cap,
    # where the same trial repeats, and the reference's rule (improved and
    # small) runs out the budget as "not converged"
    plateau = improved & (gain < 1e-4 * cost2)
    conv_next = ((torch.linalg.norm(dx) < eps) | plateau | (n_next < 6))
    lam_next = torch.where(improved, torch.clamp(lam * 0.5, min=1e-8),
                           torch.clamp(lam * 8.0, max=1e6))
    return _State(torch.where(keep, pose, new_pose),
                  torch.where(done, it, it + 1),
                  torch.where(done, conv, conv_next),
                  torch.where(done, lam, lam_next),
                  torch.where(keep, H, H2), torch.where(keep, g, g2),
                  torch.where(keep, cost, cost2), n_next)


def _align_impl(src: PointCloud, src_covs, src_valid, target: VgicpTarget,
                init_pose: torch.Tensor, max_iters: int, eps: float,
                early_exit: bool, axis_reduce=None) -> VgicpResult:
    def lin(p):
        H, g, cost, n = _linearize(src, src_covs, src_valid, target, p)
        if axis_reduce is None:
            return H, g, cost, n
        # one 44-float collective per linearization
        flat = axis_reduce(torch.cat([H.reshape(36), g, cost.reshape(1),
                                      n.to(torch.float32).reshape(1)]))
        return (flat[:36].reshape(6, 6), flat[36:42], flat[42],
                flat[43].to(torch.int32))

    pose0 = init_pose.to(torch.float32)
    dev = pose0.device
    state = _State(pose0, torch.zeros((), dtype=torch.int32, device=dev),
                   torch.zeros((), dtype=torch.bool, device=dev),
                   torch.full((), 1e-6, dtype=torch.float32, device=dev),
                   *lin(pose0))
    for _ in range(max_iters):
        if early_exit and bool(_done(state, max_iters)):
            break
        state = _step(lin, max_iters, eps, state)
    pose = geo.reorthonormalize(state.pose)
    fit = fitness_score(src, target.pts, pose, axis_reduce)
    return VgicpResult(pose, state.conv & (state.n >= 6), state.iters, fit)


def align(src: PointCloud, target: VgicpTarget, init_pose: torch.Tensor,
          lc_mode: bool = False, early_exit: bool = False,
          axis_reduce=None) -> VgicpResult:
    """Register ``src`` to ``target`` from ``init_pose``; ``lc_mode`` takes
    the loosened loop-closure budget (100 iterations, epsilon 1e-6).

    The step runs its full count with nothing read from the device (what
    the streamed batch needs); with ``early_exit`` the loop reads the
    state's stop test after each step and leaves the loop once it holds.
    Both give the same result, fields as 0-dim tensors.

    ``axis_reduce`` (``src`` one rank's block of the scan's points): a
    cross-rank sum of a flat f32 vector, one 44-float collective per
    linearization and one of two floats for the fitness. The source
    covariances come from the block's own neighbourhood window, as in the
    reference package: the host prep sorts a scan's points spatially, so a
    block is a spatially coherent piece of the scan and only voxels on its
    border see a thinned neighbourhood, which the PLANE regularization
    (it keeps only the eigenvector frame) hardly feels."""
    src_covs, src_valid = source_covariances(src)
    if lc_mode:
        return _align_impl(src, src_covs, src_valid, target, init_pose,
                           LC_MAX_ITERS, LC_CONVERGE_EPS, early_exit,
                           axis_reduce)
    return _align_impl(src, src_covs, src_valid, target, init_pose,
                       MAX_ITERS, CONVERGE_EPS, early_exit, axis_reduce)


def fitness_score(src: PointCloud, target_pts: DenseVoxelMap,
                  pose: torch.Tensor, axis_reduce=None) -> torch.Tensor:
    """Mean squared NN distance of the aligned source (PCL getFitnessScore),
    with the NN search bounded by the target grid's radius-1 neighbourhood;
    unmatched points are left out of the mean. ``axis_reduce`` sums the
    numerator and the count across the ranks of a sharded scan."""
    p_map = geo.transform_points(pose, src.xyz)
    sq, _, valid = knn_dense(target_pts, p_map, src.mask, k=1, radius=1)
    ok = valid[:, 0] & src.mask
    num = torch.sum(torch.where(ok, sq[:, 0], torch.zeros_like(sq[:, 0])))
    den = torch.sum(ok.to(torch.float32))
    if axis_reduce is not None:
        flat = axis_reduce(torch.stack([num, den]))
        num, den = flat[0], flat[1]
    return num / torch.clamp(den, min=1.0)
