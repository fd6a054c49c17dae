"""NDT scan-to-map registration on Gaussian voxels (pclomp role), on torch
tensors.

Port of ``simpleslam_tpu/ops/ndt.py`` (single device): the target is
voxelized into Gaussian cells with precomputed precision matrices, and
Magnusson's negative log-likelihood score is minimized over SE(3) by a damped
Newton loop with a batched line search over six step fractions, on the
27-cell neighbourhood of each point.

The reference's ``lax.while_loop`` is one pure step on tensors here,
``state -> state``, whose state carries its own stop test: a state that is
done (converged, starved, or out of iterations) passes through the step
untouched, so running the step ``max_iters`` times with no host read (the
streamed batch) and running it until done (the per-scan path, one host read
per iteration) give the same result bit for bit, with the iterates of the
reference's loop.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import geometry as geo
from .linalg3 import solve3x3, symeig3x3
from .pointcloud import PointCloud
from .voxel import (DenseGaussianVoxelMap, _neighbor_offsets,
                    build_dense_gaussian_voxel_map, lookup_gaussians_dense)

# Magnusson score coefficients (pclomp defaults: outlier_ratio 0.55, res 1.0)
OUTLIER_RATIO = 0.55
MAX_ITERS = 30
CONVERGE_EPS = 1e-3
# pclomp's min_points_per_voxel default is 6 against the raw cloud; the
# target arrives pre-downsampled at 0.5 m, so a planar 1 m voxel holds ~4
# points, and with eigenvalue flooring a 4-point Gaussian is usable
MIN_VOXEL_POINTS = 4
EV_FLOOR_RATIO = 0.01
# Line-search step fractions, evaluated in one batched score pass per
# iteration (the replacement for pclomp's sequential More-Thuente search).
# Over-relaxed entries (> 1) make up for the conservative PSD step length.
LINE_SEARCH_ALPHAS = (4.0, 2.0, 1.0, 0.5, 0.25, 0.1)


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """(neighbourhood offsets (27, 3) int32, line-search fractions (6,) f32)
    on ``device``, uploaded once: a host-to-device copy inside ``align``
    would synchronise the streamed batch."""
    return (_neighbor_offsets(1, device),
            torch.tensor(LINE_SEARCH_ALPHAS, dtype=torch.float32,
                         device=device))


class NdtResult(NamedTuple):
    pose: torch.Tensor       # (4, 4) refined pose, on the device
    converged: torch.Tensor  # () bool
    iters: torch.Tensor      # () int32, iterations that ran
    score: torch.Tensor      # () mean exp-score over the scan's points


class NdtTarget(NamedTuple):
    """Dense Gaussian grid + precomputed precision matrices (the
    conditioned-covariance inverses over the whole table, built once per
    submap rebuild, as VoxelGridCovariance inverts at target-set time)."""

    gauss: DenseGaussianVoxelMap
    precisions: torch.Tensor  # (G+1, 3, 3)


def target_from_numpy(means, covs, counts, corner, grid, dims, precisions,
                      device) -> NdtTarget:
    """A target from host arrays (e.g. the leaves of one the reference
    package built), so both packages score against the very same state."""
    return NdtTarget(
        DenseGaussianVoxelMap.from_numpy(means, covs, counts, corner, grid,
                                         dims, device),
        torch.tensor(np.asarray(precisions, np.float32), device=device))


def build_target(submap: PointCloud, resolution, center: torch.Tensor,
                 dims) -> NdtTarget:
    gvm = build_dense_gaussian_voxel_map(submap, resolution, center, dims)
    return NdtTarget(gvm, _precision_matrices(gvm))


def _gauss_coeffs(resolution: float):
    """PCL's gauss_d1_/gauss_d2_ with d1's sign folded: F = sum_i -d1 *
    exp(-0.5 d2 q_i) is minimized with d1 > 0 (PCL keeps d1 negative and
    maximizes the mirrored score; same optimum). numpy f64 -> floats."""
    c1 = 10.0 * (1.0 - OUTLIER_RATIO)
    c2 = OUTLIER_RATIO / (resolution ** 3)
    d3 = -np.log(c2)
    d1_pcl = -np.log(c1 + c2) - d3
    d2 = -2.0 * np.log((-np.log(c1 * np.exp(-0.5) + c2) - d3) / d1_pcl)
    return float(abs(d1_pcl)), float(d2)


def condition_covariances(covs: torch.Tensor) -> torch.Tensor:
    """Inflate small eigenvalues to EV_FLOOR_RATIO * lambda_max
    (VoxelGridCovariance semantics)."""
    lam, V = symeig3x3(covs)
    floor = torch.clamp(EV_FLOOR_RATIO * lam[..., 2:3], min=1e-9)
    lam_c = torch.maximum(lam, floor)
    return torch.einsum("...ik,...k,...jk->...ij", V, lam_c, V)


def _precision_matrices(gvm: DenseGaussianVoxelMap) -> torch.Tensor:
    cond = condition_covariances(gvm.covs)
    eye = torch.eye(3, dtype=cond.dtype, device=cond.device)
    inv, ok = solve3x3_batch(cond + 1e-9 * eye)
    return torch.where(ok[:, None, None], inv, torch.zeros_like(inv))


def solve3x3_batch(A: torch.Tensor):
    """Batched 3x3 inverse via Cramer on well-conditioned (floored)
    matrices: (inverse (..., 3, 3), ok (...))."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    cols, oks = [], []
    for k in range(3):
        x, ok = solve3x3(A, eye[..., k])
        cols.append(x)
        oks.append(ok)
    return torch.stack(cols, dim=-1), oks[0] & oks[1] & oks[2]


def _neighbourhood(gvm: DenseGaussianVoxelMap, precisions: torch.Tensor,
                   p_map: torch.Tensor, mask: torch.Tensor, d2: float):
    """Per point and neighbourhood voxel, with x = p - mean and q = x^T B x:
    (B (Q, 27, 3, 3), B x (Q, 27, 3), e = exp(-0.5 d2 min(q, 50)) (Q, 27),
    valid (Q, 27))."""
    # the full 3^3 cube (pclomp's DIRECT26 + centre): the gather is batched,
    # and the wider support smooths the objective and widens the basin
    offs = _constants(p_map.device)[0]
    valid, idx = lookup_gaussians_dense(gvm, p_map, mask, offs,
                                        min_points=MIN_VOXEL_POINTS)
    B = precisions[idx]                      # along the same dense indices
    x = p_map[:, None, :] - gvm.means[idx]
    Bx = torch.einsum("nkij,nkj->nki", B, x)
    q = torch.sum(x * Bx, dim=-1)
    # guard overflow for far mismatches
    e = torch.exp(-0.5 * d2 * torch.clamp(q, max=50.0))
    return B, Bx, e, valid


def score_terms(src: PointCloud, gvm: DenseGaussianVoxelMap,
                precisions: torch.Tensor, pose: torch.Tensor, d1: float,
                d2: float):
    """Score, gradient and Gauss-Newton curvature over the neighbourhood
    voxels of every point: (H (6, 6), g (6,), score_sum (), n_matched ()).

    The sums over a point's voxels are taken before the contraction with its
    Jacobian (the reference contracts in one einsum; same terms, another
    order)."""
    p_map = geo.transform_points(pose, src.xyz)
    B, Bx, e, valid = _neighbourhood(gvm, precisions, p_map, src.mask, d2)
    ew = e * valid.to(e.dtype)
    score = -d1 * torch.sum(ew)              # negative is good
    J = geo.j_se3(p_map)                     # (N, 3, 6)
    gx = (d1 * d2) * torch.einsum("nk,nki->ni", ew, Bx)       # dF/dx (N, 3)
    g = torch.einsum("ni,nij->j", gx, J)
    # PSD curvature: only the exp-weighted J^T B J term. The full Newton
    # Hessian's -d2 (Bx)(Bx)^T part is indefinite away from the optimum and
    # flips the search direction; the PSD matrix is paired with the wide
    # line search of the step instead
    Bw = torch.einsum("nk,nkij->nij", ew, B)                  # (N, 3, 3)
    JB = torch.einsum("nij,njl->nil", Bw, J)                  # (N, 3, 6)
    H = (d1 * d2) * torch.einsum("nim,nil->ml", J, JB)
    n = torch.sum(valid.any(dim=1), dtype=torch.int32)
    return H, g, score, n


def score_only(src: PointCloud, gvm: DenseGaussianVoxelMap,
               precisions: torch.Tensor, poses: torch.Tensor, d1: float,
               d2: float) -> torch.Tensor:
    """Objective value only, for a stack of poses (A, 4, 4) in one pass
    (the line-search candidates): (A,) scores. A single (4, 4) pose gives a
    () score."""
    single = poses.dim() == 2
    poses = poses.reshape(-1, 4, 4)
    a, n = poses.shape[0], src.xyz.shape[0]
    p_map = geo.transform_points(poses, src.xyz).reshape(a * n, 3)
    _, _, e, valid = _neighbourhood(gvm, precisions, p_map,
                                    src.mask.repeat(a), d2)
    scores = -d1 * torch.sum((e * valid.to(e.dtype)).reshape(a, -1), dim=1)
    return scores[0] if single else scores


class _State(NamedTuple):
    """The damped Newton loop's carry; ``conv`` also holds "starved"."""

    pose: torch.Tensor   # (4, 4)
    iters: torch.Tensor  # () int32
    conv: torch.Tensor   # () bool
    lam: torch.Tensor    # () f32 damping


def _done(state: _State, max_iters: int) -> torch.Tensor:
    return state.conv | (state.iters >= max_iters)


def _step(src: PointCloud, target: NdtTarget, d1: float, d2: float,
          alphas: torch.Tensor, max_iters: int, state: _State) -> _State:
    """One damped Newton iteration with the batched line search; a done
    state comes back untouched."""
    pose, it, conv, lam = state
    gvm, precisions = target
    done = _done(state, max_iters)
    H, g, score, n = score_terms(src, gvm, precisions, pose, d1, d2)
    diag = torch.clamp(torch.abs(torch.diagonal(H)), min=1e-6)
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    # solve_ex: no error check on the host, so no synchronisation
    dx = torch.linalg.solve_ex(
        H + (lam * 1e-4) * torch.diag(diag) + 1e-6 * eye, -g).result
    cand = geo.pose_compose(geo.se3_exp(alphas[:, None] * dx[None, :]), pose)
    cand_scores = score_only(src, gvm, precisions, cand, d1, d2)
    # first minimum on ties; picked with index_select, because indexing by a
    # 0-dim tensor reads it on the host
    best = torch.argmin(cand_scores).reshape(1)
    improved = cand_scores.index_select(0, best)[0] < score
    pose_next = torch.where(improved, cand.index_select(0, best)[0], pose)
    lam_next = torch.where(improved, torch.clamp(lam * 0.5, min=1e-4),
                           torch.clamp(lam * 8.0, max=1e4))
    step = alphas.index_select(0, best)[0] * torch.linalg.norm(dx)
    conv_next = (improved & (step < CONVERGE_EPS)) | (n < 6)
    return _State(torch.where(done, pose, pose_next),
                  torch.where(done, it, it + 1),
                  torch.where(done, conv, conv_next),
                  torch.where(done, lam, lam_next))


def align(src: PointCloud, target: NdtTarget, init_pose: torch.Tensor,
          max_iters: int = MAX_ITERS, early_exit: bool = False) -> NdtResult:
    """Damped Newton + batched line search on the NDT score.

    The step runs ``max_iters`` times with nothing read from the device
    (what the streamed batch needs); with ``early_exit`` the loop reads
    the state's stop test after each step and leaves the loop once it holds
    (one host read per iteration, for the per-scan paths). Both give the
    same result, fields as 0-dim tensors."""
    d1, d2 = _gauss_coeffs(1.0)              # NdtRegister.cpp:13 uses 1.0
    dev = init_pose.device
    alphas = _constants(dev)[1]
    state = _State(init_pose.to(torch.float32),
                   torch.zeros((), dtype=torch.int32, device=dev),
                   torch.zeros((), dtype=torch.bool, device=dev),
                   torch.full((), 1e-2, dtype=torch.float32, device=dev))
    for _ in range(max_iters):
        if early_exit and bool(_done(state, max_iters)):
            break
        state = _step(src, target, d1, d2, alphas, max_iters, state)
    pose = geo.reorthonormalize(state.pose)
    _, _, final_score, n = score_terms(src, target.gauss, target.precisions,
                                       pose, d1, d2)
    n_pts = torch.clamp(torch.sum(src.mask, dtype=torch.int32), min=1)
    trans_prob = -final_score / n_pts.to(torch.float32)
    return NdtResult(pose, state.conv & (n >= 6), state.iters, trans_prob)
