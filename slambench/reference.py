"""The plain reference that decides ``correct``: voxel downsampling, the
keyframe submap, LOAM point-to-plane registration and the pose-graph
solve, written out in numpy and plain torch from their published
descriptions (LOAM's 5-NN plane fit with the thresholds of SimpleSLAM's
``LoamRegister.hpp``, ``MapManager::updateMap``'s radius window, GTSAM's
between and prior factors). It imports nothing of the program and takes
nothing it made: it downsamples the raw scans itself and places them at
the poses the program reports, which it reads only to judge them.

``Prec`` sets the arithmetic: float64 for the reference, and bfloat16
(every intermediate rounded to bfloat16, sums accumulated in float32) for
the control that has to fail.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from scipy.spatial import cKDTree

# LoamRegister.hpp:30-40 and MapManager.hpp:67-68, as the configurations
# state them
PLANE_PTS = 5
MAX_SEARCH_SQ = 1.0
PLANE_VALID_THRESH = 0.2
POINT_VALID_THRESH = 0.1
MIN_PLANAR_EV = 1e-2
MAX_THICKNESS_EV = 2e-2
MIN_VALID_ROWS = 6
SUBMAP_RADIUS = 8.0
VOXEL_MAX_PTS = 20          # VoxelDownSampleV2: the centroid of a voxel's first 20
GN_MAX_ITERS = 30
GN_TOL = 1e-9               # step norm at which the reference has converged
# Backend.cpp:90-97: the prior on keyframe 0, variances [trans(3), rot(3)]
PRIOR_VAR = np.array([1e-1, 1e-1, 1e-1, 1e-2, 1e-2, math.pi / 72])
PG_MAX_ITERS = 60
PG_TOL = 1e-10


class Prec:
    """Working precision: ``q`` rounds a tensor to it."""

    def __init__(self, name: str = "float64"):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.low = name == "bfloat16"
        self.dtype = torch.float32 if self.low else torch.float64

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.low:
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    def qn(self, x: np.ndarray) -> np.ndarray:
        if self.low:
            return self.q(torch.from_numpy(np.asarray(x, np.float32))
                          ).double().numpy()
        return np.asarray(x, np.float64)


# -- scan preparation ---------------------------------------------------------

def voxel_keys(xyz: np.ndarray, grid: float) -> np.ndarray:
    """Packed voxel keys, floor(p * (1 / grid)) in float32 as the sensor's
    own float32 points are keyed."""
    k = np.floor(np.asarray(xyz, np.float32)
                 * (np.float32(1.0) / np.float32(grid))).astype(np.int64)
    k += 1 << 20
    return (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]


def downsample(xyz: np.ndarray, grid: float, prec: Prec = Prec()) -> np.ndarray:
    """Centroid of each voxel's first ``VOXEL_MAX_PTS`` points in input
    order, voxels in first-seen order."""
    xyz = np.asarray(xyz, np.float32)
    xyz = xyz[np.isfinite(xyz).all(axis=1)]
    if len(xyz) == 0:
        return np.zeros((0, 3))
    keys = voxel_keys(xyz, grid)
    _, first, vid = np.unique(keys, return_index=True, return_inverse=True)
    vid = vid.reshape(-1)
    order = np.argsort(vid, kind="stable")
    starts = np.searchsorted(vid[order], np.arange(len(first)))
    rank = np.empty(len(vid), np.int64)
    rank[order] = np.arange(len(vid)) - starts[vid[order]]
    take = rank < VOXEL_MAX_PTS
    pts = prec.qn(xyz[take])
    sums = np.zeros((len(first), 3))
    np.add.at(sums, vid[take], pts)
    cnt = np.bincount(vid[take], minlength=len(first)).astype(np.float64)
    cents = prec.qn(sums / cnt[:, None])
    return cents[np.argsort(first)]


# -- SE(3) in numpy, float64, batched over leading axes ------------------------

def skew(w: np.ndarray) -> np.ndarray:
    z = np.zeros(w.shape[:-1])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _so3_parts(w: np.ndarray):
    th = np.linalg.norm(w, axis=-1)
    small = th < 1e-8
    ts = np.where(small, 1.0, th)
    a = np.where(small, 0.0, np.sin(ts) / ts)
    b = np.where(small, 0.5, (1 - np.cos(ts)) / ts ** 2)
    c = np.where(small, 1.0 / 6.0, (ts - np.sin(ts)) / ts ** 3)
    return th, a, b, c


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Twist [rho, w] -> (..., 4, 4)."""
    rho, w = xi[..., :3], xi[..., 3:]
    _, a, b, c = _so3_parts(w)
    W = skew(w)
    W2 = W @ W
    eye = np.broadcast_to(np.eye(3), W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    T = np.zeros(xi.shape[:-1] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = np.einsum("...ij,...j->...i", V, rho)
    T[..., 3, 3] = 1.0
    return T


def so3_log(R: np.ndarray) -> np.ndarray:
    cos_t = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0)
    th = np.arccos(cos_t)
    v = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    small = th < 1e-8
    scale = np.where(small, 0.5, th / (2 * np.sin(np.where(small, 1.0, th))))
    return v * scale[..., None]


def se3_log(T: np.ndarray) -> np.ndarray:
    w = so3_log(T[..., :3, :3])
    _, a, b, c = _so3_parts(w)
    W = skew(w)
    eye = np.broadcast_to(np.eye(3), W.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * (W @ W)
    rho = np.linalg.solve(V, T[..., :3, 3][..., None])[..., 0]
    return np.concatenate([rho, w], -1)


def planar(T: np.ndarray) -> np.ndarray:
    """The planar clamp (SixDof2Mobile): keep x, y and the heading, read as
    atan2 of the rotation's first column, which holds at every heading
    (the axis-angle form is ill-conditioned at a half turn); z, roll and
    pitch go."""
    yaw = math.atan2(T[1, 0], T[0, 0])
    out = np.eye(4)
    out[:2, :2] = [[math.cos(yaw), -math.sin(yaw)],
                   [math.sin(yaw), math.cos(yaw)]]
    out[:2, 3] = T[:2, 3]
    return out


def rot_angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


# -- the keyframe submap ---------------------------------------------------------

def submap(pose: np.ndarray, kf_poses: np.ndarray, kf_clouds, window: int,
           grid: float, prec: Prec = Prec()) -> np.ndarray:
    """updateMap's map about ``pose``: the keyframes within SUBMAP_RADIUS
    (the nearest ``window`` of them), placed at their poses, concatenated
    and downsampled at ``grid``. ``kf_clouds`` are the reference's own
    downsampled keyframe scans (sensor frame)."""
    if len(kf_poses) == 0:
        return np.zeros((0, 3))
    d2 = np.sum((kf_poses[:, :3, 3] - pose[:3, 3]) ** 2, axis=1)
    sel = np.where(d2 <= SUBMAP_RADIUS ** 2)[0]
    sel = sel[np.argsort(d2[sel], kind="stable")[:window]]
    if len(sel) == 0:
        return np.zeros((0, 3))
    parts = [kf_clouds[i] @ kf_poses[i, :3, :3].T + kf_poses[i, :3, 3]
             for i in sel]
    return downsample(np.concatenate(parts).astype(np.float32), grid, prec)


# -- LOAM scan-to-map registration --------------------------------------------

def _knn5(tree, p: torch.Tensor):
    """Squared distances and indices of the five nearest map points (an
    exact k-d tree search on the map's coordinates)."""
    d, i = tree.query(p.double().numpy(), k=PLANE_PTS, workers=-1)
    return torch.as_tensor(d * d, dtype=p.dtype), torch.as_tensor(i)


def register(src: np.ndarray, mp: np.ndarray, pose0: np.ndarray,
             prec: Prec = Prec(), info: bool = False):
    """Point-to-plane Gauss-Newton of the (sensor-frame) scan ``src``
    against the map ``mp`` from ``pose0``, refitting the 5-NN planes at
    every iteration until the step is below GN_TOL: the pose the scan
    aligns to, planar-clamped (with ``info``, also the last J^T J and its
    valid rows). None when fewer than MIN_VALID_ROWS rows are valid or the
    map holds fewer than five points."""
    if len(mp) < PLANE_PTS:
        return None
    dt = prec.dtype
    s_t = prec.q(torch.as_tensor(src, dtype=dt))
    m_t = prec.q(torch.as_tensor(mp, dtype=dt))
    tree = cKDTree(m_t.double().numpy())
    sqrt_r = prec.q(torch.sqrt(torch.clamp(torch.linalg.norm(s_t, dim=1),
                                           min=1e-6)))
    pose = np.asarray(pose0, np.float64)
    for _ in range(GN_MAX_ITERS):
        P = prec.q(torch.as_tensor(pose, dtype=dt))
        p = prec.q(s_t @ P[:3, :3].T + P[:3, 3])
        d2, idx = _knn5(tree, p)
        d2 = prec.q(d2)
        pts = m_t[idx]                                     # (N, 5, 3)
        c = prec.q(pts.mean(dim=1))
        b = prec.q(pts - c[:, None, :])
        M = prec.q(torch.einsum("nki,nkj->nij", b, b))
        lam, V = torch.linalg.eigh(M)
        lam, n = prec.q(lam), prec.q(V[..., 0])
        fit_ok = (lam[:, 1] > MIN_PLANAR_EV) & (lam[:, 0] < MAX_THICKNESS_EV)
        resid = prec.q(torch.einsum("nki,ni->nk", b, n))
        plane_ok = torch.amax(torch.abs(resid), dim=1) <= PLANE_VALID_THRESH
        gate = d2[:, PLANE_PTS - 1] < MAX_SEARCH_SQ
        d = prec.q(torch.sum((p - c) * n, dim=1))
        s = prec.q(1.0 - 0.9 * torch.abs(d) / sqrt_r)
        valid = gate & fit_ok & plane_ok & (s > POINT_VALID_THRESH)
        if int(valid.sum()) < MIN_VALID_ROWS:
            return None
        J = prec.q(s[:, None] * torch.cat([n, torch.cross(p, n, dim=1)], 1))
        e = prec.q(s * d)
        w = valid.to(dt)[:, None]
        H = prec.q((J * w).T @ J)
        g = prec.q((J * w).T @ e)
        dx = prec.q(torch.linalg.solve(H, -g)).double().numpy()
        pose = prec.qn(se3_exp(dx) @ pose)
        if np.linalg.norm(dx) < GN_TOL:
            break
    if info:
        return planar(pose), H.double().numpy(), int(valid.sum())
    return planar(pose)


def residual_gap(judged: np.ndarray, aligned: np.ndarray, H: np.ndarray,
                 n_valid: int) -> float:
    """How much a judged pose misaligns the scan, in metres: the RMS change
    of the weighted point-to-plane residuals between the judged pose and
    the aligned one, sqrt(d^T (J^T J) d / n) with d the twist from one to
    the other. Directions the map pins cost what they cost the residuals;
    a direction it barely constrains (along a corridor) costs little."""
    d = se3_log(aligned @ np.linalg.inv(judged))
    return float(np.sqrt(max(d @ H @ d, 0.0) / max(n_valid, 1)))


# -- the pose graph -----------------------------------------------------------

def _residuals(poses, prior_pose, ei, ej, eT):
    """Edge residuals log(Tij^-1 Ti^-1 Tj) (E, 6) and the prior's on node
    0, log(Tp^-1 T0) (6,)."""
    Ti, Tj = poses[ei], poses[ej]
    r = se3_log(np.linalg.inv(eT) @ np.linalg.inv(Ti) @ Tj)
    rp = se3_log(np.linalg.inv(prior_pose) @ poses[0])
    return r, rp


def _stored(poses: np.ndarray, prec: Prec) -> np.ndarray:
    """Poses as the precision stores them: rounded, the rotation then
    brought back to the nearest rotation (as a solver's write-back does)."""
    if not prec.low:
        return poses
    out = prec.qn(poses)
    u, _, vt = np.linalg.svd(out[:, :3, :3])
    out[:, :3, :3] = u @ vt
    return out


def solve_graph(poses: np.ndarray, prior_pose: np.ndarray, prior_info,
                ei, ej, eT, einfo, prec: Prec = Prec()) -> np.ndarray:
    """Gauss-Newton on the graph's information-weighted squared residuals,
    right perturbations T <- T exp(xi), from ``poses`` until the step is
    below PG_TOL: the optimum the program's solve approaches. Jacobians by
    central differences in float64; the low precision stores the poses
    (``_stored``)."""
    poses = _stored(np.array(poses, np.float64), prec)
    ei, ej = np.asarray(ei, np.int64), np.asarray(ej, np.int64)
    eT, einfo = np.asarray(eT, np.float64), np.asarray(einfo, np.float64)
    prior_info = np.asarray(prior_info, np.float64)
    k = len(poses)
    h = 1e-6
    basis = np.eye(6) * h
    for _ in range(PG_MAX_ITERS):
        r, rp = _residuals(poses, prior_pose, ei, ej, eT)
        H = np.zeros((6 * k, 6 * k))
        g = np.zeros(6 * k)
        Ji = np.zeros((len(ei), 6, 6))
        Jj = np.zeros((len(ei), 6, 6))
        for a in range(6):
            d = se3_exp(basis[a])
            dm = se3_exp(-basis[a])
            # perturb every edge's i end (and then j end) at once
            rip = se3_log(np.linalg.inv(eT) @ np.linalg.inv(poses[ei] @ d)
                          @ poses[ej])
            rim = se3_log(np.linalg.inv(eT) @ np.linalg.inv(poses[ei] @ dm)
                          @ poses[ej])
            rjp = se3_log(np.linalg.inv(eT) @ np.linalg.inv(poses[ei])
                          @ (poses[ej] @ d))
            rjm = se3_log(np.linalg.inv(eT) @ np.linalg.inv(poses[ei])
                          @ (poses[ej] @ dm))
            Ji[:, :, a] = (rip - rim) / (2 * h)
            Jj[:, :, a] = (rjp - rjm) / (2 * h)
        for n in range(len(ei)):
            W = einfo[n]
            for (A, ia), (B, ib) in (((Ji[n], ei[n]), (Ji[n], ei[n])),
                                     ((Ji[n], ei[n]), (Jj[n], ej[n])),
                                     ((Jj[n], ej[n]), (Ji[n], ei[n])),
                                     ((Jj[n], ej[n]), (Jj[n], ej[n]))):
                H[6 * ia:6 * ia + 6, 6 * ib:6 * ib + 6] += A.T @ (W[:, None] * B)
            g[6 * ei[n]:6 * ei[n] + 6] += Ji[n].T @ (W * r[n])
            g[6 * ej[n]:6 * ej[n] + 6] += Jj[n].T @ (W * r[n])
        Jp = np.zeros((6, 6))
        for a in range(6):
            Jp[:, a] = (se3_log(np.linalg.inv(prior_pose) @ poses[0]
                                @ se3_exp(basis[a]))
                        - se3_log(np.linalg.inv(prior_pose) @ poses[0]
                                  @ se3_exp(-basis[a]))) / (2 * h)
        H[:6, :6] += Jp.T @ (prior_info[:, None] * Jp)
        g[:6] += Jp.T @ (prior_info * rp)
        dx = np.linalg.solve(H, -g).reshape(k, 6)
        poses = _stored(poses @ se3_exp(dx), prec)
        if np.abs(dx).max() < PG_TOL:
            break
    return poses
