"""SE(3)/SO(3) manifold ops and rotation conversions on torch tensors.

Port of ``simpleslam_tpu/ops/geometry.py`` (same formulas, same small-angle
cutoffs, same branch-free selection), batched over leading dimensions. Each
function keeps its input's dtype and device. Poses are 4x4 homogeneous
matrices; twists are ordered [translation, rotation] as in the reference.
"""

from __future__ import annotations

import math

import torch

from .linalg3 import solve3x3

_EPS = 1e-6


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _safe_norm(w: torch.Tensor):
    """(small_mask (..., 1), norm with 1.0 where small (..., 1))."""
    sq = torch.sum(w * w, dim=-1, keepdim=True)
    small = sq < _EPS * _EPS
    return small, torch.sqrt(torch.where(small, torch.ones_like(sq), sq))


def _eye3(w: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=w.dtype, device=w.device).expand(
        w.shape[:-1] + (3, 3))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, (..., 3) -> (..., 3, 3); 2nd-order Taylor form
    below the small-angle cutoff."""
    small, t_safe = _safe_norm(w)
    t = torch.where(small, torch.zeros_like(t_safe), t_safe)
    a = w / t_safe
    ct = torch.cos(t)[..., None]
    st = torch.sin(t)[..., None]
    eye = _eye3(w)
    aa = a[..., :, None] * a[..., None, :]
    R = ct * eye + (1.0 - ct) * aa + st * skew(a)
    W = skew(w)
    R_taylor = eye + W + 0.5 * (W @ W)
    return torch.where(small[..., None], R_taylor, R)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) rotation-vector log map (stable near 0 and pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    t = torch.arccos(cos_t)
    w_hat = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = torch.sin(t)
    near_zero = t < 1e-4
    near_pi = math.pi - t < 1e-3
    denom = torch.where(sin_t == 0, torch.ones_like(sin_t), 2.0 * sin_t)
    scale = torch.where(near_zero, torch.full_like(t, 0.5), t / denom)
    w_generic = w_hat * scale[..., None]
    # near pi: w = t * axis, axis magnitudes from the symmetric part's
    # diagonal, signs from the off-diagonal sums against the dominant axis
    B = (R + R.transpose(-1, -2)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp(
        (diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + 1e-12), 0.0, 1.0)
    axis_abs = torch.sqrt(axis_sq)
    k = torch.argmax(axis_abs, dim=-1, keepdim=True)           # (..., 1)
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    off = torch.stack([
        torch.stack([axis_abs[..., 0], s01, s02], dim=-1),
        torch.stack([s01, axis_abs[..., 1], s12], dim=-1),
        torch.stack([s02, s12, axis_abs[..., 2]], dim=-1),
    ], dim=-2)                                                 # (..., 3, 3)
    row = torch.gather(off, -2, k[..., None].expand(k.shape[:-1] + (1, 3)))
    row = row[..., 0, :]
    signs = torch.where(row >= 0, 1.0, -1.0).to(R.dtype)
    lanes = torch.arange(3, device=R.device)
    signs = torch.where(lanes == k, torch.ones_like(signs), signs)
    w_pi = signs * axis_abs * t[..., None]
    w = torch.where(near_pi[..., None], w_pi, w_generic)
    return torch.where(near_zero[..., None], w_hat * 0.5, w)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V matrix of the SE(3) exp map."""
    small, t_safe = _safe_norm(w)
    t = torch.where(small, torch.zeros_like(t_safe), t_safe)
    a = w / t_safe
    st_over_t = torch.sin(t)[..., None] / t_safe[..., None]
    one_m_ct_over_t = (1.0 - torch.cos(t))[..., None] / t_safe[..., None]
    eye = _eye3(w)
    aa = a[..., :, None] * a[..., None, :]
    V = st_over_t * eye + (1.0 - st_over_t) * aa + one_m_ct_over_t * skew(a)
    W = skew(w)
    V_taylor = eye + 0.5 * W + (W @ W) / 6.0
    return torch.where(small[..., None], V_taylor, V)


def se3_exp(k: torch.Tensor) -> torch.Tensor:
    """SE(3) exp: (..., 6) twist [rho, w] -> (..., 4, 4)."""
    p = k[..., :3]
    w = k[..., 3:]
    R = so3_exp(w)
    V = _so3_left_jacobian(w)
    t = torch.einsum("...ij,...j->...i", V, p)
    return make_pose(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log: (..., 4, 4) -> (..., 6) twist [rho, w].

    rho = V^-1 t by Cramer's rule (V is well conditioned below a full
    turn): unlike ``torch.linalg.solve`` it stays finite under
    ``vmap(jacfwd(...))``, which returns NaN tangents for a batch of
    identical systems (the pose graph's padding edges)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    rho, _ = solve3x3(_so3_left_jacobian(w), t)
    return torch.cat([rho, w], dim=-1)


def j_se3(p: torch.Tensor) -> torch.Tensor:
    """Point Jacobian d(exp(x) p)/dx at x=0: (..., 3) -> (..., 3, 6)."""
    return torch.cat([_eye3(p), -skew(p)], dim=-1)


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] made on the device (a host list would be a blocking copy)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def pose_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def pose_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_pose(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def pose_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) pose to (..., 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) unit quaternion (w, x, y, z), Shepperd's
    method with the reference's branch-free case selection."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 0.5
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 0.5
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) * 0.5
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) * 0.5
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)

    best = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    sel = torch.where(tr > 0, torch.zeros_like(best), best)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)                # (..., 4, 4)
    q = torch.gather(qs, -2, sel[..., None, None].expand(sel.shape + (1, 4)))
    q = q[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z) -> (..., 3, 3). Normalizes first."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def reorthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Snap the rotation block back onto SO(3) via a quaternion round trip
    (``trans::T2SE3``), applied after the GN pose updates."""
    R = quat_to_rot(rot_to_quat(T[..., :3, :3]))
    return make_pose(R, T[..., :3, 3])


def six_dof_to_mobile(T: torch.Tensor) -> torch.Tensor:
    """Planar clamp (``trans::SixDof2Mobile``): keep (x, y) and, when the
    rotation axis is near +/-Z (|axis.z| > 0.95), a pure yaw of the same
    angle; otherwise the rotation becomes the identity, as in the reference.
    """
    w = so3_log(T[..., :3, :3])
    angle = torch.linalg.norm(w, dim=-1)
    safe = torch.where(angle < _EPS, torch.ones_like(angle), angle)
    axis_z = w[..., 2] / safe
    near_z = torch.abs(axis_z) > 0.95
    yaw = torch.where(near_z, angle * torch.sign(axis_z),
                      torch.zeros_like(angle))
    cz, sz = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(cz)
    one = torch.ones_like(cz)
    Rz = torch.stack(
        [
            torch.stack([cz, -sz, zero], dim=-1),
            torch.stack([sz, cz, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    t = T[..., :3, 3]
    t = torch.stack([t[..., 0], t[..., 1], torch.zeros_like(t[..., 2])], dim=-1)
    return make_pose(Rz, t)


def rot_to_ypr(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (yaw, pitch, roll), static-axis ZYX, with the singular
    branch of ``trans::q2ypr`` (trans.hpp:24-43)."""
    r20 = R[..., 2, 0]
    singular = torch.abs(r20) >= 1.0
    zero = torch.zeros_like(r20)
    yaw = torch.where(singular, zero, torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    pitch = torch.where(singular, torch.sign(-r20) * (math.pi / 2),
                        -torch.arcsin(torch.clamp(r20, -1.0, 1.0)))
    roll = torch.where(singular, torch.atan2(R[..., 0, 1], R[..., 0, 2]),
                       torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    return torch.stack([yaw, pitch, roll], dim=-1)


def quat_to_ypr(q: torch.Tensor) -> torch.Tensor:
    return rot_to_ypr(quat_to_rot(q))


def ypr_to_rot(ypr: torch.Tensor) -> torch.Tensor:
    """(yaw, pitch, roll) -> R = Rz(yaw) Ry(pitch) Rx(roll)
    (trans.hpp:45-50)."""
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr,
                         cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr,
                         sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def ypr_to_quat(ypr: torch.Tensor) -> torch.Tensor:
    return rot_to_quat(ypr_to_rot(ypr))


def correct_angles(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Wrap ``a`` into (ref - pi, ref + pi] (Math.hpp:24-29), branch-free;
    ``torch.round`` rounds half to even, as the reference's does."""
    return a - 2.0 * math.pi * torch.round((a - ref) / (2.0 * math.pi))
