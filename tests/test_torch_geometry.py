"""Parity: the PyTorch port's geometry and 3x3 eigensolve against the JAX
package, on the same seeded inputs (numpy, handed to both).

Tolerance: both sides compute in f32 with the same formulas, but XLA and
PyTorch contract and order the few multiply-adds differently, so agreement
is to about 1e-5 relative (a few hundred f32 ulps at unit scale).
"""

import numpy as np
import pytest
import torch

from simpleslam_tpu.ops import geometry as jgeo
from simpleslam_tpu.ops import linalg3 as jlin
from simpleslam_tpu_torch.ops import geometry as tgeo
from simpleslam_tpu_torch.ops import linalg3 as tlin

RTOL, ATOL = 1e-5, 1e-5


def _close(t: torch.Tensor, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _twists(rng, n=64, small=False):
    k = rng.normal(size=(n, 6)).astype(np.float32)
    k[:, 3:] *= 1e-7 if small else 0.8
    return k


def _poses(rng, n=64):
    return np.array(jgeo.se3_exp(_twists(rng, n)), np.float32)


@pytest.mark.parametrize("small", [False, True], ids=["generic", "small-angle"])
def test_se3_exp_and_log(small):
    rng = np.random.default_rng(1)
    k = _twists(rng, small=small)
    T_t = tgeo.se3_exp(torch.tensor(k))
    _close(T_t, jgeo.se3_exp(k))
    T = np.asarray(jgeo.se3_exp(k))
    _close(tgeo.se3_log(torch.tensor(T)), jgeo.se3_log(T), atol=1e-4)
    _close(tgeo.so3_exp(torch.tensor(k[:, 3:])), jgeo.so3_exp(k[:, 3:]))


def test_so3_log_near_pi():
    rng = np.random.default_rng(2)
    axis = rng.normal(size=(32, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w = (axis * (np.pi - 1e-4)).astype(np.float32)
    R = np.asarray(jgeo.so3_exp(w))
    _close(tgeo.so3_log(torch.tensor(R)), jgeo.so3_log(R), atol=2e-3)


def test_j_se3_and_transform_points():
    rng = np.random.default_rng(3)
    p = rng.normal(size=(100, 3)).astype(np.float32) * 20
    _close(tgeo.j_se3(torch.tensor(p)), jgeo.j_se3(p))
    T = _poses(rng, 1)[0]
    _close(tgeo.transform_points(torch.tensor(T), torch.tensor(p)),
           jgeo.transform_points(T, p), atol=1e-4)
    A, B = _poses(rng, 2)
    _close(tgeo.pose_compose(torch.tensor(A), torch.tensor(B)),
           jgeo.pose_compose(A, B))
    _close(tgeo.pose_inverse(torch.tensor(A)), jgeo.pose_inverse(A))


def test_quaternion_round_trips():
    rng = np.random.default_rng(4)
    R = _poses(rng, 256)[:, :3, :3]
    _close(tgeo.rot_to_quat(torch.tensor(R)), jgeo.rot_to_quat(R))
    q = rng.normal(size=(256, 4)).astype(np.float32)
    _close(tgeo.quat_to_rot(torch.tensor(q)), jgeo.quat_to_rot(q))


def test_reorthonormalize_and_planar_clamp():
    rng = np.random.default_rng(5)
    T = _poses(rng, 128)
    T[:, :3, :3] += rng.normal(size=(128, 3, 3)).astype(np.float32) * 1e-3
    _close(tgeo.reorthonormalize(torch.tensor(T)), jgeo.reorthonormalize(T))
    # near-z rotations keep their yaw; tilted axes clamp to the identity
    k = _twists(rng, 128)
    k[:64, 3:5] *= 0.01
    T = np.asarray(jgeo.se3_exp(k))
    out = tgeo.six_dof_to_mobile(torch.tensor(T))
    _close(out, jgeo.six_dof_to_mobile(T))
    assert torch.all(out[:, 2, 3] == 0)


@pytest.mark.parametrize("kind", ["random", "planar", "diagonal"])
def test_symeig3x3_smallest(kind):
    rng = np.random.default_rng(6)
    if kind == "diagonal":
        M = np.tile(np.eye(3, dtype=np.float32) * 2.0, (16, 1, 1))
    else:
        pts = rng.normal(size=(256, 5, 3)).astype(np.float32)
        if kind == "planar":
            pts[..., 2] *= 0.01
        c = pts - pts.mean(axis=1, keepdims=True)
        M = np.einsum("nki,nkj->nij", c, c).astype(np.float32)
    lam_t, v_t = tlin.symeig3x3_smallest(torch.tensor(M))
    lam_j, v_j = jlin.symeig3x3_smallest(M)
    scale = float(np.abs(M).max())
    _close(lam_t, lam_j, atol=1e-5 * scale)
    np.testing.assert_allclose(np.abs(v_t.numpy()), np.abs(np.asarray(v_j)),
                               atol=1e-4)


def test_yaw_pitch_roll_round_trip_and_singular_branch():
    rng = np.random.default_rng(11)
    ypr = rng.uniform(-1.2, 1.2, size=(64, 3)).astype(np.float32)
    ypr[:, 0] *= 2.5                                  # yaw over (-3, 3)
    R_t, R_j = tgeo.ypr_to_rot(torch.tensor(ypr)), jgeo.ypr_to_rot(ypr)
    _close(R_t, R_j)
    _close(tgeo.rot_to_ypr(R_t), jgeo.rot_to_ypr(R_j), atol=2e-5)
    _close(tgeo.rot_to_ypr(R_t), ypr, atol=2e-5)
    # pitch of +-90 degrees exactly: the singular branch (yaw 0)
    sing = np.zeros((2, 3, 3), np.float32)
    sing[0, 2, 0], sing[0, 0, 2], sing[0, 1, 1] = -1.0, 1.0, 1.0
    sing[1, 2, 0], sing[1, 0, 2], sing[1, 1, 1] = 1.0, -1.0, 1.0
    got = tgeo.rot_to_ypr(torch.tensor(sing))
    _close(got, jgeo.rot_to_ypr(sing))
    assert got[:, 0].abs().max() == 0
    _close(got[:, 1].abs(), np.full(2, np.pi / 2, np.float32))


def test_correct_angles_wraps_about_the_reference():
    rng = np.random.default_rng(12)
    a = rng.uniform(-20, 20, size=256).astype(np.float32)
    ref = rng.uniform(-4, 4, size=256).astype(np.float32)
    got = tgeo.correct_angles(torch.tensor(a), torch.tensor(ref))
    _close(got, jgeo.correct_angles(a, ref), atol=1e-5)
    assert float((got - torch.tensor(ref)).abs().max()) <= np.pi + 1e-5
    # half-way cases round to even, as the reference's round does
    half = torch.tensor([np.pi, 3 * np.pi, -np.pi], dtype=torch.float64)
    want = jgeo.correct_angles(half.numpy(), np.zeros(3))
    _close(tgeo.correct_angles(half, torch.zeros(3, dtype=torch.float64)),
           want, atol=1e-12)


def test_quaternion_yaw_pitch_roll_and_identity():
    """``quat_to_ypr``, ``ypr_to_quat`` and ``pose_identity``: the same
    values as the reference's, and a round trip through both."""
    rng = np.random.default_rng(13)
    ypr = rng.uniform(-1.2, 1.2, size=(64, 3)).astype(np.float32)
    q_t, q_j = tgeo.ypr_to_quat(torch.tensor(ypr)), jgeo.ypr_to_quat(ypr)
    _close(q_t, q_j)
    _close(tgeo.quat_to_ypr(q_t), jgeo.quat_to_ypr(q_j), atol=2e-5)
    _close(tgeo.quat_to_ypr(q_t), ypr, atol=2e-5)
    q = rng.normal(size=(64, 4)).astype(np.float32)   # not normalized
    _close(tgeo.quat_to_ypr(torch.tensor(q)), jgeo.quat_to_ypr(q), atol=2e-5)
    eye = tgeo.pose_identity()
    assert eye.dtype == torch.float32 and eye.device.type == "cpu"
    np.testing.assert_array_equal(eye.numpy(), np.asarray(jgeo.pose_identity()))
    assert tgeo.pose_identity(torch.float64).dtype == torch.float64
