"""The streamed executor's pose chain in the hand kernels of
``csrc/pose_chain.cu`` against the torch chain of ``_batch_body``.

``csrc/pose_chain.h`` holds everything the kernels ``scan_dequant`` and
``pose_step`` compute; ``native.pose_chain_dequant`` and
``native.pose_chain_step`` run it on the host (g++, no contraction). Here
they are held against ``streamed.upload_cloud``, ``streamed._predict`` and
``streamed._chain`` (the torch chain that ``_batch_body`` runs on CPU
tensors) one step at a time, at the edges of the planar clamp (headings at
and near a half turn, rotations near zero and near pi, axes either side of
the |axis.z| > 0.95 gate), with non-finite registrations, the jump guard
and the step cap, in lo and lio mode, and over whole batches. Flags and
counts must be equal and every pose entry within 1e-6 (relative above 1 m:
f32 translations of tens of metres carry 2e-6 m steps).

The ``cuda`` test runs one 32-scan batch both ways on the card (the
kernels, and the torch chain on CUDA tensors) and compares the packed rows.
This file imports no JAX, so it runs on the card's machine:
``python3 -m pytest --noconftest -o addopts="" tests/test_torch_pose_step.py``.
"""

import math
import zlib

import numpy as np
import pytest
import torch

from simpleslam_tpu_torch import native
from simpleslam_tpu_torch.ops import geometry as tgeo
from simpleslam_tpu_torch.ops import loam_kernels as lk
from simpleslam_tpu_torch.ops.pointcloud import PAD_COORD
from simpleslam_tpu_torch.pipeline import streamed as tst

TOL = dict(rtol=1e-6, atol=1e-6)


def _rot(axis, angle):
    """Rodrigues in float64, rounded to f32."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * K @ K


def _pose(axis=(0, 0, 1), angle=0.0, t=(0.0, 0.0, 0.0)):
    T = np.eye(4)
    T[:3, :3] = _rot(axis, angle)
    T[:3, 3] = t
    return T.astype(np.float32)


def _random_pose(rng, tilt=0.05, reach=20.0):
    axis = np.array([*(rng.normal(size=2) * tilt), 1.0])
    return _pose(axis, rng.uniform(-math.pi, math.pi),
                 rng.uniform(-reach, reach, 3))


def _near(pose, rng, dt=0.3, dr=0.02):
    d = _pose(rng.normal(size=3), rng.uniform(-dr, dr),
              rng.uniform(-dt, dt, 3))
    return (pose.astype(np.float64) @ d).astype(np.float32)


def _torch_step(reg_pose, conv, fit, counts, init, state, local, local_next,
                clamp, jump_cap, has_next):
    """``_chain`` and the next ``_predict`` on CPU tensors, in the dtypes the
    registers hand over: (packed (21,), state (3, 4, 4), init_next)."""
    prev, _, o2m = (torch.from_numpy(s.copy()) for s in state)
    iters, gathers, support = (torch.tensor(c, dtype=torch.int32)
                               for c in counts)
    tl = None if local is None else torch.from_numpy(local)
    pose, o2m, row = tst._chain(
        torch.from_numpy(reg_pose), torch.from_numpy(init),
        torch.tensor(conv), torch.tensor(fit, dtype=torch.float32), iters,
        gathers, support, o2m, clamp, jump_cap, tl)
    nxt = None
    if has_next:
        nxt = tst._predict(pose, prev, o2m, None if local_next is None
                           else torch.from_numpy(local_next)).numpy()
    return row.numpy(), np.stack([pose.numpy(), prev.numpy(),
                                  o2m.numpy()]), nxt


def _reg_row(pose, conv, counts):
    return np.concatenate([pose.reshape(16), [float(conv)],
                           np.asarray(counts, np.float32)]).astype(np.float32)


def _assert_rows(got, want):
    """Flags and counts equal, pose entries within TOL."""
    assert np.array_equal(got[16:], want[16:]), (got[16:], want[16:])
    np.testing.assert_allclose(got[:16], want[:16], **TOL)


def _case(name):
    """One registration's hand-over, named for the edge it sits on:
    (K3's pose, converged, clamp, jump cap, init, state, lio)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    prev = _random_pose(rng)
    prev2 = _near(prev, rng, dt=1.5, dr=0.05)
    init = _near(prev, rng, dt=1.5, dr=0.05)
    o2m = np.eye(4, dtype=np.float32)
    t = init[:3, 3] + rng.uniform(-0.05, 0.05, 3).astype(np.float32)
    pose = _near(init, rng, dt=0.05, dr=0.01)
    conv, clamp, cap, lio = True, True, 0.0, False
    kind, _, arg = name.partition(":")
    if kind == "random":
        pose = _near(init, rng)
        conv = bool(rng.integers(2))
    elif kind == "no-clamp":
        clamp = False
    elif kind == "heading":   # degrees of a pure yaw, tilted by arg's roll
        deg, _, roll = arg.partition("/")
        R = _rot((0, 0, 1), math.radians(float(deg))) @ _rot(
            (1, 0, 0), float(roll or 0.0))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3], pose[:3, 3] = R, t
    elif kind == "tiny":      # an angle under so3_log's 1e-4 cut
        pose = _pose(rng.normal(size=3), float(arg), t)
    elif kind == "near-pi":   # within 1e-3 of a half turn about arg's axis
        axis = {"z": (0.02, -0.01, 1.0), "x": (1.0, 0.1, 0.0),
                "tilted": (0.2, -0.3, 0.93)}[arg]
        pose = _pose(axis, math.pi - 4e-4, t)
    elif kind == "gate":      # |axis.z| either side of 0.95
        z = float(arg)
        pose = _pose((math.sqrt(1 - z * z), 0.0, z), 0.3, t)
    elif kind == "nonfinite":  # a NaN or an inf in the translation or R
        pose = pose.copy()
        pose[{"t": (0, 3), "inf": (1, 3), "R": (1, 2), "Rinf": (2, 2)}[
            arg]] = np.inf if "inf" in arg else np.nan
    elif kind in ("jump", "far-jump"):   # 0.5 or 2 m from init, 1 m cap
        cap = 1.0
        conv = arg != "not-conv"
        init = init.copy()
        init[2, 3] = 0.0
        pose = init.copy()
        pose[0, 3] += 2.0 if kind == "far-jump" else 0.5
    elif kind == "step-cap":  # an 8 m step from prev2 to prev
        prev2 = prev.copy()
        prev2[:3, 3] -= np.array([6.0, -5.0, 1.0], np.float32)
    elif kind == "lio":
        lio = True
        o2m = _random_pose(rng, reach=5.0)
    return pose, conv, clamp, cap, init, np.stack([prev, prev2, o2m]), lio


CASES = (["random:%d" % i for i in range(6)]
         + ["no-clamp", "heading:179.9", "heading:-179.9", "heading:180",
            "heading:-180", "heading:180/0.01", "heading:-179.95/-0.02",
            "tiny:5e-5", "tiny:2e-6", "near-pi:z", "near-pi:x",
            "near-pi:tilted", "gate:0.951", "gate:0.949", "gate:-0.951",
            "nonfinite:t", "nonfinite:inf", "nonfinite:R", "nonfinite:Rinf",
            "jump:conv",
            "jump:not-conv", "far-jump", "step-cap", "lio"])


@pytest.mark.parametrize("has_next", [True, False], ids=["next", "last"])
@pytest.mark.parametrize("name", CASES)
def test_pose_step_matches_the_torch_chain(name, has_next):
    pose, conv, clamp, cap, init, state, lio = _case(name)
    rng = np.random.default_rng(7)
    local = _random_pose(rng, reach=30.0) if lio else None
    local_next = _near(local, rng) if lio else None
    counts = (3, 2, 1234)
    got, g_state, g_next = native.pose_chain_step(
        _reg_row(pose, conv, counts), None, init, state, local, local_next,
        clamp, cap, tst.STEP_CAP, has_next)
    want, w_state, w_next = _torch_step(pose, conv, 0.0, counts, init, state,
                                        local, local_next, clamp, cap,
                                        has_next)
    _assert_rows(got, want)
    np.testing.assert_allclose(g_state, w_state, **TOL)
    if has_next:
        np.testing.assert_allclose(g_next, w_next, **TOL)
    else:
        assert g_next is None
    if name.startswith(("jump", "far-jump", "nonfinite:t", "nonfinite:inf")):
        # the guards' outcome, read from the torch chain's own row
        rejected = name != "jump:conv"
        assert (want[16] == 0) == (rejected or not conv)
        if rejected:
            np.testing.assert_array_equal(want[:16], init.reshape(16))


def test_the_edges_take_their_branches():
    """The cases reach what they are named for, in the torch chain: so3_log's
    branches by their angle, the gate and the NaN rotation by the clamp's
    outcome. (At 179.9 deg the generic branch's f32 rounding turns the
    heading by 1.6 deg: the torch chain does so, and the kernels with it.)"""
    def angle(name):
        R = torch.from_numpy(_case(name)[0])[:3, :3]
        return float(torch.arccos(torch.clamp(
            (R[0, 0] + R[1, 1] + R[2, 2] - 1.0) * 0.5, -1.0, 1.0)))

    def clamped(name):
        pose, conv, _, _, init, state, _ = _case(name)
        row, _, _ = _torch_step(pose, conv, 0.0, (1, 1, 1), init, state,
                                None, None, True, 0.0, False)
        return row[:16].reshape(4, 4)

    for name in ("heading:180", "heading:-180", "heading:180/0.01",
                 "heading:-179.95/-0.02", "near-pi:z", "near-pi:x",
                 "near-pi:tilted"):
        assert math.pi - angle(name) < 1e-3, name
    for name in ("heading:179.9", "heading:-179.9"):
        assert 1e-3 < math.pi - angle(name) < 2e-3, name
    assert angle("tiny:5e-5") < 1e-4 and angle("tiny:2e-6") < 1e-4
    for name in ("heading:180", "heading:-180"):
        R = clamped(name)[:3, :3]
        assert abs(abs(math.atan2(R[1, 0], R[0, 0])) - math.pi) < 1e-6, name
    assert np.allclose(clamped("near-pi:x")[:3, :3], np.eye(3))
    assert not np.allclose(clamped("gate:0.951")[:3, :3], np.eye(3))
    assert not np.allclose(clamped("gate:-0.951")[:3, :3], np.eye(3))
    assert np.allclose(clamped("gate:0.949")[:3, :3], np.eye(3))
    # a NaN rotation clamps to the identity at the registered (x, y)
    R = clamped("nonfinite:R")
    assert np.isfinite(R).all() and np.allclose(R[:3, :3], np.eye(3))


def test_fitness_and_counts_pass_through():
    pose, conv, _, _, init, state, _ = _case("random:0")
    got, _, _ = native.pose_chain_step(
        _reg_row(pose, True, (8, 3, 77)), 0.125, init, state, None, None,
        True, 0.0, tst.STEP_CAP, True)
    assert list(got[16:]) == [1.0, 0.125, 8.0, 3.0, 77.0]


@pytest.mark.parametrize("mode", ["lo", "lo-step-cap", "lio"])
def test_scan_dequant_matches_upload_and_prediction(mode):
    rng = np.random.default_rng(3)
    rows = rng.integers(-32767, 32767, (3, 300, 3)).astype(np.int16)
    rows[:, 250:] = tst.UPLOAD_PAD            # the padded tail
    rows[1, 7, 0] = tst.UPLOAD_PAD            # a padded row inside
    rows[2, 9, 1:] = tst.UPLOAD_PAD           # y and z at the sentinel
    prev = _random_pose(rng)
    prev2 = _near(prev, rng, dt=0.2)
    if mode == "lo-step-cap":   # a 7.9 m step
        prev2[:3, 3] = prev[:3, 3] - np.array([6.0, -5.0, 1.0], np.float32)
    o2m = _random_pose(rng, reach=5.0)
    local = _random_pose(rng) if mode == "lio" else None
    xyz, mask, state, init0 = native.pose_chain_dequant(
        rows, prev, prev2, o2m, local, tst.UPLOAD_SCALE, tst.UPLOAD_PAD,
        PAD_COORD, tst.STEP_CAP)
    for k in range(3):
        pc = tst.upload_cloud(torch.from_numpy(rows[k]))
        assert np.array_equal(xyz[k], pc.xyz.numpy())
        assert np.array_equal(mask[k], pc.mask.numpy())
    assert not mask[1, 7] and mask[2, 9] and mask[:, :250].sum() == 749
    assert np.array_equal(state, np.stack([prev, prev2, o2m]))
    want = tst._predict(*(torch.from_numpy(p) for p in (prev, prev2, o2m)),
                        None if local is None else torch.from_numpy(local))
    np.testing.assert_allclose(init0, want.numpy(), **TOL)
    if mode == "lo-step-cap":
        step = np.linalg.inv(prev.astype(np.float64)) @ init0
        assert abs(np.linalg.norm(step[:3, 3]) - tst.STEP_CAP) < 1e-4


def _scripted_register(n, seed):
    """Registration results that depend on the start they are given, as
    ``register_kind`` hands them over: the start moved by a scan's own small
    transform (one scan non-finite, one unconverged)."""
    rng = np.random.default_rng(seed)
    deltas = [torch.from_numpy(_pose(rng.normal(size=3),
                                     rng.uniform(-0.03, 0.03),
                                     rng.uniform(-0.2, 0.2, 3)))
              for _ in range(n)]

    def register(k, init):
        pose = tgeo.pose_compose(init, deltas[k])
        if k == 2:
            pose = pose.clone()
            pose[0, 3] = float("nan")
        counts = torch.tensor([2 + k % 3, 1 + k % 2, 500 + k],
                              dtype=torch.int32)
        return (pose, torch.tensor(k != 4), torch.zeros(()), *counts)
    return register


@pytest.mark.parametrize("mode,jump_cap", [("lo", 0.0), ("lo", 0.1),
                                           ("lio", 0.0)])
def test_a_batch_through_the_host_build_equals_the_torch_chain(
        monkeypatch, mode, jump_cap):
    """Six scans: ``_batch_body`` on CPU tensors (the torch chain) against
    ``scan_dequant`` and a ``pose_step`` per scan on the host. Each step is
    given the torch chain's own start, state and registration for its scan
    and held to the torch chain's row, state and next start: torch's CPU
    sin and cos (SLEEF) and the host's libm part by an ulp now and then,
    which a free-running chain would carry on. (On the card both sides
    call the same CUDA functions.)"""
    n = 6
    rng = np.random.default_rng(11)
    rows = rng.integers(-3000, 3000, (n, 64, 3)).astype(np.int16)
    rows[:, 60:] = tst.UPLOAD_PAD
    prev = _random_pose(rng)
    prev2 = _near(prev, rng, dt=1.0)
    o2m = _random_pose(rng, reach=5.0) if mode == "lio" else np.eye(
        4, dtype=np.float32)
    local = (np.stack([_random_pose(rng) for _ in range(n)])
             if mode == "lio" else None)
    register = _scripted_register(n, 5)
    seen = []

    def fake_register_kind(pc, target, init, *args):
        out = register(len(seen), init)
        seen.append((pc, init.numpy(), out))
        return out

    monkeypatch.setattr(tst, "register_kind", fake_register_kind)
    (w_prev, w_prev2, w_o2m), want = tst._batch_body(
        torch.from_numpy(rows), None, torch.from_numpy(prev),
        torch.from_numpy(prev2), torch.from_numpy(o2m), "loam", True, 0.0,
        jump_cap, None if local is None else torch.from_numpy(local))
    want = want.numpy()
    assert len(seen) == n
    assert want[2, 16] == 0 and want[4, 16] == 0    # non-finite, unconverged

    xyz, mask, state, init0 = native.pose_chain_dequant(
        rows, prev, prev2, o2m, None if local is None else local[0],
        tst.UPLOAD_SCALE, tst.UPLOAD_PAD, PAD_COORD, tst.STEP_CAP)
    np.testing.assert_allclose(init0, seen[0][1], **TOL)
    # the torch chain's state before each scan, from its rows
    states = [np.stack([prev, prev2, o2m])]
    for k in range(n):
        pose = torch.from_numpy(want[k, :16].reshape(4, 4).copy())
        o2m_k = (tgeo.pose_compose(pose, tgeo.pose_inverse(
            torch.from_numpy(local[k]))).numpy() if local is not None
                 else o2m)
        states.append(np.stack([pose.numpy(), states[-1][0], o2m_k]))
    np.testing.assert_array_equal(
        states[-1], np.stack([w_prev.numpy(), w_prev2.numpy(),
                              w_o2m.numpy()]))
    for k in range(n):
        pc, init, (pose, conv, fit, iters, gathers, support) = seen[k]
        assert np.array_equal(xyz[k], pc.xyz.numpy())
        assert np.array_equal(mask[k], pc.mask.numpy())
        reg = np.concatenate([pose.numpy().reshape(16), [float(conv)],
                              [int(iters), int(gathers), int(support)]])
        nxt = k + 1 < n
        row, state, init_next = native.pose_chain_step(
            reg, float(fit), init, states[k],
            None if local is None else local[k],
            local[k + 1] if local is not None and nxt else None, True,
            jump_cap, tst.STEP_CAP, nxt)
        _assert_rows(row, want[k])
        np.testing.assert_allclose(state, states[k + 1], **TOL)
        if nxt:
            np.testing.assert_allclose(init_next, seen[k + 1][1], **TOL)


@pytest.mark.cuda
def test_batch_of_32_scans_kernels_against_the_torch_chain_on_the_card():
    """One 32-scan batch on a merged map, through the kernels (K3 and the
    chain's two) and through the torch chain on CUDA tensors (K3 inside
    ``register_kind``): the same packed rows, flags and counts equal, poses
    within 1e-4 (the starts part by the 4x4 products' rounding, cuBLAS's
    against the kernels' order); one dequantize launch and 32 step launches,
    and the queries bit-identical to ``upload_cloud``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chain kernels have no CPU mode")
    from simpleslam_tpu_torch.ops import pointcloud as tpc
    from simpleslam_tpu_torch.ops import voxel as tvox
    from simpleslam_tpu_torch.pipeline import simulate as sim

    dev = torch.device("cuda")
    n = 32
    world = sim.make_world(seed=0)
    _, poses = sim.make_trajectory(n + 1, 0.1, speed=1.5)
    rng = np.random.default_rng(0)
    scans = [sim.simulate_scan(world, sim.sensor_from_body(p), rng=rng)
             for p in poses]
    sub = tpc.from_numpy((scans[0] @ poses[0][:3, :3].T
                          + poses[0][:3, 3]).astype(np.float32), 32768, dev)
    center = torch.tensor(poses[0][:3, 3].astype(np.float32), device=dev)
    vm = tvox.build_merged_dense_voxel_map(
        tvox.voxel_downsample(sub, 0.5, center), 2.0, center, (48, 48, 8), 24)
    rows, _ = native.voxel_downsample_sort_quant_batch(
        [np.asarray(s, np.float32) for s in scans[1:]], 0.5, 4096, 2.0,
        tst.UPLOAD_SCALE)
    rows_d = torch.from_numpy(rows).to(dev)
    start = torch.tensor(poses[0].astype(np.float32), device=dev)
    eye = torch.eye(4, device=dev)
    args = (rows_d, vm, start, start, eye, "loam", True, 0.0, 0.0, None,
            None, None, None)
    tst._batch_body_kernels(*args)   # builds the library
    torch.cuda.synchronize()
    lk.reset_counts()
    (p_k, p2_k, o_k), got = tst._batch_body_kernels(*args)
    assert (lk.DEQUANT_LAUNCHES, lk.STEP_LAUNCHES, lk.K3_LAUNCHES) == (
        1, n, n)
    (p_t, p2_t, o_t), want = tst._batch_body_plain(*args)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(got).all() and want[:, 16].sum() >= n - 2
    assert np.array_equal(got[:, 16:], want[:, 16:])
    np.testing.assert_allclose(got[:, :16], want[:, :16], rtol=0, atol=1e-4)
    for a, b in ((p_k, p_t), (p2_k, p2_t), (o_k, o_t)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=1e-4)
    chain = lk.scan_dequant(rows_d, start, start, eye, None,
                            tst.UPLOAD_SCALE, tst.UPLOAD_PAD, PAD_COORD,
                            tst.STEP_CAP)
    for k in (0, n - 1):
        pc = tst.upload_cloud(rows_d[k])
        assert torch.equal(chain.xyz[k], pc.xyz)
        assert torch.equal(chain.mask[k], pc.mask)
