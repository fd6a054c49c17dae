"""The PyTorch port's lio mode end to end, beside the JAX package.

- offline: the two cases of tests/test_pipeline_lio.py on the cached
  ``lio60s7`` sequence through the port (EKF proxy fed in stamp order,
  ``odom2map * local_odom`` prediction), the JAX package's ATE beside it;
- streamed: tests/test_streamed.py::test_streamed_lio's config and cached
  ``str30s1`` sequence at ``sync_every=8`` through both packages'
  ``run_streamed``. The port's local odometry comes from its host f32 EKF
  replay, the JAX package's from its compiled scan; measured on the CPU the
  largest per-scan translation gap is 0.064 mm, and the assertion allows
  1 mm. 29 registrations in batches of 8 leave a final batch of 5: the JAX
  package pads it to 8 and rewinds the chain, the port registers the 5;
- the chain across a partial batch: a 3-scan lio batch equals a 2-scan batch
  followed by a 1-scan batch bit for bit (poses, ``odom2map``, rows), so a
  short batch leaves the chain where the next one needs it;
- the lio batch body reads nothing from the device: its rows on a seeded
  two-scan batch equal, bit for bit, those of a formulation that branches in
  Python on each scan's flags.
"""

import numpy as np
import pytest
import torch

from simpleslam_tpu.pipeline import app as japp
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu.pipeline.streamed import run_streamed as j_run_streamed
from simpleslam_tpu.utils.config import Params as JParams
from simpleslam_tpu_torch import native
from simpleslam_tpu_torch.models.registration import make_register
from simpleslam_tpu_torch.ops import geometry as tgeo
from simpleslam_tpu_torch.ops import loam as tloam
from simpleslam_tpu_torch.ops import pointcloud as tpc
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.pipeline import streamed as tst
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger

LIO_CFG = {"mode": "lio", "backend": {"enable": False},
           "frontend": {"pcr": "loam"}, "tpu": {"scan_capacity": 16384}}
MAX_GAP_M = 0.001


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs several workers on a few cores: two torch threads a
    worker keeps them from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    TParams.reset()
    yield
    TParams.reset()
    TLogger.reset()


def _port(cfg):
    return tapp.SlamSystem(dict(cfg, torch={"device": "cpu"}))


def _ate(streams, result):
    return sim.ate_rmse(streams.gt_poses, result.poses, align=False)


@pytest.fixture(scope="module")
def lio_offline():
    world = sim.make_world(seed=7)
    streams = sim.cache_streams(
        "lio60s7", lambda: sim.simulate_sequence(world, n_scans=60, seed=7))
    JParams.load(LIO_CFG)
    jres = japp.run_offline(japp.SlamSystem(), streams)
    JParams.reset()
    system = _port(LIO_CFG)
    result = tapp.run_offline(system, streams)
    TParams.reset()
    print(f"lio60s7 offline ATE: port {_ate(streams, result):.4f} m, JAX "
          f"package {_ate(streams, jres):.4f} m")
    return streams, result, system, jres


def test_lio_trajectory_accuracy(lio_offline):
    streams, result, _, jres = lio_offline
    assert _ate(streams, result) < 0.15
    gap = np.linalg.norm(result.poses[:, :3, 3] - jres.poses[:, :3, 3], axis=1)
    print(f"offline lio: max per-scan translation gap to the JAX package "
          f"{gap.max() * 1e3:.2f} mm")
    assert gap.max() < 0.025     # the bound the lo-mode offline slice is held to


def test_lio_uses_local_odom(lio_offline):
    _, result, system, _ = lio_offline
    # the EKF proxy produced a local odom stream and odom2map was initialized
    assert system.ekf_proxy is not None
    assert system.frontend.local_odom is system.ekf_proxy.local_odom
    assert system.frontend.is_init_odom2map()
    # odom2map stays small: the EKF odom frame starts at the map origin and
    # only drifts by wheel slip over the short run
    o2m = system.frontend.odom2map.load()
    assert np.linalg.norm(o2m[:3, 3]) < 1.0
    assert result.converged_frac > 0.9


@pytest.fixture(scope="module")
def lio_streamed():
    world = sim.make_world(seed=1)
    streams = sim.cache_streams(
        "str30s1", lambda: sim.simulate_sequence(world, n_scans=30, seed=1))
    JParams.load(LIO_CFG)
    jres = j_run_streamed(japp.SlamSystem(), streams, sync_every=8)
    JParams.reset()
    result = tst.run_streamed(_port(LIO_CFG), streams, sync_every=8)
    TParams.reset()
    return streams, result, jres


def test_streamed_lio(lio_streamed):
    streams, r, jres = lio_streamed
    print(f"str30s1 streamed lio ATE: port {_ate(streams, r):.4f} m, JAX "
          f"package {_ate(streams, jres):.4f} m")
    assert _ate(streams, r) < 0.3
    assert r.converged_frac > 0.85
    assert r.keyframe_count > 2
    assert r.extras["ekf_chunks"] >= 1
    assert r.timers.count["ekf_replay"] >= 1


def test_streamed_lio_tracks_the_jax_trajectory(lio_streamed):
    _, r, jres = lio_streamed
    gap = np.linalg.norm(r.poses[:, :3, 3] - jres.poses[:, :3, 3], axis=1)
    print(f"max per-scan translation gap {gap.max() * 1e3:.3f} mm, over the "
          f"final partial batch {gap[25:].max() * 1e3:.3f} mm")
    assert gap.max() < MAX_GAP_M, gap.max()
    assert r.keyframe_count == jres.keyframe_count
    # 29 registrations: three batches of 8 and a final one of 5
    assert r.extras["n_batches"] == jres.extras["n_batches"] == 4
    assert r.extras["ekf_chunks"] == jres.extras["ekf_chunks"]


def test_feeder_local_odoms_match_the_jax_feeder(lio_streamed):
    """The per-scan local odometry both executors upload: the port's host
    replay against the JAX package's compiled one, through each package's
    own feeder."""
    from simpleslam_tpu.pipeline.streamed import _LocalOdomFeeder as JFeeder

    streams = lio_streamed[0]
    stamps = np.asarray(streams.scan_stamps)
    n = len(stamps)
    a = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    b = a.copy()
    fa, fb = tst._LocalOdomFeeder(streams, stamps, a), JFeeder(streams, stamps, b)
    for hi in (0, 8, n - 1):
        fa.ensure(hi)
        fb.ensure(hi)
        assert fa.filled == fb.filled == hi + 1
    assert fa.n_chunks == fb.n_chunks >= 1
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert np.abs(a[-1, :2, 3]).max() > 0.5      # the vehicle did move


@pytest.fixture(scope="module")
def lio_batch():
    """A target from the first scan of a seeded sequence, the next three
    scans prepped as the executor preps them, their local odometry from the
    feeder, and a chain that starts 0.11 m off."""
    TParams.load(dict(LIO_CFG, torch={"device": "cpu"}))
    reg = make_register()
    world = sim.make_world(seed=1)
    streams = sim.cache_streams(
        "str30s1", lambda: sim.simulate_sequence(world, n_scans=30, seed=1))
    p0 = streams.gt_poses[0]
    sub = streams.scans[0] @ p0[:3, :3].T + p0[:3, 3]
    _, target = reg.build_target_from_raw(
        tpc.from_numpy(sub.astype(np.float32), 16384, "cpu"), 0.5,
        torch.tensor(p0[:3, 3].astype(np.float32)), 16384)
    rows, _ = native.voxel_downsample_sort_quant_batch(
        [np.asarray(streams.scans[i], np.float32) for i in (1, 2, 3)], 0.5,
        2048, float(reg.TARGET_GRID), tst.UPLOAD_SCALE)
    stamps = np.asarray(streams.scan_stamps)
    local = np.tile(np.eye(4, dtype=np.float32), (len(stamps), 1, 1))
    tst._LocalOdomFeeder(streams, stamps, local).ensure(3)
    start = p0.astype(np.float32).copy()
    start[:3, 3] += np.array([0.1, -0.05, 0.0], np.float32)
    o2m = (start.astype(np.float64)
           @ np.linalg.inv(local[1].astype(np.float64))).astype(np.float32)
    TParams.reset()
    return (target, torch.from_numpy(rows), torch.from_numpy(local[1:4]),
            torch.tensor(start), torch.tensor(o2m))


def _lio_batch_body_with_host_branches(ds_stack, local_odoms, target, o2m,
                                       clamp, degen, jump_cap):
    """The lio batch body formulated with host reads: the stepwise GN loop,
    Python branches on each scan's converged flag, a stats row made from
    Python numbers."""
    rows = []
    prev = prev2 = None
    for raw_q, lo_pose in zip(ds_stack, local_odoms):
        pc = tst.upload_cloud(raw_q)
        init = tgeo.pose_compose(o2m, lo_pose)
        res = tloam.gn_loop_stepwise(pc, target, init, degen_per_row=degen)
        pose, conv = res.pose, bool(res.converged)
        if clamp:
            pose = tgeo.six_dof_to_mobile(pose)
        ok = bool(torch.all(torch.isfinite(pose)))
        if jump_cap > 0:
            jump = float(torch.linalg.norm(pose[:3, 3] - init[:3, 3]))
            ok = ok and jump <= np.float32(jump_cap if conv
                                           else jump_cap / 3.0)
        if not ok:
            pose = init
        o2m = tgeo.pose_compose(pose, tgeo.pose_inverse(lo_pose))
        stats = torch.tensor([float(ok and conv), 0.0, int(res.iters),
                              int(res.n_gathers), int(res.n_valid)],
                             dtype=torch.float32)
        rows.append(torch.cat([pose.reshape(16), stats]))
        prev2, prev = prev, pose
    return (prev, prev2, o2m), torch.stack(rows)


@pytest.mark.parametrize("jump_cap", [0.0, 10.0, 0.02],
                         ids=["no_jump_cap", "jump_accepted", "jump_rejected"])
def test_lio_batch_body_rows_equal_host_branch_formulation(lio_batch,
                                                           jump_cap):
    target, rows, local, start, o2m = lio_batch
    (pN, pN1, o2mN), packed = tst._batch_body(
        rows[:2], target, start, start, o2m, kind="loam", clamp=True,
        degen=0.0, jump_cap=jump_cap, local_odoms=local[:2])
    (qN, qN1, o2mQ), ref = _lio_batch_body_with_host_branches(
        rows[:2], local[:2], target, o2m, True, 0.0, jump_cap)
    assert packed.shape == (2, 21) and packed.dtype == torch.float32
    assert torch.equal(packed, ref)
    assert torch.equal(pN, qN) and torch.equal(pN1, qN1)
    assert torch.equal(o2mN, o2mQ) and not torch.equal(o2mN, o2m)
    # the prediction came through odom2map, not the velocity model: the
    # first init is odom2map * local_odom = the 0.11 m-off start
    moved = torch.linalg.norm(packed[0, :16].view(4, 4)[:3, 3] - start[:3, 3])
    if jump_cap == 0.02:   # the 0.1 m correction is rejected: the prediction
        assert packed[0, 16] == 0 and moved < 1e-5
    else:
        assert packed[0, 16] == 1 and moved > 0.05


def test_lio_chain_across_a_partial_batch(lio_batch):
    """Three scans as one batch, and as a batch of two followed by a batch
    of one: the same rows and the same chain bit for bit. A short final
    batch therefore needs no rewind of the poses or of ``odom2map``."""
    target, rows, local, start, o2m = lio_batch
    kw = dict(kind="loam", clamp=True, degen=0.0)
    whole_carry, whole = tst._batch_body(rows, target, start, start, o2m,
                                         local_odoms=local, **kw)
    (p, p2, o), head = tst._batch_body(rows[:2], target, start, start, o2m,
                                       local_odoms=local[:2], **kw)
    tail_carry, tail = tst._batch_body(rows[2:], target, p, p2, o,
                                       local_odoms=local[2:], **kw)
    assert torch.equal(torch.cat([head, tail]), whole)
    for a, b in zip(tail_carry, whole_carry):
        assert torch.equal(a, b)
    # odom2map_K = pose_K * local_odom_K^-1 for the last real scan
    want = tgeo.pose_compose(whole_carry[0], tgeo.pose_inverse(local[2]))
    assert torch.equal(whole_carry[2], want)


def test_lio_reloc_reanchors_odom2map():
    """An /initialpose reloc in lio mode resets the chain and re-anchors
    ``odom2map`` so the next prediction is the reloc pose: a run relocated
    before its first batch onto the pose its first registration found stays
    on the undisturbed run's trajectory (the first registration starts from
    another prediction, so it may land a few centimetres away; the scans
    after it agree to a fraction of a millimetre)."""
    world = sim.make_world(seed=1)
    streams = sim.cache_streams(
        "str30s1", lambda: sim.simulate_sequence(world, n_scans=30, seed=1))
    short = sim.SensorStreams(
        scan_stamps=streams.scan_stamps[:10], scans=streams.scans[:10],
        gt_poses=streams.gt_poses[:10], wheel_stamps=streams.wheel_stamps,
        wheel_poses=streams.wheel_poses, imu_stamps=streams.imu_stamps,
        imu_quats=streams.imu_quats)
    plain = tst.run_streamed(_port(LIO_CFG), short, sync_every=8)
    TParams.reset()
    system = _port(LIO_CFG)
    system.lidar_odometry.set_reloc_flag(plain.poses[1])
    moved = tst.run_streamed(system, short, sync_every=8)
    assert not system.lidar_odometry.reloc       # consumed
    gap = np.linalg.norm(moved.poses[:, :3, 3] - plain.poses[:, :3, 3], axis=1)
    assert gap[1] < 0.05 and gap[2:].max() < 1e-3, gap
    assert _ate(short, moved) < 0.3
