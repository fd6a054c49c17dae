"""The PyTorch port's streamed executor end to end, beside the JAX package.

- lo: ``run_streamed`` on tests/test_streamed.py's config and cached
  ``str45s3`` sequence at ``sync_every=8`` meets that file's bounds against
  the port's own offline replay, and tracks the JAX package's
  ``run_streamed`` scan by scan: measured on the CPU, the largest per-scan
  translation gap is 0.066 mm; the assertion allows 5 mm (f32 sums in
  another order, the int16 upload identical in both).
- the resident backend worker on the same sequence (test_streamed.py's
  backend case); an exception on it stops the replay in the main loop.
- the step cap: a chain seeded with a 100 m disagreement advances at most
  STEP_CAP per scan (test_streamed.py's case, on the port's batch), with
  and without the optional jump rejection.
- the batch body reads nothing from the device: its packed rows on a seeded
  two-scan batch equal, bit for bit, those of the earlier formulation that
  branched in Python on each scan's converged flag and counts (with the
  optional jump rejection off, accepting and rejecting); on a CUDA device it
  runs under ``torch.cuda.set_sync_debug_mode("error")``.
- ``tpu.sync_backend``: two runs of ``str30det3`` give bit-identical poses.
- the full chain: tests/test_pipeline_lc.py's courtyard world, config and
  cached ``lc_courtyard`` sequence through the port (backend + ScanContext
  + VGICP loop closure), held to that file's four bounds; the JAX
  package's ATE on the same run is printed beside the port's.
"""

import numpy as np
import pytest
import torch

from simpleslam_tpu.pipeline import app as japp
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu.pipeline.streamed import run_streamed as j_run_streamed
from simpleslam_tpu.utils.config import Params as JParams
from simpleslam_tpu_torch import native
from simpleslam_tpu_torch.models.backend import LC_VAR
from simpleslam_tpu_torch.models.registration import make_register
from simpleslam_tpu_torch.ops import geometry as tgeo
from simpleslam_tpu_torch.ops import loam as tloam
from simpleslam_tpu_torch.ops import loam_kernels as lk
from simpleslam_tpu_torch.ops import pointcloud as tpc
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.pipeline import streamed as tst
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger
from test_pipeline_lc import N_SCANS, RADIUS, SPEED, make_courtyard

LO_CFG = {"mode": "lo", "frontend": {"pcr": "loam"},
          "tpu": {"scan_capacity": 16384}}
MAX_GAP_M = 0.005

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


def _cfg(backend, **extra):
    return dict(LO_CFG, backend=backend, **extra)


def _port(cfg):
    return tapp.SlamSystem(dict(cfg, torch={"device": "cpu"}))


@pytest.fixture(scope="module")
def lo_runs():
    world = sim.make_world(seed=3)
    streams = sim.cache_streams(
        "str45s3", lambda: sim.simulate_sequence(world, n_scans=45, seed=3))
    cfg = _cfg({"enable": False})
    JParams.load(cfg)
    jax_result = j_run_streamed(japp.SlamSystem(), streams, sync_every=8)
    JParams.reset()
    lk.reset_counts()
    result = tst.run_streamed(_port(cfg), streams, sync_every=8)
    counts = (lk.K1_PLAIN_CUDA_CALLS, lk.K2_PLAIN_CUDA_CALLS)
    TParams.reset()
    classic = tapp.run_offline(_port(cfg), streams)
    TParams.reset()
    return streams, result, classic, jax_result, counts


def _ate(streams, result):
    return sim.ate_rmse(streams.gt_poses, result.poses, align=False)


def test_port_streamed_matches_classic_quality(lo_runs):
    streams, result, classic, jax_result, counts = lo_runs
    ate, ate_classic = _ate(streams, result), _ate(streams, classic)
    print(f"str45s3 streamed ATE: port {ate:.4f} m, port offline "
          f"{ate_classic:.4f} m, JAX package {_ate(streams, jax_result):.4f} m")
    assert ate < 0.25, ate
    assert ate < max(2.5 * ate_classic, 0.15), (ate, ate_classic)
    assert result.keyframe_count >= classic.keyframe_count - 2
    assert result.converged_frac > 0.9
    assert counts == (0, 0)  # CPU tensors: the plain versions, never "cuda"


def test_port_streamed_tracks_the_jax_trajectory(lo_runs):
    _, result, _, jax_result, _ = lo_runs
    gap = np.linalg.norm(result.poses[:, :3, 3] - jax_result.poses[:, :3, 3],
                         axis=1)
    print(f"max per-scan translation gap {gap.max() * 1e3:.3f} mm")
    assert gap.max() < MAX_GAP_M, gap.max()
    assert result.keyframe_count == jax_result.keyframe_count
    assert result.extras["scan_capacity"] == jax_result.extras["scan_capacity"]
    assert result.extras["n_batches"] == jax_result.extras["n_batches"]


def test_port_streamed_with_backend_worker():
    world = sim.make_world(seed=3)
    streams = sim.cache_streams(
        "str45s3", lambda: sim.simulate_sequence(world, n_scans=45, seed=3))
    system = _port(_cfg({"enable": True}))
    r = tst.run_streamed(system, streams, sync_every=8)
    assert _ate(streams, r) < 0.25
    assert r.keyframe_count > 3
    assert system.backend.n_skipped_noop_solves > 0  # consistent graph


def test_backend_worker_error_surfaces():
    """An exception on the worker thread stops the replay in the main loop."""
    world = sim.make_world(seed=3)
    streams = sim.cache_streams(
        "str30det3", lambda: sim.simulate_sequence(world, n_scans=30, seed=3))
    system = _port(_cfg({"enable": True, "lc": {"enable": False}}))

    def broken(*args, **kwargs):
        raise ValueError("solver failed")

    system.backend.optim_once = broken
    with pytest.raises(RuntimeError, match="backend worker died") as err:
        tst.run_streamed(system, streams, sync_every=8)
    assert isinstance(err.value.__cause__, ValueError)


@pytest.mark.parametrize("jump_cap", [0.0, 1.0], ids=["no_jump_cap",
                                                    "jump_cap"])
def test_velocity_step_cap_bounds_runaway_chain(jump_cap):
    TParams.load({"mode": "lo", "backend": {"enable": False},
                  "frontend": {"pcr": "loam"}, "torch": {"device": "cpu"}})
    reg = make_register()
    far = np.full((64, 3), 500.0, np.float32)
    target = reg.build_target(tpc.from_numpy(far, 128, "cpu"),
                              torch.tensor(far[0]))
    rows = np.full((4, 256, 3), tst.UPLOAD_PAD, np.int16)
    rows[:, :32] = 100  # a few valid points near 0.38 m
    eye = torch.eye(4)
    p_prev = eye.clone()
    p_prev[:3, 3] = torch.tensor([100.0, 0.0, 0.0])  # 100 m disagreement
    (pN, _, _), packed = tst._batch_body(
        torch.from_numpy(rows), target, p_prev, eye, eye, kind="loam",
        clamp=True, degen=0.0, jump_cap=jump_cap)
    final = pN.numpy()[:3, 3]
    assert np.isfinite(final).all() and np.isfinite(packed.numpy()).all()
    assert np.linalg.norm(final) <= 100.0 + 4 * tst.STEP_CAP + 1e-3


def _batch_body_with_host_branches(ds_stack, target, pose_prev, pose_prev2,
                                   clamp, degen, jump_cap):
    """``_batch_body`` as it was formulated before it stopped reading device
    values: Python branches on each scan's converged flag, a stats row made
    from Python numbers."""
    rows = []
    prev, prev2 = pose_prev, pose_prev2
    for raw_q in ds_stack:
        pc = tst.upload_cloud(raw_q)
        step = tgeo.pose_compose(tgeo.pose_inverse(prev2), prev)
        st_t = step[:3, 3]
        scale = torch.clamp(
            tst.STEP_CAP / torch.clamp(torch.linalg.norm(st_t), min=1e-9),
            max=1.0)
        init = tgeo.pose_compose(prev, tgeo.make_pose(step[:3, :3],
                                                      st_t * scale))
        res = tloam.gn_loop_stepwise(pc, target, init, degen_per_row=degen)
        pose, conv = res.pose, bool(res.converged)
        if clamp:
            pose = tgeo.six_dof_to_mobile(pose)
        ok = torch.all(torch.isfinite(pose))
        if jump_cap > 0:
            jump = torch.linalg.norm(pose[:3, 3] - init[:3, 3])
            ok = ok & (jump <= (jump_cap if conv else jump_cap / 3.0))
        pose = torch.where(ok, pose, init)
        conv_t = ok & torch.tensor(conv)
        stats = torch.tensor([int(res.iters), int(res.n_gathers),
                              int(res.n_valid)], dtype=torch.float32)
        rows.append(torch.cat([pose.reshape(16),
                               conv_t.to(torch.float32).reshape(1),
                               torch.zeros(1), stats]))
        prev2, prev = prev, pose
    return (prev, prev2), torch.stack(rows)


@pytest.fixture(scope="module")
def two_scan_batch():
    """A target from the first scan of a seeded sequence and the next two
    scans prepped as the executor preps them; the chain starts 0.2 m off."""
    TParams.load(dict(LO_CFG, backend={"enable": False},
                      torch={"device": "cpu"}))
    reg = make_register()
    world = sim.make_world(seed=3)
    streams = sim.cache_streams(
        "str30det3", lambda: sim.simulate_sequence(world, n_scans=30, seed=3))
    p0 = streams.gt_poses[0]
    sub = streams.scans[0] @ p0[:3, :3].T + p0[:3, 3]
    _, target = reg.build_target_from_raw(
        tpc.from_numpy(sub.astype(np.float32), 16384, "cpu"), 0.5,
        torch.tensor(p0[:3, 3].astype(np.float32)), 16384)
    rows, _ = native.voxel_downsample_sort_quant_batch(
        [np.asarray(streams.scans[i], np.float32) for i in (1, 2)], 0.5, 2048,
        float(reg.TARGET_GRID), tst.UPLOAD_SCALE)
    start = streams.gt_poses[0].astype(np.float32)
    start[:3, 3] += np.array([0.2, -0.1, 0.0], np.float32)
    TParams.reset()
    return target, torch.from_numpy(rows), torch.tensor(start)


@pytest.mark.parametrize("jump_cap", [0.0, 10.0, 0.02],
                         ids=["no_jump_cap", "jump_accepted", "jump_rejected"])
def test_batch_body_rows_equal_host_branch_formulation(two_scan_batch,
                                                       jump_cap):
    target, rows, start = two_scan_batch
    eye = torch.eye(4)
    (pN, pN1, o2m), packed = tst._batch_body(
        rows, target, start, start, eye, kind="loam", clamp=True, degen=0.0,
        jump_cap=jump_cap)
    (qN, qN1), ref = _batch_body_with_host_branches(
        rows, target, start, start, True, 0.0, jump_cap)
    assert packed.shape == (2, 21) and packed.dtype == torch.float32
    assert torch.equal(packed, ref)
    assert torch.equal(pN, qN) and torch.equal(pN1, qN1)
    assert torch.equal(o2m, eye)
    assert packed[0, 18] > 1 and packed[0, 20] > 30   # iterations, support
    moved = torch.linalg.norm(packed[0, :16].view(4, 4)[:3, 3] - start[:3, 3])
    if jump_cap == 0.02:   # the 0.2 m correction is rejected: the prediction
        assert packed[0, 16] == 0 and moved == 0
    else:
        assert packed[0, 16] == 1 and moved > 0.1


@pytest.mark.cuda
def test_batch_body_makes_no_host_sync(two_scan_batch):
    """On the card the batch body runs with sync debugging set to raise: no
    device value is read before the packed rows are."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simpleslam_tpu_torch.ops import voxel as tvox

    target, rows, start = two_scan_batch
    dev = torch.device("cuda")
    vm = tvox.MergedDenseVoxelMap(target.rows.to(dev), target.scale.to(dev),
                                  target.corner.to(dev), target.grid.to(dev),
                                  target.dims, target.slab_pts)
    rows_d, start_d = rows.to(dev), start.to(dev)
    eye = torch.eye(4, device=dev)
    args = (rows_d, vm, start_d, start_d, eye)
    kw = dict(kind="loam", clamp=True, degen=0.0, jump_cap=10.0)
    tst._batch_body(*args, **kw)   # builds the kernels
    lk.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, packed = tst._batch_body(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (lk.K3_LAUNCHES, lk.K3_PLAIN_CUDA_CALLS) == (2, 0)
    _, ref = tst._batch_body(rows, target, start, start, torch.eye(4), **kw)
    got = packed.cpu()
    assert torch.equal(got[:, 16:], ref[:, 16:])
    assert (got[:, :16] - ref[:, :16]).abs().max() < 1e-3


def test_sync_backend_is_deterministic():
    def once():
        cfg = _cfg({"enable": True, "lc": {"enable": False}},
                   tpu={"scan_capacity": 16384, "sync_backend": True})
        world = sim.make_world(seed=3)
        streams = sim.cache_streams(
            "str30det3",
            lambda: sim.simulate_sequence(world, n_scans=30, seed=3))
        r = tst.run_streamed(_port(cfg), streams, sync_every=8)
        TParams.reset()
        return streams, r

    streams, r1 = once()
    _, r2 = once()
    np.testing.assert_array_equal(r1.poses, r2.poses)
    assert _ate(streams, r1) < 0.25
    assert r1.keyframe_count > 3


# ---------------------------------------------------------------------------
# the full chain: backend + loop closure on the courtyard loop
# ---------------------------------------------------------------------------

LC_CFG = {
    "mode": "lo",
    "frontend": {"pcr": "loam"},
    "tpu": {"dense_grid_dims": [128, 128, 32], "sync_backend": True},
    "backend": {
        "enable": True,
        "lc": {"enable": True, "historySubmapRange": 2,
               "fitnessThreshold": 0.3},
        "context": {"used": "scancontext",
                    "scancontext": {"numExcludeRecent": 15,
                                    "numCandidatesFromTree": 5,
                                    "scDistThres": 0.4,
                                    "buildTreeGap": 5,
                                    "searchRatio": 0.1}},
    },
}


@pytest.fixture(scope="module")
def lc_run():
    world = make_courtyard(RADIUS, seed=0)
    streams = sim.cache_streams(
        "lc_courtyard", lambda: sim.simulate_sequence(
            world, n_scans=N_SCANS, seed=2, radius=RADIUS, speed=SPEED,
            n_az=720, n_el=12, scan_noise=0.03))
    JParams.load(LC_CFG)
    jax_result = j_run_streamed(japp.SlamSystem(), streams)
    JParams.reset()
    system = _port(LC_CFG)
    result = tst.run_streamed(system, streams)
    TParams.reset()
    print(f"lc_courtyard ATE: port {_ate(streams, result):.4f} m, JAX "
          f"package {_ate(streams, jax_result):.4f} m; port LC edges "
          f"{system.backend.n_lc_edges}")
    return streams, system, result


def _gt_pose_at(streams, stamp):
    return streams.gt_poses[int(np.argmin(np.abs(streams.scan_stamps - stamp)))]


def test_full_chain_stays_converged(lc_run):
    streams, _, result = lc_run
    assert result.converged_frac > 0.9
    assert _ate(streams, result) < 0.1


def test_full_chain_lc_factor_entered_graph(lc_run):
    _, system, _ = lc_run
    be = system.backend
    assert be.n_lc_edges >= 1
    lc_rows = [n for n, var in enumerate(be.edge_var)
               if np.allclose(var, LC_VAR)]
    assert len(lc_rows) == be.n_lc_edges


def test_full_chain_lc_between_matches_ground_truth(lc_run):
    streams, system, _ = lc_run
    be = system.backend
    kfs = system.map_manager.kf_obj.keyframes
    checked = 0
    for n in range(len(be.edge_i)):
        if not np.allclose(be.edge_var[n], LC_VAR):
            continue
        i, j = be.edge_i[n], be.edge_j[n]
        gt = np.linalg.inv(_gt_pose_at(streams, kfs[i].stamp)) \
            @ _gt_pose_at(streams, kfs[j].stamp)
        err = np.linalg.inv(gt) @ be.edge_T[n]
        r_err = np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1))
        assert np.linalg.norm(err[:3, 3]) < 0.3, n
        assert r_err < np.deg2rad(5.0), (n, np.rad2deg(r_err))
        checked += 1
    assert checked >= 1


def test_full_chain_post_solve_keyframes_consistent(lc_run):
    streams, system, result = lc_run
    kfs = system.map_manager.kf_obj.keyframes
    idx = np.array([int(np.argmin(np.abs(streams.scan_stamps - kf.stamp)))
                    for kf in kfs])
    gt = streams.gt_poses[idx][:, :3, 3]
    post = np.stack([kf.pose for kf in kfs])[:, :3, 3]
    raw = result.poses[idx][:, :3, 3]
    ate_post = float(np.sqrt(np.mean(np.sum((gt - post) ** 2, axis=1))))
    ate_raw = float(np.sqrt(np.mean(np.sum((gt - raw) ** 2, axis=1))))
    assert ate_post <= ate_raw + 0.02, (ate_post, ate_raw)
    assert ate_post < 0.1, ate_post
