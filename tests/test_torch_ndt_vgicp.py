"""The PyTorch port's NDT and VGICP odometry registers, beside the JAX
package, on tests/test_ndt_vgicp.py's fixture (a three-scan submap, one scan
from a 0.16 m offset guess), the clouds built once with the JAX package and
handed to both.

Tolerances. ``build_target``: counts (so valid masks) identical. The
precisions are inverses of covariances whose small eigenvalues sit at a
hundredth of the largest, computed in f32 from uncentred moments
(E[x x^T] - m m^T at coordinates up to 66 m, so one rounding of a moment is
about 3e-4 m^2), and a summation order shows. The JAX side's order is not
the same in every run: in one whole run of the suite in two its setup
reported XLA programs loaded from the compilation cache and the gaps below
took their second values. So end to end the covariances are held to 2e-3 m^2
(measured 1.1e-4 at worst) and the precisions by their median gap, per voxel
against the largest entry of its matrix: under 1e-4 (measured 2.4e-5, or
4.4e-5); a near-degenerate 4-point voxel may be off by anything (measured
5.3e-3 at worst, or 0.58) and is printed, not bounded.
The port's own arithmetic is held tightly where the inputs are the same:
conditioning and inverting the JAX package's own covariances, the gap's
median is 1e-7 and its largest 2.5e-4 (held to 1e-5 and 1e-3).
``score_terms`` / ``score_only`` on the JAX target carried across with
``target_from_numpy``: H within 2e-5 of max |H|, g within 5e-4 of max |g|
(the bounds the LOAM normal equations are held to), the score within 1e-5
relative, n_matched identical. ``align``: the same converged flag, the
reference test's absolute bounds, and the pose within 2 cm / 2e-3 rad of the
JAX result for NDT (measured 0.02 mm). VGICP stops on a chi2 plateau (a
relative gain under 1e-4) that leaves its pose anywhere within about 2 cm:
the JAX package's own results from starts 2 cm apart differ by 0.3 to 1.9 cm
from the truth. A quarter of the plane-regularized source covariances also
differ between the packages (the smallest eigenvector of a near-degenerate
3x3 in f32 turns on the summation order). So VGICP is held to the JAX pose
within 3 cm / 2e-3 rad end to end (measured 2.2 cm), and within 1 cm when
both loops get the JAX package's source covariances (measured 2.5 mm).
Inside the port, the loop that stops early and the one that runs the full
count agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleslam_tpu.ops import ndt as jndt
from simpleslam_tpu.ops import pointcloud as jpc
from simpleslam_tpu.ops import vgicp as jvgicp
from simpleslam_tpu.ops import voxel as jvox
from simpleslam_tpu.pipeline import app as japp
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu.utils.config import Params as JParams
from simpleslam_tpu_torch.models.registration import make_register, register_kind
from simpleslam_tpu_torch.ops import ndt as tndt
from simpleslam_tpu_torch.ops import pointcloud as tpc
from simpleslam_tpu_torch.ops import vgicp as tvgicp
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger

DIMS = (192, 192, 32)


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


def _to_torch(pc) -> tpc.PointCloud:
    return tpc.from_arrays(np.asarray(pc.xyz), np.asarray(pc.intensity),
                           np.asarray(pc.mask), "cpu")


@pytest.fixture(scope="module")
def fixture():
    rng = np.random.default_rng(2)
    world = sim.make_world(seed=7)
    _, poses = sim.make_trajectory(60, 0.1, speed=1.5)
    map_poses = [poses[20], poses[27], poses[34]]
    clouds = None
    for mp in map_poses:
        scan = sim.simulate_scan(world, sim.sensor_from_body(mp), rng=rng)
        c = jpc.transform(jpc.from_numpy(scan, 32768),
                          jnp.asarray(mp.astype(np.float32)))
        clouds = c if clouds is None else jpc.concat(clouds, c, 98304)
    submap = jpc.compact(jvox.voxel_downsample(clouds, 0.5), 32768)
    origin = map_poses[0][:3, 3].astype(np.float32)
    T_b = poses[30]
    scan_b = sim.simulate_scan(world, sim.sensor_from_body(T_b), rng=rng)
    src = jpc.compact(jvox.voxel_downsample(jpc.from_numpy(scan_b, 32768),
                                            0.5), 8192)
    guess = T_b.copy()
    guess[:3, 3] += [0.12, -0.1, 0.0]
    return {"submap": submap, "origin": origin, "src": src, "T_gt": T_b,
            "guess": guess.astype(np.float32), "t_submap": _to_torch(submap),
            "t_src": _to_torch(src), "t_origin": torch.tensor(origin)}


@pytest.fixture(scope="module")
def ndt_targets(fixture):
    jt = jndt.build_target(fixture["submap"], 1.0,
                           jnp.asarray(fixture["origin"]), dims=DIMS)
    tt = tndt.build_target(fixture["t_submap"], 1.0, fixture["t_origin"],
                           dims=DIMS)
    g = jt.gauss
    carried = tndt.target_from_numpy(
        np.asarray(g.means), np.asarray(g.covs), np.asarray(g.counts),
        np.asarray(g.corner), np.asarray(g.grid), g.dims,
        np.asarray(jt.precisions), "cpu")
    return jt, tt, carried


def pose_error(T_est, T_gt):
    d = np.linalg.inv(np.asarray(T_gt, np.float64)) @ np.asarray(T_est,
                                                                 np.float64)
    return (np.linalg.norm(d[:3, 3]),
            np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))


def test_ndt_build_target(ndt_targets):
    jt, tt, _ = ndt_targets
    counts_j = np.asarray(jt.gauss.counts)
    np.testing.assert_array_equal(tt.gauss.counts.numpy(), counts_j)
    valid = counts_j >= tndt.MIN_VOXEL_POINTS
    assert valid.sum() > 300
    np.testing.assert_allclose(tt.gauss.means.numpy()[valid],
                               np.asarray(jt.gauss.means)[valid], atol=1e-4)
    cov_gap = np.abs(tt.gauss.covs.numpy()
                     - np.asarray(jt.gauss.covs))[valid].max()
    print(f"covariances end to end: largest gap {cov_gap:.2e} m^2")
    assert cov_gap < 2e-3
    pj = np.asarray(jt.precisions)[valid]
    scale = np.abs(pj).max(axis=(1, 2))
    same_covs = tndt._precision_matrices(ndt_targets[2].gauss)
    for name, prec, med_max, worst_max in (
            ("end to end", tt.precisions, 1e-4, None),
            ("on the JAX covariances", same_covs, 1e-5, 1e-3)):
        rel = np.abs(prec.numpy()[valid] - pj).max(axis=(1, 2)) / scale
        print(f"precisions {name}: {int(valid.sum())} valid voxels, gap "
              f"median {np.median(rel):.2e}, largest {rel.max():.2e} of a "
              f"voxel's largest entry")
        assert np.median(rel) < med_max, name
        assert worst_max is None or rel.max() < worst_max, name
    assert tt.precisions.shape == (DIMS[0] * DIMS[1] * DIMS[2] + 1, 3, 3)
    # the sentinel row (count 0, never valid) is what the reference makes it
    np.testing.assert_allclose(tt.precisions[-1].numpy(),
                               np.asarray(jt.precisions)[-1], rtol=1e-5)


def test_condition_covariances_floors_small_eigenvalues():
    """The eigenvalue floor max(lam, max(0.01 lam_max, 1e-9)): a flat
    covariance comes back with its smallest eigenvalue at a hundredth of the
    largest, and a tiny one at the absolute floor."""
    covs = torch.stack([torch.diag(torch.tensor([4.0, 1.0, 1e-6])),
                        torch.diag(torch.tensor([3e-8, 2e-8, 1e-12]))])
    out = tndt.condition_covariances(covs)
    lam = torch.linalg.eigvalsh(out.to(torch.float64))
    np.testing.assert_allclose(lam[0].numpy(), [0.04, 1.0, 4.0], rtol=1e-5)
    np.testing.assert_allclose(lam[1].numpy(), [1e-9, 2e-8, 3e-8], rtol=1e-3)
    want = np.asarray(jndt.condition_covariances(jnp.asarray(covs.numpy())))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-12)


def test_gauss_coefficients_are_the_reference_ones():
    assert tndt._gauss_coeffs(1.0) == jndt._gauss_coeffs(1.0)
    assert all(isinstance(v, float) for v in tndt._gauss_coeffs(1.0))
    assert (tndt.MIN_VOXEL_POINTS, tvgicp.MIN_VOXEL_POINTS) == (4, 3)
    assert tndt.LINE_SEARCH_ALPHAS == jndt.LINE_SEARCH_ALPHAS
    assert (tndt.MAX_ITERS, tndt.CONVERGE_EPS) == (30, 1e-3)


@pytest.mark.parametrize("at", ["guess", "truth"])
def test_ndt_score_terms_on_the_carried_target(fixture, ndt_targets, at):
    jt, _, carried = ndt_targets
    pose = (fixture["guess"] if at == "guess"
            else fixture["T_gt"].astype(np.float32))
    d1, d2 = tndt._gauss_coeffs(1.0)
    Hj, gj, sj, nj = jndt.score_terms(fixture["src"], jt.gauss, jt.precisions,
                                      jnp.asarray(pose), d1, d2)
    Ht, gt, st, nt = tndt.score_terms(fixture["t_src"], carried.gauss,
                                      carried.precisions, torch.tensor(pose),
                                      d1, d2)
    Hj, gj = np.asarray(Hj), np.asarray(gj)
    assert int(nt) == int(nj) > 1000
    assert np.abs(Ht.numpy() - Hj).max() < 2e-5 * np.abs(Hj).max()
    assert np.abs(gt.numpy() - gj).max() < 5e-4 * np.abs(gj).max()
    assert float(st) == pytest.approx(float(sj), rel=1e-5)


def test_ndt_score_only_batched_poses(fixture, ndt_targets):
    """The six line-search candidates in one pass: each score equals the
    JAX package's for that pose, and the single-pose form agrees."""
    jt, _, carried = ndt_targets
    d1, d2 = tndt._gauss_coeffs(1.0)
    poses = np.stack([fixture["guess"]] * 6)
    poses[:, 0, 3] += np.linspace(-0.2, 0.2, 6, dtype=np.float32)
    got = tndt.score_only(fixture["t_src"], carried.gauss, carried.precisions,
                          torch.tensor(poses), d1, d2)
    want = [float(jndt.score_only(fixture["src"], jt.gauss, jt.precisions,
                                  jnp.asarray(p), d1, d2)) for p in poses]
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    one = tndt.score_only(fixture["t_src"], carried.gauss, carried.precisions,
                          torch.tensor(poses[2]), d1, d2)
    assert one.shape == () and float(one) == pytest.approx(want[2], rel=1e-5)
    assert len(set(np.round(want, 3))) > 3     # the poses really differ


def test_line_search_ties_take_the_first_minimum():
    scores = torch.tensor([3.0, 1.0, 2.0, 1.0, 1.0, 5.0])
    assert int(torch.argmin(scores)) == int(jnp.argmin(scores.numpy())) == 1


def _check_align(kind, res, jres, T_gt, trans_max, gap_max=0.02):
    trans, rot = pose_error(res.pose.numpy(), T_gt)
    d_t, d_r = pose_error(res.pose.numpy(), np.asarray(jres.pose))
    print(f"{kind}: {int(res.iters)} iterations (JAX {int(jres.iters)}), "
          f"{trans:.4f} m / {rot:.5f} rad from the truth, {d_t:.5f} m / "
          f"{d_r:.6f} rad from the JAX result")
    for f in res:
        assert isinstance(f, torch.Tensor)
    assert res.converged.shape == res.iters.shape == ()
    assert bool(res.converged) and bool(jres.converged)
    assert trans < trans_max and rot < 0.02, (trans, rot)
    assert d_t < gap_max and d_r < 2e-3, (d_t, d_r)
    assert 0 < int(res.iters) <= 30


def test_ndt_align(fixture, ndt_targets):
    jt, tt, _ = ndt_targets
    jres = jndt.align(fixture["src"], jt, jnp.asarray(fixture["guess"]))
    res = tndt.align(fixture["t_src"], tt, torch.tensor(fixture["guess"]))
    _check_align("ndt", res, jres, fixture["T_gt"], 0.15)
    assert float(res.score) == pytest.approx(float(jres.score), rel=0.02)


@pytest.fixture(scope="module")
def vgicp_targets(fixture):
    jt = jvgicp.build_target(fixture["submap"], 1.0,
                             jnp.asarray(fixture["origin"]), dims=DIMS)
    tt = tvgicp.build_target(fixture["t_submap"], 1.0, fixture["t_origin"],
                             dims=DIMS)
    return jt, tt


def test_vgicp_align(fixture, vgicp_targets):
    jt, tt = vgicp_targets
    jres = jvgicp.align(fixture["src"], jt, jnp.asarray(fixture["guess"]))
    res = tvgicp.align(fixture["t_src"], tt, torch.tensor(fixture["guess"]))
    _check_align("vgicp", res, jres, fixture["T_gt"], 0.12, gap_max=0.03)
    assert float(res.fitness) < 0.15
    assert float(res.fitness) == pytest.approx(float(jres.fitness), abs=1e-2)
    # the loop alone: both packages' loops on the JAX source covariances
    jc, jvd = jvgicp.source_covariances(fixture["src"])
    same = tvgicp._align_impl(
        fixture["t_src"], torch.tensor(np.asarray(jc)),
        torch.tensor(np.asarray(jvd)), tt, torch.tensor(fixture["guess"]),
        tvgicp.MAX_ITERS, tvgicp.CONVERGE_EPS, True)
    _check_align("vgicp on the JAX source covariances", same, jres,
                 fixture["T_gt"], 0.12, gap_max=0.01)


def test_vgicp_fitness_discriminates(fixture, vgicp_targets):
    _, tt = vgicp_targets
    T_gt = fixture["T_gt"].astype(np.float32)
    good = tvgicp.fitness_score(fixture["t_src"], tt.pts, torch.tensor(T_gt))
    bad_pose = T_gt.copy()
    bad_pose[:3, 3] += [2.0, 0.0, 0.0]
    bad = tvgicp.fitness_score(fixture["t_src"], tt.pts,
                               torch.tensor(bad_pose))
    assert float(good) < 0.15
    assert float(bad) > 3 * float(good)


@pytest.mark.parametrize("grad", [1e-6, 1.0], ids=["tiny", "large"])
def test_vgicp_rejected_step_under_epsilon_converges(grad):
    """A damped GN step under epsilon ends the VGICP loop even when it does
    not lower chi2, as LsqRegistration's LM returns converged on a rejected
    delta that is_converged: at the f32 floor every trial can be rejected,
    lambda then only grows, and a loop that needed the step to be taken ran
    out its budget as not converged. A rejected step keeps the pose and the
    carried linearization and raises lambda; one over epsilon goes on."""
    H = torch.eye(6) * 1e3
    g = torch.full((6,), grad)
    cost = torch.tensor(10.0)
    pose = torch.eye(4)

    def lin(p):   # every trial is rejected: chi2 does not drop
        return H, g, cost, torch.tensor(100, dtype=torch.int32)

    state = tvgicp._State(pose, torch.tensor(0, dtype=torch.int32),
                          torch.tensor(False), torch.tensor(1e-6), H, g, cost,
                          torch.tensor(100, dtype=torch.int32))
    nxt = tvgicp._step(lin, tvgicp.LC_MAX_ITERS, tvgicp.LC_CONVERGE_EPS,
                       state)
    assert bool(nxt.conv) == (grad < 1e-3)
    assert int(nxt.iters) == 1 and torch.equal(nxt.pose, pose)
    assert float(nxt.lam) == pytest.approx(8e-6)
    assert torch.equal(nxt.cost, cost) and torch.equal(nxt.H, H)


@pytest.mark.parametrize("kind", ["ndt", "vgicp", "vgicp_lc"])
def test_early_exit_loop_equals_fixed_count_loop(fixture, ndt_targets,
                                                     vgicp_targets, kind):
    """One step, two loops around it: stopping when the state says done and running
    the full count give the same pose, iterations and flag, bit for bit."""
    start = torch.tensor(fixture["guess"])
    if kind == "ndt":
        def run(early):
            return tndt.align(fixture["t_src"], ndt_targets[1], start,
                              early_exit=early)
    else:
        def run(early):
            return tvgicp.align(fixture["t_src"], vgicp_targets[1], start,
                                lc_mode=kind == "vgicp_lc", early_exit=early)
    a, b = run(True), run(False)
    budget = 100 if kind == "vgicp_lc" else 30
    assert 0 < int(a.iters) < budget     # the early-exit loop did stop early
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["ndt", "vgicp"])
def test_register_kind_returns_tensors(fixture, ndt_targets, vgicp_targets,
                                       kind):
    target = ndt_targets[1] if kind == "ndt" else vgicp_targets[1]
    out = register_kind(fixture["t_src"], target,
                        torch.tensor(fixture["guess"]), kind)
    pose, conv, fit, iters, gathers, support = out
    assert all(isinstance(o, torch.Tensor) for o in out)
    assert pose.shape == (4, 4) and conv.dtype == torch.bool
    assert bool(conv) and int(iters) == int(gathers) > 0 and int(support) == 0
    assert (float(fit) > 0) == (kind == "vgicp")


def test_starved_registration_stops_and_reports_not_converged(ndt_targets,
                                                              vgicp_targets):
    """Fewer than 6 matched points: the loop stops after one step and the
    result is not converged (both registers), with the pose finite."""
    far = np.full((64, 3), 400.0, np.float32)
    src = tpc.from_numpy(far, 128, "cpu")
    for mod, target in ((tndt, ndt_targets[1]), (tvgicp, vgicp_targets[1])):
        res = mod.align(src, target, torch.eye(4))
        assert not bool(res.converged)
        assert int(res.iters) == 1
        assert torch.isfinite(res.pose).all()


@pytest.mark.parametrize("pcr", ["ndt", "vgicp"])
def test_pipeline_with_backend_swap(pcr):
    """tests/test_ndt_vgicp.py's short lo-mode run with each register (a
    config swap), through the port; the JAX package's ATE beside it."""
    cfg = {"mode": "lo", "backend": {"enable": False},
           "frontend": {"pcr": pcr}, "tpu": {"scan_capacity": 16384}}
    world = sim.make_world(seed=5)
    streams = sim.cache_streams(
        "nv30s5", lambda: sim.simulate_sequence(world, n_scans=30, seed=5))
    JParams.load(cfg)
    jres = japp.run_offline(japp.SlamSystem(), streams)
    JParams.reset()
    system = tapp.SlamSystem(dict(cfg, torch={"device": "cpu"}))
    assert system.register.KIND == pcr
    result = tapp.run_offline(system, streams)
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    ate_j = sim.ate_rmse(streams.gt_poses, jres.poses, align=False)
    print(f"nv30s5 {pcr} ATE: port {ate:.4f} m, JAX package {ate_j:.4f} m")
    assert ate < 0.3, (pcr, ate)
    assert np.isfinite(result.poses).all()
    if pcr == "vgicp":
        assert np.isfinite(system.register.get_fitness_score())


@pytest.mark.parametrize("pcr", ["ndt", "vgicp"])
def test_streamed_with_backend_swap(pcr):
    """The streamed executor with each register (fixed-count loops inside
    the batch, scans sorted at the register's voxel resolution): the first 8
    scans of ``nv30s5`` in batches of 4, held to the offline bound; the
    batch's iteration counts are those of loops that stopped, not the
    budget."""
    from simpleslam_tpu_torch.pipeline.streamed import run_streamed

    cfg = {"mode": "lo", "backend": {"enable": False},
           "frontend": {"pcr": pcr}, "tpu": {"scan_capacity": 16384}}
    world = sim.make_world(seed=5)
    full = sim.cache_streams(
        "nv30s5", lambda: sim.simulate_sequence(world, n_scans=30, seed=5))
    streams = sim.SensorStreams(
        scan_stamps=full.scan_stamps[:8], scans=full.scans[:8],
        gt_poses=full.gt_poses[:8], wheel_stamps=full.wheel_stamps,
        wheel_poses=full.wheel_poses, imu_stamps=full.imu_stamps,
        imu_quats=full.imu_quats)
    system = tapp.SlamSystem(dict(cfg, torch={"device": "cpu"}))
    result = run_streamed(system, streams, sync_every=4)
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    print(f"nv30s5[:8] streamed {pcr} ATE {ate:.4f} m, iterations per scan "
          f"{result.extras['gn_iters_mean']}")
    assert result.poses.shape == (8, 4, 4) and np.isfinite(result.poses).all()
    assert ate < 0.3, (pcr, ate)
    assert result.converged_frac > 0.85
    assert 0 < result.extras["gn_iters_mean"] < 30
    assert result.extras["n_batches"] == 2


def test_make_register_accepts_all_three():
    for pcr in ("loam", "ndt", "vgicp"):
        TParams.load({"frontend": {"pcr": pcr}, "torch": {"device": "cpu"}})
        assert make_register().KIND == pcr
        TParams.reset()
    TParams.load({"torch": {"device": "cpu"}})
    with pytest.raises(ValueError, match="not exist"):
        make_register("icp")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ndt", "vgicp"])
def test_batch_body_makes_no_host_sync(kind):
    """On the card the NDT and VGICP batch bodies run with sync debugging
    set to raise: no device value is read before the packed rows are."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: sync debugging is a CUDA facility")
    from simpleslam_tpu_torch import native
    from simpleslam_tpu_torch.pipeline import streamed as tst

    dev = torch.device("cuda")
    TParams.load({"mode": "lo", "backend": {"enable": False},
                  "frontend": {"pcr": kind}, "torch": {"device": "cuda"}})
    reg = make_register()
    world = sim.make_world(seed=3)
    streams = sim.simulate_sequence(world, n_scans=3, seed=3)
    p0 = streams.gt_poses[0]
    sub = (streams.scans[0] @ p0[:3, :3].T + p0[:3, 3]).astype(np.float32)
    _, target = reg.build_target_from_raw(
        tpc.from_numpy(sub, 16384, dev), 0.5,
        torch.tensor(p0[:3, 3].astype(np.float32), device=dev), 16384)
    rows, _ = native.voxel_downsample_sort_quant_batch(
        [np.asarray(streams.scans[i], np.float32) for i in (1, 2)], 0.5, 2048,
        float(reg.RESOLUTION), tst.UPLOAD_SCALE)
    start = torch.tensor(p0.astype(np.float32), device=dev)
    args = (torch.from_numpy(rows).to(dev), target, start, start,
            torch.eye(4, device=dev))
    kw = dict(kind=kind, clamp=True, degen=0.0)
    tst._batch_body(*args, **kw)      # first call: constants are uploaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, packed = tst._batch_body(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = packed.cpu()
    assert torch.isfinite(got).all() and got.shape == (2, 21)
