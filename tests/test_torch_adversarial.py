"""The PyTorch port on the hard worlds of tests/test_adversarial.py, beside
the JAX package.

Registration level: the tilted world, outliers and dropout, the sloped world
and the corridor, each on that file's dense-map fixture (built by the JAX
package from the same seeded scans and handed over as numpy), registered by
both packages' ``scan2map`` from the same start, with the degeneracy guard
off and on. The port must meet the JAX test's own bounds and lie within
1e-4 m and 1e-5 rad of the JAX pose (same candidates, f32 sums in another
order), with the same converged flag, iteration count and n_valid.

With the guard on the GN step is an eigenbasis solve in f32, far less
accurate than the LU solve of the guard-off path: its eigenvectors carry
errors of about eps * lambda_max / (eigenvalue gap), so the two packages'
normal equations, 1.8e-7 apart relative (f32 sums in another order), give
steps up to 2.6e-4 m apart on the tilted fixture, and its second
linearization then gates one row differently (measured on the CPU: 3.6e-4 m
between the packages' poses there, 2.5e-5 m on the sloped world, 8.2e-6 m in
the corridor, where the guard really zeroes the direction along it). Guard-on
poses are held to the JAX package's at 1e-5 rad and at each fixture's own
limit in ``GUARD_TOL`` (5e-4 m and n_valid within 2 rows on the tilted
fixture, 1e-4 m and the same n_valid on the others), and
``test_guarded_step_is_as_accurate_as_the_jax_step`` shows where the gap
comes from: on the first linearization both packages' systems agree and
their float64 eigenbasis steps agree, and the port's f32 step lies no
further from the float64 step than the JAX package's does. The corridor
meets the JAX test's bounds, guard on, on both packages.

Pipeline level: the sloped lo pipeline with the planar clamp off, the
corridor lio pipeline with the guard on and the forest with dynamic
objects, each through ``run_streamed`` in both packages on the same
streams. The port meets the JAX test's bounds, its ATE is printed beside
the JAX package's, and no scan lies more than 25 mm from the JAX package's
pose (the offline allowance of tests/test_torch_pipeline_lo.py: a
convergence test that flips carries a few millimetres, ROADMAP F1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleslam_tpu.ops import loam as jloam
from simpleslam_tpu.ops import pointcloud as jpc
from simpleslam_tpu.ops import voxel as jvox
from simpleslam_tpu.pipeline import app as japp
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu.pipeline.streamed import run_streamed as j_run_streamed
from simpleslam_tpu.utils.config import Params as JParams
from simpleslam_tpu_torch.ops import loam as tloam
from simpleslam_tpu_torch.ops import loam_kernels as lk
from simpleslam_tpu_torch.ops import pointcloud as tpc
from simpleslam_tpu_torch.ops import voxel as tvox
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.pipeline import streamed as tst
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger
from test_adversarial import _sloped_poses, build_dense_fixture, pose_error

POSE_T_TOL = 1e-4         # metres, port against JAX on one registration
POSE_R_TOL = 1e-5         # radians
# guard on, port against JAX: (metres, n_valid rows) for each fixture, set
# from the CPU readings (tilted 3.6e-4 m and 1 row, sloped 2.5e-5 m,
# corridor 8.2e-6 m, outliers 1.6e-6 m, the others 0 rows); only the tilted
# fixture's f32 eigenbasis step needs more than POSE_T_TOL
GUARD_TOL = {"tilted": (5e-4, 2), "outliers": (POSE_T_TOL, 0),
             "sloped": (POSE_T_TOL, 0), "corridor": (POSE_T_TOL, 0)}
MAX_GAP_M = 0.025         # metres, per scan of a pipeline


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


def _rot_angle(Ra, Rb) -> float:
    """Angle of Ra^T Rb from its skew part, in f64 (the arccos of the trace
    of f32 rotations cannot resolve 1e-5 rad)."""
    dR = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    return 0.5 * float(np.linalg.norm([dR[2, 1] - dR[1, 2],
                                       dR[0, 2] - dR[2, 0],
                                       dR[1, 0] - dR[0, 1]]))


# -- registration level ------------------------------------------------------

def _tilted(rng):
    world = sim.make_adversarial_world(seed=5)
    _, poses = sim.make_trajectory(40, 0.1, speed=1.5)
    vm = build_dense_fixture(world, [poses[10], poses[17], poses[24]], rng)
    scan = sim.simulate_scan(world, sim.sensor_from_body(poses[20]), rng=rng)
    return vm, scan, poses[20], [0.2, -0.15, 0.05]


def _outliers(rng):
    world = sim.make_world(seed=4)
    _, poses = sim.make_trajectory(40, 0.1, speed=1.5)
    vm = build_dense_fixture(world, [poses[10], poses[17], poses[24]], rng)
    scan = sim.simulate_scan(world, sim.sensor_from_body(poses[20]), rng=rng,
                             outlier_frac=0.05, dropout_frac=0.10)
    return vm, scan, poses[20], [0.2, -0.15, 0.0]


def _sloped(rng):
    world = sim.make_sloped_world(seed=6, slope_deg=6.0)
    poses = _sloped_poses(world, 40, 6.0)
    vm = build_dense_fixture(world, [poses[10], poses[17], poses[24]], rng)
    scan = sim.simulate_scan(world, sim.sensor_from_body(poses[20]), rng=rng)
    return vm, scan, poses[20].copy(), [0.2, -0.15, 0.1]


def _corridor(rng):
    world = sim.make_corridor_world()
    base = np.eye(4)
    base[0, 3] = 5.0
    map_poses = []
    for dx in (0.0, 2.0, 4.0):
        p = base.copy()
        p[0, 3] += dx
        map_poses.append(p)
    T_b = base.copy()
    T_b[0, 3] = 8.0
    vm = build_dense_fixture(world, map_poses, rng)
    scan = sim.simulate_scan(world, sim.sensor_from_body(T_b), rng=rng)
    return vm, scan, T_b, [0.5, 0.15, 0.08]


def _bounds_full_se3(est, T_b, guess, converged):
    assert converged
    trans, rot = pose_error(est, T_b)
    assert trans < 0.08, trans
    assert rot < 0.015, rot


def _bounds_sloped(est, T_b, guess, converged):
    assert converged
    trans, _ = pose_error(est, T_b)
    assert trans < 0.1, trans
    assert abs(est[2, 3] - T_b[2, 3]) < 0.05


def _bounds_corridor_guarded(est, T_b, guess, converged):
    assert abs(est[1, 3] - T_b[1, 3]) < 0.05, est[1, 3]
    assert abs(est[2, 3] - T_b[2, 3]) < 0.05, est[2, 3]
    assert abs(est[0, 3] - guess[0, 3]) < 0.2, (est[0, 3], guess[0, 3])
    assert np.linalg.norm(est[:3, 3] - T_b[:3, 3]) < 1.0


# fixture, and the bounds of tests/test_adversarial.py for each guard setting
# (None: that file sets none there; the gap to JAX is still held)
FIXTURES = {
    "tilted": (_tilted, _bounds_full_se3, None),
    "outliers": (_outliers, _bounds_full_se3, None),
    "sloped": (_sloped, _bounds_sloped, None),
    "corridor": (_corridor, None, _bounds_corridor_guarded),
}


@pytest.fixture(scope="module")
def registrations():
    """Each fixture registered by both packages, guard off and on: (guess,
    truth, {guard: (JAX pose, JAX result, port result)})."""
    out = {}
    for name, (make, _, _) in FIXTURES.items():
        rng = np.random.default_rng(0)  # the JAX tests' ``rng`` fixture
        vm, scan, T_b, offset = make(rng)
        ds = jpc.compact(jvox.voxel_downsample(
            jpc.from_numpy(scan, 32768), 0.5), 8192)
        guess = T_b.copy()
        guess[:3, 3] += offset
        tvm = tvox.DenseVoxelMap.from_numpy(
            np.asarray(vm.slab), vm.counts, vm.corner, vm.grid, vm.dims,
            vm.slab_pts, "cpu")
        tds = tpc.from_arrays(np.asarray(ds.xyz), np.asarray(ds.intensity),
                              np.asarray(ds.mask), "cpu")
        start = guess.astype(np.float32)
        runs = {}
        for guard, degen in (("off", 0.0), ("on", jloam.DEGEN_EIGEN_PER_ROW)):
            ref = jloam.scan2map(ds, vm, jnp.asarray(start),
                                 degen_per_row=degen)
            out_t = tloam.scan2map(tds, tvm, torch.tensor(start),
                                   degen_per_row=degen)
            runs[guard] = (np.asarray(ref.pose, np.float64), ref, out_t)
        runs["inputs"] = (ds, vm, tds, tvm)
        out[name] = (guess, T_b, runs)
    return out


@pytest.mark.parametrize("guard", ["off", "on"])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_registration_on_hard_fixture_matches_jax(registrations, name, guard):
    guess, T_b, runs = registrations[name]
    p_j, ref, out = runs[guard]
    p_t = out.pose.numpy().astype(np.float64)
    assert np.isfinite(p_t).all()
    bound = FIXTURES[name][1 if guard == "off" else 2]
    if bound is not None:
        bound(p_j, T_b, guess, bool(ref.converged))   # the reference's
        bound(p_t, T_b, guess, bool(out.converged))   # and the port's
    gap_t = float(np.linalg.norm(p_t[:3, 3] - p_j[:3, 3]))
    gap_r = _rot_angle(p_j[:3, :3], p_t[:3, :3])
    print(f"{name}, guard {guard}: port - JAX {gap_t:.3e} m, {gap_r:.3e} rad;"
          f" iterations {int(out.iters)} / {int(ref.iters)}, n_valid "
          f"{int(out.n_valid)} / {int(ref.n_valid)}")
    assert bool(out.converged) == bool(ref.converged)
    assert int(out.iters) == int(ref.iters)
    assert gap_r < POSE_R_TOL, gap_r
    if guard == "on":
        t_tol, rows = GUARD_TOL[name]
        assert abs(int(out.n_valid) - int(ref.n_valid)) <= rows
        assert gap_t < t_tol, gap_t
        return
    assert int(out.n_valid) == int(ref.n_valid)
    assert gap_t < POSE_T_TOL, gap_t


def _guarded_step(A, b, n_valid, eigh):
    """The guard's eigenbasis step, in the precision of ``A``."""
    w, V = eigh(A)
    y = V.T @ (-b)
    floor = jloam.DEGEN_EIGEN_PER_ROW * n_valid
    return V @ np.where(w > floor, y / np.maximum(w, 1e-12), 0.0)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_guarded_step_is_as_accurate_as_the_jax_step(registrations, name):
    """Where the guard-on gap comes from. At the start pose both packages
    build the same system (within 1e-6 relative) whose float64 eigenbasis
    steps agree within 1e-6 m; each package's f32 step lies some way from
    that float64 step (2.4e-4 m on the tilted fixture), the port's no
    further than 1.5 times the JAX package's, give or take 1e-5 m (measured
    0.3-1.1 times where the error is above that)."""
    guess, _, runs = registrations[name]
    ds, vm, tds, tvm = runs["inputs"]
    start = guess.astype(np.float32)
    JtJ_j, JtE_j, nv_j = (np.asarray(x) for x in jloam.build_normal_equations(
        ds, vm, jnp.asarray(start)))
    JtJ_t, JtE_t, nv_t = (x.numpy() for x in tloam.build_normal_equations(
        tds, tvm, torch.tensor(start)))
    assert int(nv_t) == int(nv_j)
    assert np.abs(JtJ_t - JtJ_j).max() <= 1e-6 * np.abs(JtJ_j).max()
    assert np.abs(JtE_t - JtE_j).max() <= 1e-6 * np.abs(JtE_j).max()
    n = float(nv_j)
    f64_j = _guarded_step(JtJ_j.astype(np.float64), JtE_j.astype(np.float64),
                          n, np.linalg.eigh)
    f64_t = _guarded_step(JtJ_t.astype(np.float64), JtE_t.astype(np.float64),
                          n, np.linalg.eigh)
    assert np.linalg.norm(f64_t - f64_j) < 1e-6
    # the JAX package's guard, as its ``gn_loop`` body computes it in f32
    w, V = jnp.linalg.eigh(jnp.asarray(JtJ_j))
    y = V.T @ (-jnp.asarray(JtE_j))
    floor = jnp.float32(jloam.DEGEN_EIGEN_PER_ROW) * jnp.float32(n)
    dx_j = np.asarray(V @ jnp.where(w > floor, y / jnp.maximum(w, 1e-12),
                                    0.0))
    dx_t = tloam._solve(torch.tensor(JtJ_t), torch.tensor(JtE_t),
                        torch.tensor(nv_t), torch.tensor(True),
                        jloam.DEGEN_EIGEN_PER_ROW).numpy()
    err_j = float(np.linalg.norm(dx_j[:3] - f64_j[:3]))
    err_t = float(np.linalg.norm(dx_t[:3] - f64_j[:3]))
    print(f"{name}: first guarded step from the float64 one: port "
          f"{err_t:.3e} m, JAX package {err_j:.3e} m")
    assert err_t <= 1.5 * err_j + 0.1 * POSE_T_TOL, (err_t, err_j)


def test_corridor_guard_keeps_x_at_the_prediction(registrations):
    """The JAX test's control: without the guard the port's x estimate
    wanders further from its prediction than with it."""
    guess, _, runs = registrations["corridor"]
    on = runs["on"][2].pose.numpy()
    off = runs["off"][2].pose.numpy()
    assert abs(off[0, 3] - guess[0, 3]) > abs(on[0, 3] - guess[0, 3])


# -- pipeline level ----------------------------------------------------------

def _sloped_streams():
    rng = np.random.default_rng(0)
    world = sim.make_sloped_world(seed=6, slope_deg=6.0)
    poses = _sloped_poses(world, 30, 6.0)
    scans = [sim.simulate_scan(world, sim.sensor_from_body(poses[i]), rng=rng)
             for i in range(30)]
    return sim.SensorStreams(
        np.arange(30) * 0.1, scans, poses, np.zeros(0), np.zeros((0, 4, 4)),
        np.zeros(0), np.zeros((0, 4)))


GUARDED = {"pcr": "loam", "degeneracy_guard": True}
PIPELINES = {
    "sloped": (lambda: sim.cache_streams("adv_slope30", _sloped_streams),
               {"mode": "lo", "backend": {"enable": False},
                "frontend": {"pcr": "loam", "planar_clamp": False}}),
    "corridor": (lambda: sim.cache_streams(
        "adv_corridor30", lambda: sim.simulate_sequence(
            sim.make_corridor_world(), n_scans=30, speed=1.5, loop=False,
            seed=2)),
        {"mode": "lio", "backend": {"enable": False}, "frontend": GUARDED}),
    "forest": (lambda: sim.cache_streams(
        "adv_forest40d4", lambda: sim.simulate_sequence(
            sim.make_forest_world(seed=3), n_scans=40, seed=2, n_az=600,
            n_el=12, n_dynamic=4)),
        {"mode": "lo", "backend": {"enable": False}, "frontend": GUARDED}),
}


@pytest.fixture(scope="module", params=list(PIPELINES))
def pipeline(request):
    make, cfg = PIPELINES[request.param]
    streams = make()
    JParams.load(cfg)
    jax_result = j_run_streamed(japp.SlamSystem(), streams, sync_every=8)
    JParams.reset()
    lk.reset_counts()
    result = tst.run_streamed(
        tapp.SlamSystem(dict(cfg, torch={"device": "cpu"})), streams,
        sync_every=8)
    assert lk.K3_PLAIN_CUDA_CALLS == 0  # CPU tensors: the plain loop
    TParams.reset()
    return request.param, streams, result, jax_result


def _assert_sloped(streams, result):
    poses = streams.gt_poses
    assert sim.ate_rmse(poses, result.poses, align=False) < 0.1
    z_est, z_gt = result.poses[:, 2, 3], poses[:, 2, 3]
    assert np.ptp(z_gt) > 0.3
    assert np.max(np.abs(z_est - z_gt)) < 0.15


def _assert_corridor(streams, result):
    err = result.poses[:, :3, 3] - streams.gt_poses[:, :3, 3]
    assert np.max(np.abs(err[:, 1])) < 0.1, "lateral corrupted"
    assert np.max(np.abs(err[:, 2])) < 0.1, "vertical corrupted"
    assert np.max(np.abs(err[:, 0])) < 0.5, "along-corridor diverged"
    yaw_err = np.abs(
        np.arctan2(result.poses[:, 1, 0], result.poses[:, 0, 0])
        - np.arctan2(streams.gt_poses[:, 1, 0], streams.gt_poses[:, 0, 0]))
    assert np.max(yaw_err) < 0.03


def _assert_forest(streams, result):
    assert sim.ate_rmse(streams.gt_poses, result.poses, align=False) < 0.15
    assert result.converged_frac > 0.9


PIPELINE_BOUNDS = {"sloped": _assert_sloped, "corridor": _assert_corridor,
                   "forest": _assert_forest}


def test_hard_world_pipeline_meets_the_jax_bounds(pipeline):
    name, streams, result, jax_result = pipeline
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    ate_j = sim.ate_rmse(streams.gt_poses, jax_result.poses, align=False)
    err = np.abs(result.poses[:, :3, 3] - streams.gt_poses[:, :3, 3]).max(0)
    print(f"{name}: ATE port {ate:.4f} m, JAX package {ate_j:.4f} m; port's "
          f"worst |error| x / y / z {err[0]:.4f} / {err[1]:.4f} / "
          f"{err[2]:.4f} m; converged {result.converged_frac:.3f}")
    assert np.isfinite(result.poses).all()
    PIPELINE_BOUNDS[name](streams, jax_result)
    PIPELINE_BOUNDS[name](streams, result)


def test_hard_world_pipeline_tracks_the_jax_trajectory(pipeline):
    name, _, result, jax_result = pipeline
    gap = np.linalg.norm(result.poses[:, :3, 3] - jax_result.poses[:, :3, 3],
                         axis=1)
    print(f"{name}: worst per-scan gap to the JAX package "
          f"{gap.max() * 1e3:.3f} mm at scan {int(gap.argmax())}")
    assert gap.max() < MAX_GAP_M, gap.max()
    assert result.keyframe_count == jax_result.keyframe_count

