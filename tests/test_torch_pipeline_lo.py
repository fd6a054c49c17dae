"""The PyTorch port's lo-mode LOAM slice end to end, beside the JAX package.

Both packages replay the same cached ``lo80s5`` sequence with the config of
tests/test_pipeline_lo.py. The port must meet that file's bounds, and its
trajectory must stay close to the JAX package's scan by scan: measured on
the CPU, the largest per-scan translation gap is 12.2 mm (f32 sums in
another order grow into millimetres over 80 chained registrations), and the
assertion allows twice that.
"""

import numpy as np
import pytest

from simpleslam_tpu.pipeline import app as japp
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu.utils import fileio as jfileio
from simpleslam_tpu.utils.config import Params as JParams
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger

CFG = {"mode": "lo", "backend": {"enable": False},
       "tpu": {"scan_capacity": 16384}}
MAX_GAP_M = 0.025


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    TParams.reset()
    yield
    TParams.reset()
    TLogger.reset()


@pytest.fixture(scope="module")
def runs():
    world = sim.make_world(seed=5)
    streams = sim.cache_streams(
        "lo80s5", lambda: sim.simulate_sequence(world, n_scans=80, seed=5))
    JParams.load(CFG)
    jax_result = japp.run_offline(japp.SlamSystem(), streams)
    JParams.reset()
    system = tapp.SlamSystem(dict(CFG, torch={"device": "cpu"}))
    result = tapp.run_offline(system, streams)
    TParams.reset()
    ate_t = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    ate_j = sim.ate_rmse(streams.gt_poses, jax_result.poses, align=False)
    print(f"lo80s5 ATE: port {ate_t:.4f} m, JAX package {ate_j:.4f} m")
    return streams, result, system, jax_result


def test_port_lo_trajectory_accuracy(runs):
    streams, result, _, _ = runs
    assert result.poses.shape == streams.gt_poses.shape
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    assert ate < 0.15, ate
    rpe = sim.rpe_rmse(streams.gt_poses, result.poses, delta=10)
    assert rpe < 0.1, rpe


def test_port_lo_convergence_and_keyframes(runs):
    _, result, system, _ = runs
    assert result.converged_frac > 0.95
    assert 8 <= result.keyframe_count <= 20
    assert not system.map_manager.is_submap_empty()
    for kf in system.map_manager.kf_obj.keyframes:
        assert abs(kf.pose[2, 3]) < 1e-9


def test_port_tracks_the_jax_trajectory(runs):
    _, result, _, jax_result = runs
    gap = np.linalg.norm(result.poses[:, :3, 3] - jax_result.poses[:, :3, 3],
                         axis=1)
    print(f"max per-scan translation gap {gap.max() * 1e3:.2f} mm")
    assert gap.max() < MAX_GAP_M, gap.max()
    assert result.keyframe_count == jax_result.keyframe_count
    assert abs(result.converged_frac - jax_result.converged_frac) < 0.03


def test_port_artifacts_load_with_jax_fileio(tmp_path, runs):
    _, _, system, _ = runs
    mm = system.map_manager
    mm.save_map_dir = str(tmp_path)
    mm.save_trajectory()
    mm.save_kfs()
    kfs = mm.kf_obj.keyframes
    stamps, poses = jfileio.load_tum(str(tmp_path))
    assert len(stamps) == len(kfs)
    np.testing.assert_allclose(stamps, [kf.stamp for kf in kfs], atol=5e-4)
    want = np.stack([kf.pose for kf in kfs])
    # tum.txt keeps 3 decimals of translation and 6 of the quaternion
    np.testing.assert_allclose(poses[:, :3, 3], want[:, :3, 3], atol=5e-4)
    np.testing.assert_allclose(poses[:, :3, :3], want[:, :3, :3], atol=1e-5)
    xyz, _ = jfileio.load_pcd(str(tmp_path / "0.pcd"))
    assert xyz.shape[0] > 100
    np.testing.assert_array_equal(xyz, kfs[0].xyz)
