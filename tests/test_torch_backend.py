"""The PyTorch port's pose-graph backend: the cases of tests/test_backend.py
run on the port, one of them beside the JAX backend, plus the sanity gates,
bucket growth, g2o files exchanged with the JAX package both ways, and the
mapping resume path of tests/test_pipeline_full.py.

Tolerances: the corrected keyframe pose agrees with the JAX backend's
within 1e-4 m (measured 1.6e-6); g2o files print 9 decimals, so poses and
betweens read back within 1e-6.
"""

import numpy as np
import pytest
import torch

from simpleslam_tpu.models.backend import Backend as JBackend
from simpleslam_tpu.models.frontend import Frontend as JFrontend
from simpleslam_tpu.models.mapmanager import KeyFrame as JKeyFrame
from simpleslam_tpu.models.mapmanager import MapManager as JMapManager
from simpleslam_tpu.models.registration import LoamRegister as JLoamRegister
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu.utils import fileio as jfileio
from simpleslam_tpu.utils.config import Params as JParams
from simpleslam_tpu_torch.models.backend import Backend
from simpleslam_tpu_torch.models.frontend import Frontend, Odometry
from simpleslam_tpu_torch.models.mapmanager import KeyFrame, MapManager
from simpleslam_tpu_torch.models.registration import LoamRegister
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.utils import fileio
from simpleslam_tpu_torch.utils.config import Params
from simpleslam_tpu_torch.utils.logging import Logger

SMALL = {
    "saveMapDir": "",
    "tpu": {"max_keyframes": 64, "max_edges": 128,
            "submap_capacity": 8192, "map_voxel_capacity": 4096},
    "backend": {"lc": {"enable": False}},
}


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
    Params.reset()
    yield
    Params.reset()
    Logger.reset()


@pytest.fixture
def small_caps():
    return Params.load(dict(SMALL, torch={"device": "cpu"}))


def _pose(x, y, yaw=0.0):
    T = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[0, 3], T[1, 3] = x, y
    return T


def _mk_system():
    mm = MapManager(LoamRegister())
    fe = Frontend()
    return fe, mm, Backend(fe, mm, None)


def _push_kf(mm, stamp, pose, kf_cls=KeyFrame):
    xyz = np.random.default_rng(0).uniform(-5, 5, (50, 3)).astype(np.float32)
    return mm.put_keyframe(kf_cls(stamp, pose, xyz))


def _corrupt_and_refire(mm, idx=2, pose=None):
    """Corrupt keyframe ``idx`` and re-fire its event: the re-measured odom
    edge disagrees with the older one (a duplicate (i, j) pair)."""
    with mm.kf_obj.lock:
        mm.kf_obj.keyframes[idx].pose = _pose(4.6, 0.4) if pose is None \
            else pose
        mm.kf_obj.kf_nums = idx
    mm.kf_obj.closest_kf_idx.append(idx - 1)
    mm.kf_obj.new_kf_is_coming()


def test_odom_factors_use_nearest_keyframe(small_caps):
    fe, mm, bk = _mk_system()
    _push_kf(mm, 0.0, _pose(0, 0))
    bk.optim_once()
    _push_kf(mm, 1.0, _pose(2, 0))
    _push_kf(mm, 2.0, _pose(4, 0))
    bk.optim_once()
    _push_kf(mm, 3.0, _pose(2.0, 1.5))  # nearest existing kf is 1, not 2
    bk.optim_once()
    assert bk.edge_i[-1] == 1
    assert bk.edge_j[-1] == 3


def test_correction_broadcast_skips_consistent_graph(small_caps):
    fe, mm, bk = _mk_system()
    fe.global_odom.push_back(Odometry(0.0, _pose(0, 0)), block=False)
    fe.odom2map.store(_pose(0, 0))
    _push_kf(mm, 0.0, _pose(0, 0))
    _push_kf(mm, 1.0, _pose(2, 0))
    assert not bk.optim_once()
    np.testing.assert_allclose(bk.last_delta, np.eye(4), atol=1e-6)
    np.testing.assert_allclose(mm.kf_obj.keyframes[1].pose[:3, 3], [2, 0, 0],
                               atol=1e-3)
    np.testing.assert_allclose(fe.odom2map.load(), np.eye(4), atol=1e-3)


def test_solver_corrects_inconsistent_estimates_like_jax(small_caps):
    """Odometry factors measured before a drift injection pull the pose
    back, to the same place as the JAX backend's solve."""
    fe, mm, bk = _mk_system()
    JParams.load(SMALL)
    jmm = JMapManager(JLoamRegister())
    jbk = JBackend(JFrontend(), jmm, None)
    for m in (mm, jmm):
        kf = KeyFrame if m is mm else JKeyFrame
        _push_kf(m, 0.0, _pose(0, 0), kf)
        _push_kf(m, 1.0, _pose(2, 0), kf)
        _push_kf(m, 2.0, _pose(4, 0), kf)
    bk.optim_once()
    jbk.optim_once()
    for m in (mm, jmm):
        _corrupt_and_refire(m)
    bk.optim_once()
    jbk.optim_once()
    p2 = mm.kf_obj.keyframes[2].pose[:3, 3]
    assert abs(p2[0] - 4.0) < 0.5 and abs(p2[1]) < 0.4
    np.testing.assert_allclose(p2, jmm.kf_obj.keyframes[2].pose[:3, 3],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(bk.last_delta, jbk.last_delta, rtol=0,
                               atol=1e-4)


def test_noop_solve_skip_and_stress_triggers(small_caps):
    fe, mm, bk = _mk_system()
    _push_kf(mm, 0.0, _pose(0, 0))
    _push_kf(mm, 1.0, _pose(2, 0))
    assert not bk.optim_once()
    assert bk.n_skipped_noop_solves == 1
    _push_kf(mm, 2.0, _pose(4, 0))
    mm.kf_obj.new_kf_is_coming()
    bk.optim_once()
    assert bk.n_skipped_noop_solves == 2
    _corrupt_and_refire(mm)
    bk.optim_once()
    assert bk._graph_stressed
    assert bk.n_skipped_noop_solves == 2  # this event actually solved
    assert abs(mm.kf_obj.keyframes[2].pose[0, 3] - 4.0) < 0.5


def test_sanity_gate_discards_blown_up_solve(small_caps, monkeypatch):
    fe, mm, bk = _mk_system()
    for k in range(3):
        _push_kf(mm, float(k), _pose(2.0 * k, 0))
    bk.optim_once()
    _corrupt_and_refire(mm)
    bad = [np.full((4, 4), np.nan)] * 3
    monkeypatch.setattr(bk, "_solve", lambda *a, **k: bad)
    assert not bk.optim_once()
    assert bk.n_discarded_solves == 1
    assert np.isfinite(mm.kf_obj.keyframes[2].pose).all()  # not written


def test_buckets_grow_x4_and_keep_solving(monkeypatch):
    Params.load(dict(SMALL, torch={"device": "cpu"},
                     tpu=dict(SMALL["tpu"], kf_bucket=2, edge_bucket=2)))
    fe, mm, bk = _mk_system()
    for k in range(6):
        _push_kf(mm, float(k), _pose(2.0 * k, 0))
    bk.optim_once()
    _corrupt_and_refire(mm, idx=5, pose=_pose(10.6, 0.4))
    bk.optim_once()
    assert bk._k_bucket == 8 and bk._e_bucket == 8  # 2 -> 8 on both
    assert bk.n_bucket_growths == 2
    assert bk._g.poses.shape[0] == 8 and bk._g.edge_i.shape[0] == 8
    assert abs(mm.kf_obj.keyframes[5].pose[0, 3] - 10.0) < 0.5


def test_prewarm_leaves_graph_state(small_caps):
    fe, mm, bk = _mk_system()
    bk.prewarm()
    assert bk._g is None
    _push_kf(mm, 0.0, _pose(0, 0))
    _push_kf(mm, 1.0, _pose(2, 0))
    assert not bk.optim_once()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_g2o_files_load_in_both_packages(tmp_path, writer):
    poses = np.stack([_pose(0, 0), _pose(2, 0, 0.3), _pose(4, 1, 0.6)])
    edges = [(0, 1, np.linalg.inv(poses[0]) @ poses[1],
              np.diag(1.0 / np.array([0.1] * 3 + [1e-4] * 3))),
             (1, 2, np.linalg.inv(poses[1]) @ poses[2],
              np.diag(np.full(6, 10.0)))]
    path = str(tmp_path / "fg.g2o")
    (fileio if writer == "port" else jfileio).write_g2o(path, poses, edges)
    for load in (fileio.load_g2o, jfileio.load_g2o):
        got_p, got_e = load(path)
        np.testing.assert_allclose(got_p, poses, rtol=0, atol=1e-6)
        assert len(got_e) == 2
        for (i, j, T, info), (i0, j0, T0, info0) in zip(got_e, edges):
            assert (i, j) == (i0, j0)
            np.testing.assert_allclose(T, T0, rtol=0, atol=1e-6)
            np.testing.assert_allclose(info, info0, rtol=0, atol=1e-6)


def test_g2o_save_reload_marks_graph_stressed(tmp_path):
    Params.load(dict(SMALL, saveMapDir=str(tmp_path),
                     torch={"device": "cpu"}))
    fe, mm, bk = _mk_system()
    _push_kf(mm, 0.0, _pose(0, 0))
    _push_kf(mm, 1.0, _pose(2, 0, 0.3))
    _push_kf(mm, 2.0, _pose(4, 1, 0.6))
    bk.optim_once()
    bk.save()
    assert (tmp_path / "fg.g2o").is_file() and (tmp_path / "tum.txt").is_file()
    fe2, mm2, bk2 = _mk_system()
    assert len(mm2.kf_obj.keyframes) == 3
    assert len(bk2.edge_i) == len(bk.edge_i)
    assert bk2.prior_pose is not None
    assert bk2._graph_stressed
    np.testing.assert_allclose(mm2.kf_obj.keyframes[2].pose[:3, 3],
                               mm.kf_obj.keyframes[2].pose[:3, 3], atol=1e-6)


def _map_cfg(out):
    return {"mode": "lo", "saveMapDir": str(out), "torch": {"device": "cpu"},
            "backend": {"enable": True, "lc": {"enable": False}},
            "tpu": {"scan_capacity": 16384, "max_keyframes": 256,
                    "max_edges": 512}}


def test_mapping_resume(tmp_path):
    """The port maps with its backend on (tests/test_pipeline_full.py's
    config, first 30 scans of its sequence), saves, and a fresh system
    reloads the keyframes and the factor graph."""
    world = sim.make_world(seed=5)
    streams = sim.cache_streams(
        "full60s5", lambda: sim.simulate_sequence(world, n_scans=60, seed=5))
    sub = sim.SensorStreams(
        streams.scan_stamps[:30], streams.scans[:30], streams.gt_poses[:30],
        streams.wheel_stamps[:0], streams.wheel_poses[:0],
        streams.imu_stamps[:0], streams.imu_quats[:0])
    system = tapp.SlamSystem(_map_cfg(tmp_path))
    result = tapp.run_offline(system, sub)
    system.shutdown()
    assert sim.ate_rmse(sub.gt_poses, result.poses, align=False) < 0.15
    g2o_poses, edges = jfileio.load_g2o(str(tmp_path / "fg.g2o"))
    assert len(g2o_poses) == result.keyframe_count > 1
    assert len(edges) >= result.keyframe_count - 1

    system2 = tapp.SlamSystem(_map_cfg(tmp_path))
    with system2.map_manager.kf_obj.lock:
        assert len(system2.map_manager.kf_obj.keyframes) == \
            result.keyframe_count
    assert system2.backend is not None
    assert len(system2.backend.edge_i) > 0
