"""The PyTorch port's threaded pipeline: the resident-thread topology
(ingest, LO, map update, backend, loop closure threads) processes a sequence
to the same result quality as the synchronous harness. The two cases of
tests/test_threaded.py on the port, on the same cached sequences, plus lio
mode through the threads (the ingest loop feeds the EKF proxy) and the
drop-oldest policy of live mode.
"""

import numpy as np
import pytest
import torch

from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu_torch.pipeline import app, threaded
from simpleslam_tpu_torch.utils.config import Params
from simpleslam_tpu_torch.utils.logging import Logger


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


def _system(cfg):
    return app.SlamSystem(dict(cfg, torch={"device": "cpu"}))


def _streams(name, n_scans, seed):
    world = sim.make_world(seed=seed)
    return sim.cache_streams(
        name, lambda: sim.simulate_sequence(world, n_scans=n_scans, seed=seed))


def test_threaded_lo_processes_all_scans():
    system = _system({"mode": "lo", "backend": {"enable": False},
                      "dataproxy": {"lidar_size": 4},
                      "tpu": {"scan_capacity": 16384}})
    streams = _streams("thr28s5", 28, 5)
    result = threaded.run_threaded(system, streams)
    # bag mode: blocking backpressure means no scan is dropped
    assert result.extras["n_processed"] == 28
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    assert ate < 0.2, ate
    assert result.keyframe_count >= 4
    assert result.timers.count["odometry"] == 28
    assert result.timers.count["map_update"] >= 1


def test_threaded_with_backend():
    system = _system({"mode": "lo",
                      "backend": {"enable": True, "lc": {"enable": False}},
                      "dataproxy": {"lidar_size": 4},
                      "tpu": {"scan_capacity": 16384, "max_keyframes": 128,
                              "max_edges": 256}})
    streams = _streams("thr30s6", 30, 6)
    result = threaded.run_threaded(system, streams)
    assert result.extras["n_processed"] == 30
    # backend consumed the keyframe events (graph has odometry edges)
    assert len(system.backend.edge_i) >= result.keyframe_count - 1


def test_threaded_lio_feeds_the_ekf_proxy():
    system = _system({"mode": "lio", "backend": {"enable": False},
                      "dataproxy": {"lidar_size": 4},
                      "tpu": {"scan_capacity": 16384}})
    streams = _streams("thr28s5", 28, 5)
    result = threaded.run_threaded(system, streams)
    assert result.extras["n_processed"] == 28
    assert system.frontend.is_init_odom2map()
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    assert ate < 0.3, ate


def test_threaded_live_mode_drops_oldest_not_newest():
    """A paced replay far faster than the LO thread can follow (live mode:
    drop-oldest) still ends with the newest scan processed and stamps in
    order; every processed pose is finite."""
    system = _system({"mode": "lo", "backend": {"enable": False},
                      "dataproxy": {"lidar_size": 2},
                      "tpu": {"scan_capacity": 16384}})
    streams = _streams("thr28s5", 28, 5)
    result = threaded.run_threaded(system, streams, realtime_rate=50.0)
    n = result.extras["n_processed"]
    assert 1 <= n <= 28 and result.extras["n_scans"] == 28
    assert np.all(np.diff(result.stamps) > 0)
    assert result.stamps[-1] == pytest.approx(float(streams.scan_stamps[-1]))
    assert np.isfinite(result.poses).all()
