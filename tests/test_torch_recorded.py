"""The port's recorded-data path on the CPU: ``app.main --bag`` and
``--kitti`` on a short synthetic sequence that the port itself writes to a
temporary directory, with ``vis.enable`` on; ``run_streamed(device_probe=
True)`` and the ``SIMPLESLAM_DEBUG_SUPPORT`` print.

Bounds: keyframe APE against the ground-truth TUM file under 0.15 m (the
offline bound of tests/test_pipeline_lo.py); the replay from a bag within
1e-3 m per scan of the in-memory replay (bag stamps pass through ROS
sec/nsec and scans through f32, which the in-memory scans already are, so
the measured gap is 0).
"""

import os

import numpy as np
import pytest
import torch

from simpleslam_tpu_torch.eval import evaluate
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.pipeline import bagio
from simpleslam_tpu_torch.pipeline import simulate as sim
from simpleslam_tpu_torch.pipeline import streamed as tst
from simpleslam_tpu_torch.utils import fileio
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger

N_SCANS = 24
LO_CFG = {"mode": "lo", "backend": {"enable": False},
          "tpu": {"scan_capacity": 16384}, "torch": {"device": "cpu"}}


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


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The sequence in memory, as a bag, as a KITTI directory, and its
    ground truth as a TUM file."""
    root = tmp_path_factory.mktemp("recorded")
    world = sim.make_world(seed=5)
    streams = sim.cache_streams(
        "rec24s5", lambda: sim.simulate_sequence(world, n_scans=N_SCANS,
                                                 seed=5))
    bag = str(root / "seq.bag")
    bagio.bag_from_streams(streams, bag)
    vdir = root / "00" / "velodyne"
    os.makedirs(vdir)
    for i, scan in enumerate(streams.scans):
        arr = np.zeros((len(scan), 4), np.float32)
        arr[:, :3] = scan
        arr.tofile(str(vdir / f"{i:06d}.bin"))
    with open(root / "00" / "times.txt", "w") as f:
        for t in streams.scan_stamps:
            f.write(f"{t:.6f}\n")
    gt = str(root / "gt_tum.txt")
    fileio.write_tum(gt, np.asarray(streams.scan_stamps), streams.gt_poses)
    return streams, bag, str(vdir), gt


def _write_cfg(tmp_path, vis_dir):
    import json

    cfg = dict(LO_CFG, vis={"enable": True, "out_dir": str(vis_dir)})
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("source,executor", [
    ("bag", "offline"), ("bag", "streamed"), ("kitti", "offline"),
    ("kitti", "streamed")])
def test_cli_replays_recorded_data_with_vis(tmp_path, recorded, source,
                                            executor):
    """The user path: a recorded sequence through ``app.main``, with the
    visualizer on. The keyframe trajectory it writes is evaluated against
    the ground-truth TUM file by the port's own ``eval``."""
    _, bag, vdir, gt = recorded
    out, vis_dir = tmp_path / "map", tmp_path / "vis"
    argv = ["--config", _write_cfg(tmp_path, vis_dir), "--out", str(out)]
    argv += (["--bag", bag] if source == "bag"
             else ["--kitti", vdir, "--scans", str(N_SCANS)])
    if executor == "streamed":
        argv.append("--streamed")
    assert tapp.main(argv) == 0
    assert os.path.isfile(out / "tum.txt") and os.path.isfile(out / "0.pcd")
    plys = [f for f in os.listdir(vis_dir) if f.endswith(".ply")]
    assert plys and all(f.startswith("aligned_") for f in plys)
    body = (vis_dir / plys[0]).read_bytes().split(b"end_header\n", 1)[1]
    pts = np.frombuffer(body, np.float32).reshape(-1, 3)
    assert len(pts) > 500 and np.isfinite(pts).all()
    stamps, _ = fileio.load_tum(str(out))
    assert len(stamps) >= 3
    ape, _ = evaluate(gt, str(out / "tum.txt"), delta=1, align=False)
    assert ape.n == len(stamps)
    assert ape.rmse < 0.15, ape.row()


def test_vis_is_built_and_closed_by_the_system(tmp_path):
    cfg = dict(LO_CFG, vis={"enable": True, "out_dir": str(tmp_path / "v")})
    system = tapp.SlamSystem(cfg)
    assert system.vis is not None and system.vis.enabled
    assert system.lidar_odometry.vis is system.vis
    system.shutdown()
    assert not system.vis._thread.is_alive()
    TParams.reset()
    assert tapp.SlamSystem(dict(LO_CFG)).vis is None


@pytest.fixture(scope="module")
def in_memory_run(recorded):
    TParams.reset()
    r = tst.run_streamed(tapp.SlamSystem(dict(LO_CFG)), recorded[0],
                         sync_every=8)
    TParams.reset()
    return r


def test_bag_replay_tracks_the_in_memory_replay(recorded, in_memory_run):
    streams, bag, _, _ = recorded
    back = bagio.streams_from_bag(bag, "/lidar_points", "/wheel_odom", "/imu")
    r = tst.run_streamed(tapp.SlamSystem(dict(LO_CFG)), back, sync_every=8)
    gap = np.linalg.norm(r.poses[:, :3, 3] - in_memory_run.poses[:, :3, 3],
                         axis=1)
    print(f"bag replay vs in-memory replay: max gap {gap.max() * 1e3:.4f} mm")
    assert gap.max() < 1e-3, gap.max()
    assert r.keyframe_count == in_memory_run.keyframe_count
    ate = sim.ate_rmse(streams.gt_poses, r.poses, align=False)
    assert ate < 0.25 and r.converged_frac > 0.9


def test_device_probe_books_its_timers_and_keeps_the_poses(recorded,
                                                           in_memory_run):
    r = tst.run_streamed(tapp.SlamSystem(dict(LO_CFG)), recorded[0],
                         sync_every=8, device_probe=True)
    n = r.extras["n_batches"]
    for name in ("device_exec", "fetch_wait", "fetch_xfer", "dispatch"):
        assert r.timers.count[name] == n, (name, dict(r.timers.count))
    assert "fetch" not in r.timers.count
    assert r.timers.total["device_exec"] > 0
    for name in ("device_exec", "fetch_wait", "fetch_xfer"):
        assert name not in in_memory_run.timers.count
    assert in_memory_run.timers.count["fetch"] == n
    np.testing.assert_array_equal(r.poses, in_memory_run.poses)


def test_debug_support_prints_one_line_per_registered_scan(recorded,
                                                           monkeypatch,
                                                           capsys):
    streams = recorded[0]
    short = sim.SensorStreams(
        streams.scan_stamps[:6], streams.scans[:6], streams.gt_poses[:6],
        streams.wheel_stamps[:0], streams.wheel_poses[:0],
        streams.imu_stamps[:0], streams.imu_quats[:0])
    monkeypatch.setenv("SIMPLESLAM_DEBUG_SUPPORT", "1")
    tst.run_streamed(tapp.SlamSystem(dict(LO_CFG)), short, sync_every=4)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("scan ")]
    assert [ln.split()[1] for ln in lines] == ["1", "2", "3", "4", "5"]
    assert all(" sup " in ln and " conv 1 " in ln and " iters " in ln
               and " pos " in ln for ln in lines)
