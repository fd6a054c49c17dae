"""The PyTorch port's localization mode against a prebuilt global map, beside
the JAX package: the cycle of tests/test_pipeline_full.py and the streamed
localization of tests/test_streamed_loc.py.

- offline: the port maps 60 scans with the backend on and saves its
  artifacts (``tum.txt``, ``{i}.pcd``, ``fg.g2o``), which reload into a new
  system; the keyframes, placed at their saved poses, make one global PCD;
  ``SlamSystem(pcd_file=...)`` then localizes the first 20 scans against it
  with ``run_offline``, and one mid-sequence scan after ``set_reloc_flag``.
- streamed: a global PCD of every 4th ground-truth-posed scan of an 80-scan
  sequence; ``run_streamed`` localizes 24 scans from the start, and 16 from
  scan 50 after a reloc.

Each localization runs in both packages on the same PCD file (written by
the port). The port meets the JAX test's bounds (ATE < 0.15 m, no keyframe;
the reloc'd scan within 0.3 m of the truth) and lies within 5 mm of the
JAX package's pose on every scan, the allowance of
tests/test_torch_streamed.py (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from simpleslam_tpu.pipeline import app as japp
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu.pipeline.streamed import run_streamed as j_run_streamed
from simpleslam_tpu.utils import fileio as jfileio
from simpleslam_tpu.utils.config import Params as JParams
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.pipeline import streamed as tst
from simpleslam_tpu_torch.utils import fileio
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger

MAX_GAP_M = 0.005
LOC_CFG = {"mode": "lo", "saveMapDir": "", "backend": {"enable": False},
           "tpu": {"scan_capacity": 16384}}


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


def _map_cfg(out):
    return {"mode": "lo", "saveMapDir": str(out),
            "backend": {"enable": True, "lc": {"enable": False}},
            "tpu": {"scan_capacity": 16384, "max_keyframes": 256,
                    "max_edges": 512},
            "torch": {"device": "cpu"}}


def _subseq(streams, lo, hi):
    return sim.SensorStreams(
        streams.scan_stamps[lo:hi], streams.scans[lo:hi],
        streams.gt_poses[lo:hi], streams.wheel_stamps[:0],
        streams.wheel_poses[:0], streams.imu_stamps[:0],
        streams.imu_quats[:0])


def _port_loc(pcd):
    return tapp.SlamSystem(dict(LOC_CFG, torch={"device": "cpu"}),
                           pcd_file=pcd)


def _jax_loc(pcd):
    JParams.load(LOC_CFG)
    return japp.SlamSystem(pcd_file=pcd)


def _gap(a, b) -> np.ndarray:
    return np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)


# -- offline: map, save, global PCD, localize --------------------------------

@pytest.fixture(scope="module")
def mapping_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mapdir")
    world = sim.make_world(seed=5)
    streams = sim.cache_streams(
        "full60s5", lambda: sim.simulate_sequence(world, n_scans=60, seed=5))
    system = tapp.SlamSystem(_map_cfg(out))
    result = tapp.run_offline(system, streams)
    system.shutdown()
    TParams.reset()
    # the global map: every saved keyframe at its saved pose (loc.cpp prep)
    stamps, poses = fileio.load_tum(str(out))
    clouds = []
    for i in range(len(stamps)):
        xyz, _ = fileio.load_pcd(str(out / f"{i}.pcd"))
        R, t = poses[i][:3, :3], poses[i][:3, 3]
        clouds.append(xyz @ R.T.astype(np.float32) + t.astype(np.float32))
    pcd = str(out / "global.pcd")
    fileio.save_pcd(pcd, np.concatenate(clouds))
    return out, streams, result, pcd


def test_port_mapping_accuracy_and_artifacts(mapping_run):
    out, streams, result, _ = mapping_run
    assert sim.ate_rmse(streams.gt_poses, result.poses, align=False) < 0.15
    stamps, _ = fileio.load_tum(str(out))
    assert len(stamps) == result.keyframe_count > 0
    assert (out / "0.pcd").is_file() and (out / "fg.g2o").is_file()
    g2o_poses, edges = fileio.load_g2o(str(out / "fg.g2o"))
    assert len(g2o_poses) == result.keyframe_count
    assert len(edges) >= result.keyframe_count - 1
    # the JAX package reads what the port wrote
    j_stamps, j_poses = jfileio.load_tum(str(out))
    np.testing.assert_array_equal(j_stamps, stamps)
    assert len(jfileio.load_g2o(str(out / "fg.g2o"))[0]) == len(g2o_poses)


def test_port_mapping_resume(mapping_run):
    out, _, result, _ = mapping_run
    system = tapp.SlamSystem(_map_cfg(out))  # reloads from saveMapDir
    with system.map_manager.kf_obj.lock:
        assert len(system.map_manager.kf_obj.keyframes) == \
            result.keyframe_count
    assert system.backend is not None and len(system.backend.edge_i) > 0


@pytest.fixture(scope="module")
def offline_loc(mapping_run):
    _, streams, _, pcd = mapping_run
    sub = _subseq(streams, 0, 20)
    system = _port_loc(pcd)
    assert not system.map_manager.is_mapping
    assert not system.map_manager.is_submap_empty()
    res = tapp.run_offline(system, sub)
    TParams.reset()
    jres = japp.run_offline(_jax_loc(pcd), sub)
    JParams.reset()
    return sub, res, jres


def test_offline_localization(offline_loc):
    sub, res, jres = offline_loc
    ate = sim.ate_rmse(sub.gt_poses, res.poses, align=False)
    ate_j = sim.ate_rmse(sub.gt_poses, jres.poses, align=False)
    print(f"offline localization ATE: port {ate:.6f} m, JAX package "
          f"{ate_j:.6f} m")
    assert ate < 0.15, ate
    assert res.keyframe_count == jres.keyframe_count == 0


def test_offline_localization_tracks_jax(offline_loc):
    _, res, jres = offline_loc
    gap = _gap(res.poses, jres.poses)
    print(f"offline localization: worst per-scan gap {gap.max() * 1e3:.4f} mm")
    assert gap.max() < MAX_GAP_M, gap.max()


def test_relocalization_flag(mapping_run):
    """A reloc pose overrides the prediction of a scan fed with a wrong
    history (the reference's RelocDataProxy)."""
    _, streams, _, pcd = mapping_run
    k = 10
    poses = []
    for system in (_port_loc(pcd), _jax_loc(pcd)):
        system.lidar_odometry.set_reloc_flag(streams.gt_poses[k].copy())
        poses.append(system.lidar_odometry.generate_odom(
            float(streams.scan_stamps[k]), streams.scans[k]))
    JParams.reset()
    pose, jpose = poses
    err = np.linalg.norm(pose[:3, 3] - streams.gt_poses[k][:3, 3])
    gap = np.linalg.norm(pose[:3, 3] - jpose[:3, 3])
    print(f"reloc'd scan {k}: {err:.4f} m from the truth, {gap:.3e} m from "
          f"the JAX package")
    assert err < 0.3, err
    assert gap < MAX_GAP_M, gap


# -- streamed ----------------------------------------------------------------

@pytest.fixture(scope="module")
def global_map(tmp_path_factory):
    """A prebuilt global PCD assembled from ground-truth-posed scans."""
    out = tmp_path_factory.mktemp("streamed_loc")
    world = sim.make_world(seed=1)
    streams = sim.cache_streams(
        "loc80s1", lambda: sim.simulate_sequence(world, n_scans=80, seed=1))
    clouds = []
    for i in range(0, 80, 4):
        p = streams.gt_poses[i]
        clouds.append(streams.scans[i] @ p[:3, :3].T.astype(np.float32)
                      + p[:3, 3].astype(np.float32))
    pcd = str(out / "global.pcd")
    fileio.save_pcd(pcd, np.concatenate(clouds))
    return pcd, streams


def _streamed_pair(pcd, sub, reloc=None):
    out = []
    for make, run in ((_port_loc, tst.run_streamed),
                      (_jax_loc, j_run_streamed)):
        system = make(pcd)
        assert not system.map_manager.is_mapping
        assert not system.map_manager.is_submap_empty()
        if reloc is not None:
            system.lidar_odometry.set_reloc_flag(reloc.copy())
        out.append(run(system, sub, sync_every=8))
        TParams.reset()
        JParams.reset()
    return out


@pytest.mark.parametrize("start,n,reloc", [(0, 24, False), (50, 16, True)],
                         ids=["from-start", "reloc-mid-sequence"])
def test_streamed_localization(global_map, start, n, reloc):
    """From the identity start, and from scan 50 (more than 3 m from it,
    where the chain is lost without a reloc) after ``set_reloc_flag``."""
    pcd, streams = global_map
    sub = _subseq(streams, start, start + n)
    if reloc:
        assert np.linalg.norm(streams.gt_poses[start][:3, 3]) > 3.0
    res, jres = _streamed_pair(
        pcd, sub, streams.gt_poses[start] if reloc else None)
    ate = sim.ate_rmse(sub.gt_poses, res.poses, align=False)
    ate_j = sim.ate_rmse(sub.gt_poses, jres.poses, align=False)
    gap = _gap(res.poses, jres.poses)
    print(f"streamed localization {start}-{start + n}: ATE port {ate:.6f} m, "
          f"JAX package {ate_j:.6f} m, worst per-scan gap "
          f"{gap.max() * 1e3:.4f} mm")
    assert ate < 0.15, ate
    assert res.keyframe_count == 0  # localization must not create keyframes
    assert jres.keyframe_count == 0
    assert gap.max() < MAX_GAP_M, gap.max()


def test_streamed_localization_registers_every_scan(global_map,
                                                    monkeypatch):
    """The static target needs no seed scan: every scan of the run is
    registered against the global map, the first one included, and no
    rebuild happens."""
    from simpleslam_tpu_torch.ops import loam

    pcd, streams = global_map
    system = _port_loc(pcd)
    target = system.map_manager.get_target()
    calls = []
    real = loam.gn_loop

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(loam, "gn_loop", counting)
    res = tst.run_streamed(system, _subseq(streams, 0, 8), sync_every=8)
    assert len(calls) == 8
    assert system.map_manager.get_target() is target
    assert system.map_manager.n_device_builds == 0
    assert res.keyframe_count == 0
