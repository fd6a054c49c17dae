"""The PyTorch port's lo-mode LOAM slice end to end, beside the JAX package.

Both packages replay the same cached ``lo80s5`` sequence with the config of
tests/test_pipeline_lo.py. The port must meet that file's bounds, and its
trajectory must stay close to the JAX package's scan by scan.

Where the two trajectories part, and why (a recorded deviation, not a
computation of the port's own): every registration and every submap rebuild
is recorded in both packages. Given the JAX package's exact inputs, the port
rebuilds the same merged map bit for bit and registers each scan within
1e-5 m of it (f32 sums in another order: 2.3e-6 m at the most, measured on
the CPU). Those rounding gaps pass along the chain through the
constant-velocity prediction; where the GN loop stops at its first
iteration the scan's pose is its prediction, so the gap grows as 2 e(n-1) -
e(n-2) (the first scan over 0.1 mm is scan 27: 0.146 mm). The largest gap
opens where the convergence test, taken before the step is applied (|dx_t|,
|dx_r| <= 5e-3, as the reference), falls the other way: at scan 71 the two
starts are 0.29 mm apart, the loop stops after one iteration from the
port's and takes a second from the JAX package's, and the two poses land
4.79 mm apart (5.53 mm at most, at scan 74). The assertion on the whole
trajectory allows 25 mm.
"""

import hashlib

import numpy as np
import pytest
import torch

from simpleslam_tpu.models import mapmanager as jmm
from simpleslam_tpu.models import registration as jreg
from simpleslam_tpu.pipeline import app as japp
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu.utils import fileio as jfileio
from simpleslam_tpu.utils.config import Params as JParams
from simpleslam_tpu_torch.models import mapmanager as tmm
from simpleslam_tpu_torch.models import registration as treg
from simpleslam_tpu_torch.ops import loam as tloam
from simpleslam_tpu_torch.ops import pointcloud as tpc
from simpleslam_tpu_torch.ops import voxel as tvox
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger

CFG = {"mode": "lo", "backend": {"enable": False},
       "tpu": {"scan_capacity": 16384}}
MAX_GAP_M = 0.025


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


def _record(reg_cls, mm_cls, to_np, rec):
    """Wrap a package's ``odometry_step`` and submap rebuild so a run records
    each registration's inputs and output and each rebuild's inputs and the
    hash of its merged rows. Returns the originals, to put back."""
    step0, rebuild0 = reg_cls.odometry_step, mm_cls._rebuild_submap_from_points

    def step(self, raw, target, pose, grid, cap):
        out = step0(self, raw, target, pose, grid, cap)
        rec["steps"].append(dict(
            init=np.array(pose, np.float64), out=np.array(out[0], np.float64),
            raw=to_np(raw.xyz).copy(), raw_mask=to_np(raw.mask).copy(),
            build=len(rec["builds"]) - 1))
        return out

    def rebuild(self, xyz, anchor):
        rebuild0(self, xyz, anchor)
        rec["builds"].append(dict(
            xyz=np.array(xyz), anchor=np.array(anchor),
            rows=hashlib.sha1(memoryview(np.ascontiguousarray(
                to_np(self._target.rows)))).hexdigest()))

    reg_cls.odometry_step, mm_cls._rebuild_submap_from_points = step, rebuild
    return step0, rebuild0


@pytest.fixture(scope="module")
def runs():
    world = sim.make_world(seed=5)
    streams = sim.cache_streams(
        "lo80s5", lambda: sim.simulate_sequence(world, n_scans=80, seed=5))
    rec_j, rec_t = {"steps": [], "builds": []}, {"steps": [], "builds": []}
    orig_j = _record(jreg.LoamRegister, jmm.MapManager, np.asarray, rec_j)
    orig_t = _record(treg.LoamRegister, tmm.MapManager,
                     lambda t: t.cpu().numpy(), rec_t)
    try:
        JParams.load(CFG)
        jax_result = japp.run_offline(japp.SlamSystem(), streams)
        JParams.reset()
        system = tapp.SlamSystem(dict(CFG, torch={"device": "cpu"}))
        result = tapp.run_offline(system, streams)
        TParams.reset()
    finally:
        (jreg.LoamRegister.odometry_step,
         jmm.MapManager._rebuild_submap_from_points) = orig_j
        (treg.LoamRegister.odometry_step,
         tmm.MapManager._rebuild_submap_from_points) = orig_t
    ate_t = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    ate_j = sim.ate_rmse(streams.gt_poses, jax_result.poses, align=False)
    print(f"lo80s5 ATE: port {ate_t:.4f} m, JAX package {ate_j:.4f} m")
    return streams, result, system, jax_result, rec_j, rec_t


def test_port_lo_trajectory_accuracy(runs):
    streams, result = runs[:2]
    assert result.poses.shape == streams.gt_poses.shape
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    assert ate < 0.15, ate
    rpe = sim.rpe_rmse(streams.gt_poses, result.poses, delta=10)
    assert rpe < 0.1, rpe


def test_port_lo_convergence_and_keyframes(runs):
    result, system = runs[1:3]
    assert result.converged_frac > 0.95
    assert 8 <= result.keyframe_count <= 20
    assert not system.map_manager.is_submap_empty()
    for kf in system.map_manager.kf_obj.keyframes:
        assert abs(kf.pose[2, 3]) < 1e-9


def test_port_tracks_the_jax_trajectory(runs):
    result, jax_result = runs[1], runs[3]
    gap = np.linalg.norm(result.poses[:, :3, 3] - jax_result.poses[:, :3, 3],
                         axis=1)
    print(f"max per-scan translation gap {gap.max() * 1e3:.2f} mm")
    assert gap.max() < MAX_GAP_M, gap.max()
    assert result.keyframe_count == jax_result.keyframe_count
    assert abs(result.converged_frac - jax_result.converged_frac) < 0.03


def test_port_artifacts_load_with_jax_fileio(tmp_path, runs):
    system = runs[2]
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


# ---------------------------------------------------------------------------
# where the offline trajectories part (a recorded deviation)
# ---------------------------------------------------------------------------

def _gap_opening(runs):
    """(registration index, JAX record, port record) of the first scan whose
    registered translations land more than a millimetre apart."""
    rec_j, rec_t = runs[4], runs[5]
    assert len(rec_j["steps"]) == len(rec_t["steps"]) > 0
    gaps = np.array([np.linalg.norm(a["out"][:3, 3] - b["out"][:3, 3])
                     for a, b in zip(rec_j["steps"], rec_t["steps"])])
    assert (gaps > 1e-3).any()
    return int(np.argmax(gaps > 1e-3)), rec_j, rec_t


def _port_target(build):
    """The port's merged map rebuilt from a JAX package's rebuild inputs."""
    cfg = TParams.get_instance()
    reg = treg.make_register("loam")
    cap = int(cfg["tpu"]["submap_capacity"])
    pc = tpc.from_numpy(build["xyz"], cap, "cpu")
    origin = torch.tensor(build["anchor"][:3, 3].astype(np.float32))
    return reg, reg.build_target_from_raw(
        pc, float(cfg["downSampleVoxelGridSize"]), origin, cap)[1]


def _raw(step):
    return tpc.from_arrays(step["raw"], np.zeros(len(step["raw"]), np.float32),
                           step["raw_mask"], "cpu")


def test_port_on_jax_inputs_matches_jax(runs):
    """Given the JAX package's exact inputs, the port computes what it does:
    the submap of the scan where the gap opens rebuilds to the same merged
    rows, bit for bit, and every scan registered against that submap lands
    within 1e-5 m of the JAX package's pose, f32 rounding only."""
    i, rec_j, _ = _gap_opening(runs)
    b = rec_j["steps"][i]["build"]
    TParams.load(dict(CFG, torch={"device": "cpu"}))
    reg, target = _port_target(rec_j["builds"][b])
    rows = hashlib.sha1(memoryview(np.ascontiguousarray(
        target.rows.numpy()))).hexdigest()
    assert rows == rec_j["builds"][b]["rows"]
    cfg = TParams.get_instance()
    cap, grid = (int(cfg["tpu"]["ds_scan_capacity"]),
                 float(cfg["downSampleVoxelGridSize"]))
    steps = [s for s in rec_j["steps"] if s["build"] == b]
    assert len(steps) >= 2
    for s in steps:
        out, _, _ = reg.odometry_step(_raw(s), target, s["init"], grid, cap)
        assert np.abs(out - s["out"]).max() < 1e-5


def test_offline_gap_opens_at_a_convergence_flip(runs):
    """At the first scan whose poses land more than a millimetre apart, the
    two packages start under a millimetre apart, and the port's own GN
    loop, on the same scan and the same submap, stops at another iteration
    from each start (the convergence test is taken before the step is
    applied), so the poses land more than a millimetre apart: the deviation
    recorded in ROADMAP.md."""
    i, rec_j, rec_t = _gap_opening(runs)
    sj, st = rec_j["steps"][i], rec_t["steps"][i]
    start_gap = np.linalg.norm(sj["init"][:3, 3] - st["init"][:3, 3])
    out_gap = np.linalg.norm(sj["out"][:3, 3] - st["out"][:3, 3])
    print(f"gap opens at registration {i + 1}: starts {start_gap * 1e3:.3f}"
          f" mm apart, poses {out_gap * 1e3:.3f} mm apart")
    assert start_gap < 1e-3 < out_gap
    TParams.load(dict(CFG, torch={"device": "cpu"}))
    _, target = _port_target(rec_j["builds"][sj["build"]])
    cfg = TParams.get_instance()
    ds = tpc.compact(tvox.voxel_downsample(
        _raw(sj), float(cfg["downSampleVoxelGridSize"])),
        int(cfg["tpu"]["ds_scan_capacity"]))
    from_j, from_t = (tloam.gn_loop(ds, target, torch.tensor(
        s["init"], dtype=torch.float32)) for s in (sj, st))
    assert bool(from_j.converged) and bool(from_t.converged)
    assert int(from_j.iters) != int(from_t.iters)
    apart = np.linalg.norm(from_j.pose[:3, 3].numpy()
                           - from_t.pose[:3, 3].numpy())
    assert apart > 1e-3
