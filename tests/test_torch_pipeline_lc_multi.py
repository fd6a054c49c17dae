"""The PyTorch port on the multi-lap loop-closure pipeline of
tests/test_pipeline_lc_multi.py, beside the JAX package: the 400-scan
spiral around the courtyard (cached ``lc_spiral400``), that file's config
with ``tpu.sync_backend``, through ``run_streamed`` at 32-scan batches in
both packages.

The port meets that file's bounds (at least 3 accepted closures, none
dropped, converged share above 0.9, every closure's between within 0.3 m of
the truth, the post-solve keyframes no worse than the raw odometry + 0.02 m
and under 0.3 m) and is held against the JAX run on the same streams: the
same dropped count, accepted closures within ``MAX_LC_DIFF`` of its count,
per-scan poses within ``MAX_GAP_M`` up to the first accepted closure, and
the ATE and post-solve keyframe ATE each within ``MAX_ATE_DIFF_M`` of its
figures (measured on the CPU: 34 against 35 closures, the first at scan
164, 2.39 mm before it, ATE 0.1929 against 0.1932 m, keyframe ATE 0.1907
against 0.1917 m). Marked ``slow`` as that file is: each package takes
over a minute on a CPU.
"""

import numpy as np
import pytest
import torch

from simpleslam_tpu.models.backend import LC_VAR as J_LC_VAR
from simpleslam_tpu.models.mapmanager import MapManager as JMapManager
from simpleslam_tpu.pipeline import app as japp
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu.pipeline.streamed import run_streamed as j_run_streamed
from simpleslam_tpu.utils.config import Params as JParams
from simpleslam_tpu_torch.models.backend import LC_VAR
from simpleslam_tpu_torch.models.mapmanager import MIN_KF_GAP
from simpleslam_tpu_torch.models.mapmanager import MapManager as TMapManager
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.pipeline import streamed as tst
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger
from test_pipeline_lc import RADIUS, _gt_pose_at, make_courtyard
from test_pipeline_lc_multi import _spiral_streams

MAX_LC_DIFF = 3           # accepted closures, against the JAX run's count
MAX_GAP_M = 0.025         # metres, per scan, before the first closure
MAX_ATE_DIFF_M = 0.005    # metres, ATE and keyframe ATE against the JAX run

CFG = {
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
                                    "scDistThres": 0.4, "buildTreeGap": 5,
                                    "searchRatio": 0.1}},
    },
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
    TParams.reset()
    yield
    TParams.reset()
    TLogger.reset()


# each package's keyframe gate over the run: (distance from the gate's
# anchor, admitted, the anchor, the scan's position) per retired scan
GATES = {}


def _recording_gate(mm_class, rec):
    gate = mm_class.select_gate

    def recording(self, pose):
        anchor = np.array(self._select_anchor, np.float64)
        pos = np.array(pose[:3, 3], np.float64)
        admit = gate(self, pose)
        rec.append((float(np.linalg.norm(pos - anchor)), bool(admit),
                    anchor, pos))
        return admit

    return recording


@pytest.fixture(scope="module")
def spiral_runs():
    world = make_courtyard(RADIUS, seed=0)
    streams = sim.cache_streams(
        "lc_spiral400", lambda: _spiral_streams(world, n_scans=400))
    mp = pytest.MonkeyPatch()
    for name, cls in (("port", TMapManager), ("jax", JMapManager)):
        GATES[name] = []
        mp.setattr(cls, "select_gate", _recording_gate(cls, GATES[name]))
    try:
        system = tapp.SlamSystem(dict(CFG, torch={"device": "cpu"}))
        result = tst.run_streamed(system, streams, sync_every=32)
        TParams.reset()
        JParams.load(CFG)
        jsystem = japp.SlamSystem()
        jresult = j_run_streamed(jsystem, streams, sync_every=32)
        JParams.reset()
    finally:
        mp.undo()
    return streams, system, result, jsystem, jresult


def _first_closure_scan(streams, system, lc_var):
    """Index of the scan whose keyframe took the first accepted closure
    (the later keyframe of the first loop-closure edge), or the last scan
    when there is none."""
    be = system.backend
    kfs = system.map_manager.kf_obj.keyframes
    js = [be.edge_j[n] for n in range(len(be.edge_i))
          if np.allclose(be.edge_var[n], lc_var)]
    if not js:
        return len(streams.scan_stamps) - 1
    stamp = min(kfs[j].stamp for j in js)
    return int(np.argmin(np.abs(streams.scan_stamps - stamp)))


def _keyframe_ates(streams, system, result):
    """Keyframe translation RMSE after the pose-graph solve and of the raw
    odometry at the same scans."""
    kfs = system.map_manager.kf_obj.keyframes
    idx = np.array([int(np.argmin(np.abs(streams.scan_stamps - kf.stamp)))
                    for kf in kfs])
    gt = streams.gt_poses[idx][:, :3, 3]
    post = np.stack([kf.pose for kf in kfs])[:, :3, 3]
    raw = result.poses[idx][:, :3, 3]
    ate_post = float(np.sqrt(np.mean(np.sum((gt - post) ** 2, axis=1))))
    ate_raw = float(np.sqrt(np.mean(np.sum((gt - raw) ** 2, axis=1))))
    return ate_post, ate_raw


@pytest.mark.slow
def test_multi_loop_closures_accepted(spiral_runs):
    streams, system, result, jsystem, jresult = spiral_runs
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    ate_j = sim.ate_rmse(streams.gt_poses, jresult.poses, align=False)
    print(f"spiral: ATE port {ate:.4f} m, JAX package {ate_j:.4f} m; "
          f"closures {system.backend.n_lc_edges} / "
          f"{jsystem.backend.n_lc_edges}; dropped "
          f"{system.loop_closure.dropped_closures} / "
          f"{jsystem.loop_closure.dropped_closures}")
    assert system.backend.n_lc_edges >= 3, system.backend.n_lc_edges
    assert system.loop_closure.dropped_closures == 0
    assert result.converged_frac > 0.9
    assert (system.loop_closure.dropped_closures
            == jsystem.loop_closure.dropped_closures)
    assert abs(system.backend.n_lc_edges
               - jsystem.backend.n_lc_edges) <= MAX_LC_DIFF
    assert abs(ate - ate_j) <= MAX_ATE_DIFF_M, (ate, ate_j)


@pytest.mark.slow
def test_multi_loop_tracks_the_jax_run_until_the_first_closure(spiral_runs):
    streams, system, result, jsystem, jresult = spiral_runs
    first = min(_first_closure_scan(streams, system, LC_VAR),
                _first_closure_scan(streams, jsystem, J_LC_VAR))
    gap = np.linalg.norm(result.poses[:first + 1, :3, 3]
                         - jresult.poses[:first + 1, :3, 3], axis=1)
    print(f"spiral: first closure at scan {first}; worst per-scan gap to "
          f"the JAX package before it {gap.max() * 1e3:.3f} mm")
    assert first >= 15, first
    assert gap.max() < MAX_GAP_M, gap.max()


@pytest.mark.slow
def test_multi_loop_betweens_correct(spiral_runs):
    streams, system, _, _, _ = spiral_runs
    be = system.backend
    kfs = system.map_manager.kf_obj.keyframes
    checked = 0
    for n in range(len(be.edge_i)):
        if not np.allclose(be.edge_var[n], LC_VAR):
            continue
        i, j = be.edge_i[n], be.edge_j[n]
        gt_between = np.linalg.inv(_gt_pose_at(streams, kfs[i].stamp)) @ \
            _gt_pose_at(streams, kfs[j].stamp)
        err = np.linalg.inv(gt_between) @ be.edge_T[n]
        assert np.linalg.norm(err[:3, 3]) < 0.3, n
        checked += 1
    assert checked >= 3


@pytest.mark.slow
def test_multi_loop_map_consistent(spiral_runs):
    streams, system, result, jsystem, jresult = spiral_runs
    ate_post, ate_raw = _keyframe_ates(streams, system, result)
    ate_post_j, ate_raw_j = _keyframe_ates(streams, jsystem, jresult)
    print(f"spiral: keyframe ATE after the solve port {ate_post:.4f} m, JAX "
          f"package {ate_post_j:.4f} m; raw {ate_raw:.4f} / {ate_raw_j:.4f} m")
    assert ate_post <= ate_raw + 0.02, (ate_post, ate_raw)
    assert ate_post < 0.3, ate_post
    assert abs(ate_post - ate_post_j) <= MAX_ATE_DIFF_M, (ate_post,
                                                           ate_post_j)


def _closures(system, lc_var):
    be = system.backend
    return {(be.edge_i[n], be.edge_j[n]) for n in range(len(be.edge_i))
            if np.allclose(be.edge_var[n], lc_var)}


@pytest.mark.slow
def test_multi_loop_keyframes_part_at_a_gate_flip(spiral_runs):
    """Where the closure counts part (ROADMAP §3, F8): both packages admit
    the same keyframes and accept the same closures among them until the
    1 m keyframe gate falls on either side at one scan, with each package's
    distance nearer the gate than the two runs' positions of the scan and of
    the gate's anchor lie apart together
    (measured on the CPU: scan 282, keyframe 71, 0.995752 m in the port
    against 1.005978 m, the scan's positions 1.95 mm apart, the gate's
    anchors 8.66 mm). tests/test_torch_lc_replay.py replays
    the later checks from the JAX package's inputs."""
    streams, system, _, jsystem, _ = spiral_runs
    t, j = GATES["port"], GATES["jax"]
    n = len(streams.scan_stamps)
    assert len(t) == len(j) == n - 1
    flip = next(k for k in range(n - 1) if t[k][1] != j[k][1])
    kf = 1 + sum(admit for _, admit, _, _ in t[:flip])
    # the two distances differ by at most what the scan's positions and the
    # gate's anchors differ by
    gap_pos = np.linalg.norm(t[flip][3] - j[flip][3])
    gap_anchor = np.linalg.norm(t[flip][2] - j[flip][2])
    print(f"spiral: keyframe gate flips at scan {flip + 1} (keyframe {kf}): "
          f"{t[flip][0]:.6f} m (port) against {j[flip][0]:.6f} m (JAX "
          f"package); the scan's positions {gap_pos * 1e3:.2f} mm apart, the "
          f"anchors {gap_anchor * 1e3:.2f} mm")
    stamps = [[kf_.stamp for kf_ in s.map_manager.kf_obj.keyframes[:kf]]
              for s in (system, jsystem)]
    assert stamps[0] == stamps[1]
    assert abs(t[flip][0] - MIN_KF_GAP) < gap_pos + gap_anchor
    assert abs(j[flip][0] - MIN_KF_GAP) < gap_pos + gap_anchor
    before = [{e for e in _closures(s, v) if max(e) < kf}
              for s, v in ((system, LC_VAR), (jsystem, J_LC_VAR))]
    assert before[0] == before[1] and len(before[0]) >= 3
