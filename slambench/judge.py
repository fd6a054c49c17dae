"""The comparison that decides ``correct``: the numbers a run's outputs give
against the plain reference (``reference.py``) and the drive's ground
truth. It reads the program's outputs (poses, keyframes, the factor graph
it saves) only to judge them.

Numbers, each the worst over what it covers:

- ``prep_gap_m``, ``prep_count_gap``: scan preparation. For a sample of
  keyframes, the distance from each point of the program's keyframe cloud
  to the reference's own downsampling of that raw scan, and the difference
  of their counts (the program keeps at most the scan capacity);
- ``pose_gap_m``, ``pose_gap_rad``, ``pose_resid_m``: registration and
  the map. For a sample of scans, the reference builds the submap from its
  own keyframe clouds at the program's keyframe poses (keyframes admitted
  before the scan), runs LOAM from the program's pose to convergence and
  reads how far it moves, and how much that move changes the scan's
  point-to-plane residuals (``reference.residual_gap``);
- ``ate_m``: each drive's trajectory against the ground truth (unaligned
  RMSE of positions);
- ``graph_gap_m`` (backend on): the reference solves each drive's factor
  graph from the program's keyframe poses and reads how far they move;
- ``closures`` (backend on): the most loop closures a drive accepted. A
  cell whose drive never revisits a place holds it at 0: every closure
  there is false. The reference accepts none.

The samples are drawn from the seed. ``control=True`` also judges the
control: the reference in bfloat16 put in the program's place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
from scipy.spatial import cKDTree

from . import reference as ref

N_PREP = 6      # keyframes whose clouds are compared, per run
N_POSE = 24     # scans re-registered, per run


@dataclass
class DriveOut:
    """What one drive returned, as host arrays."""

    poses: np.ndarray                   # (S, 4, 4)
    kf_scan: np.ndarray                 # (K,) scan index of each keyframe
    kf_poses: np.ndarray                # (K, 4, 4)
    kf_clouds: List[np.ndarray]         # the program's keyframe clouds
    scan_capacity: int
    graph: Optional[dict] = None        # prior, edges and information
    extras: dict = field(default_factory=dict)


def _ate(poses: np.ndarray, gt: np.ndarray) -> float:
    d = poses[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def _cloud_gap(got: np.ndarray, want: np.ndarray) -> float:
    if len(got) == 0:
        return 0.0
    if len(want) == 0:
        return math.inf
    d, _ = cKDTree(want).query(np.asarray(got, np.float64))
    return float(np.max(d))


class Judge:
    def __init__(self, drive, grid: float, window: int, seed: int):
        self.drive = drive
        self.grid = grid
        self.window = window
        self.seed = seed
        self._ds: Dict[tuple, np.ndarray] = {}

    def ds(self, i: int, prec: ref.Prec) -> np.ndarray:
        key = (i, prec.name)
        if key not in self._ds:
            self._ds[key] = ref.downsample(self.drive.scans[i], self.grid, prec)
        return self._ds[key]

    def samples(self, outs: List[DriveOut]):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 4]))
        n = len(self.drive.scan_stamps)
        prep = []
        for _ in range(N_PREP):
            d = int(rng.integers(len(outs)))
            if len(outs[d].kf_scan):
                prep.append((d, int(rng.integers(len(outs[d].kf_scan)))))
        pose = [(int(rng.integers(len(outs))), int(rng.integers(1, n)))
                for _ in range(N_POSE)] if n > 1 else []
        return prep, pose

    def _map_for(self, out: DriveOut, i: int, pose: np.ndarray,
                 prec: ref.Prec) -> np.ndarray:
        before = np.where(out.kf_scan < i)[0]
        return ref.submap(pose, out.kf_poses[before],
                          [self.ds(int(out.kf_scan[k]), prec) for k in before],
                          self.window, self.grid, prec)

    def _pose_gap(self, out: DriveOut, i: int, judged: np.ndarray):
        """(translation gap m, rotation gap rad, residual gap m) between a
        judged pose and the reference's alignment of the scan from it."""
        f64 = ref.Prec()
        mp = self._map_for(out, i, judged, f64)
        got = ref.register(self.ds(i, f64), mp, judged, f64, info=True)
        if got is None:
            return math.inf, math.inf, math.inf
        r, H, n = got
        return (float(np.linalg.norm(r[:3, 3] - judged[:3, 3])),
                ref.rot_angle(r[:3, :3], judged[:3, :3]),
                ref.residual_gap(judged, r, H, n))

    def numbers(self, outs: List[DriveOut]) -> Dict[str, float]:
        f64 = ref.Prec()
        prep, pose = self.samples(outs)
        num: Dict[str, float] = {}
        gaps, counts = [0.0], [0.0]
        for d, k in prep:
            o = outs[d]
            want = self.ds(int(o.kf_scan[k]), f64)
            got = o.kf_clouds[k]
            gaps.append(_cloud_gap(got, want))
            counts.append(abs(len(got) - min(len(want), o.scan_capacity)))
        num["prep_gap_m"] = max(gaps)
        num["prep_count_gap"] = float(max(counts))
        pg = [(0.0, 0.0, 0.0)] + [
            self._pose_gap(outs[d], i, outs[d].poses[i]) for d, i in pose]
        num["pose_gap_m"] = max(g[0] for g in pg)
        num["pose_gap_rad"] = max(g[1] for g in pg)
        num["pose_resid_m"] = max(g[2] for g in pg)
        num["ate_m"] = max(_ate(o.poses, self.drive.gt_poses) for o in outs)
        if any(o.graph is not None for o in outs):
            num["graph_gap_m"] = max(self._graph_gap(o.graph, o.kf_poses)
                                     for o in outs if o.graph is not None)
            num["closures"] = float(max(o.extras.get("closures", 0)
                                        for o in outs))
        return num

    def _graph_gap(self, g: dict, judged: np.ndarray) -> float:
        if len(judged) < 2 or len(g["ei"]) == 0:
            return 0.0
        opt = ref.solve_graph(judged, g["prior_pose"], g["prior_info"],
                              g["ei"], g["ej"], g["eT"], g["einfo"])
        return float(np.max(np.linalg.norm(opt[:, :3, 3] - judged[:, :3, 3],
                                           axis=1)))

    def control_numbers(self, outs: List[DriveOut]) -> Dict[str, float]:
        """The same numbers for the control: the reference in bfloat16 in
        the program's place (its clouds, its poses from the program's
        starts, its graph solve), judged as the program is."""
        low, f64 = ref.Prec("bfloat16"), ref.Prec()
        prep, pose = self.samples(outs)
        num: Dict[str, float] = {}
        gaps, counts = [0.0], [0.0]
        for d, k in prep:
            o = outs[d]
            i = int(o.kf_scan[k])
            want, got = self.ds(i, f64), self.ds(i, low)
            gaps.append(_cloud_gap(got, want))
            counts.append(abs(len(got) - min(len(want), o.scan_capacity)))
        num["prep_gap_m"] = max(gaps)
        num["prep_count_gap"] = float(max(counts))
        pg, pos, gts = [(0.0, 0.0, 0.0)], [], []
        for d, i in pose:
            o = outs[d]
            start = o.poses[i]
            c = ref.register(self.ds(i, low), self._map_for(o, i, start, low),
                             start, low)
            if c is None:
                pg.append((math.inf, math.inf, math.inf))
                continue
            pg.append(self._pose_gap(o, i, c))
            pos.append(c[:3, 3])
            gts.append(self.drive.gt_poses[i, :3, 3])
        num["pose_gap_m"] = max(g[0] for g in pg)
        num["pose_gap_rad"] = max(g[1] for g in pg)
        num["pose_resid_m"] = max(g[2] for g in pg)
        num["ate_m"] = (float(np.sqrt(np.mean(np.sum(
            (np.array(pos) - np.array(gts)) ** 2, axis=1)))) if pos
            else math.inf)
        if any(o.graph is not None for o in outs):
            vals = []
            for o in outs:
                g = o.graph
                if g is None or len(o.kf_poses) < 2 or len(g["ei"]) == 0:
                    continue
                c = ref.solve_graph(o.kf_poses, g["prior_pose"],
                                    g["prior_info"], g["ei"], g["ej"], g["eT"],
                                    g["einfo"], low)
                vals.append(self._graph_gap(g, c))
            num["graph_gap_m"] = max(vals) if vals else 0.0
            num["closures"] = 0.0
        return num
