"""Offline replay harness — the framework's ``app/main.cpp``, in PyTorch.

Port of ``simpleslam_tpu/pipeline/app.py`` for the lo-mode slice: the object
graph (frontend, map manager, lidar odometry, LOAM register) and the
deterministic scan-by-scan replay of a ``SensorStreams`` bundle, with map
updates run inline at their event points. The pose-graph backend, loop
closure, lio mode and the visualizer are not ported yet: a config that asks
for them is refused, never run as a reduced pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..models.frontend import Frontend
from ..models.lidarodometry import LidarOdometry
from ..models.mapmanager import MapManager
from ..models.registration import make_register
from ..utils.config import Params
from ..utils.logging import Logger
from ..utils.tictoc import StageTimers, TicToc
from . import simulate as sim


@dataclass
class SlamResult:
    stamps: np.ndarray
    poses: np.ndarray                  # estimated body poses per scan
    timers: StageTimers
    wall_time: float
    keyframe_count: int
    converged_frac: float
    extras: dict = field(default_factory=dict)


def _check_ported(cfg: dict) -> None:
    if cfg["mode"] == "lio":
        raise NotImplementedError(
            "mode 'lio' is not ported to simpleslam_tpu_torch yet "
            "(ROADMAP item 9); use mode 'lo'")
    if cfg["backend"].get("enable", True):
        raise NotImplementedError(
            "the pose-graph backend is not ported to simpleslam_tpu_torch yet "
            "(ROADMAP item 7); set backend.enable to false")
    if cfg["vis"].get("enable", False):
        raise NotImplementedError(
            "the visualizer is not ported to simpleslam_tpu_torch yet "
            "(ROADMAP item 11); set vis.enable to false")


class SlamSystem:
    """Object graph owner (app/main.cpp:103-139 role)."""

    def __init__(self, config: Optional[dict] = None, pcd_file: Optional[str] = None):
        if config is not None:
            Params.load(config)
        cfg = Params.get_instance()
        _check_ported(cfg)
        self.cfg = cfg
        self.lg = Logger.get_instance()
        self.mode = cfg["mode"]
        self.register = make_register()
        self.map_manager = MapManager(self.register, pcd_file=pcd_file)
        self.frontend = Frontend()
        self.lidar_odometry = LidarOdometry(self.frontend, self.map_manager,
                                            self.register)

    def shutdown(self) -> None:
        """Save artifacts (MapManager semantics with the backend off)."""
        self.map_manager.save_trajectory()
        self.map_manager.save_kfs()


def run_offline(system: SlamSystem, streams: sim.SensorStreams,
                progress: bool = False) -> SlamResult:
    """Deterministic replay of one sequence (bag-mode semantics): each scan
    runs the full odometry step, and a pending map update runs right after
    it, as the reference's map thread would."""
    lg = Logger.get_instance()
    timers = StageTimers()
    tt_all = TicToc()
    est_poses: List[np.ndarray] = []
    n_conv = 0
    scan_stamps = np.asarray(streams.scan_stamps)
    for si, stamp in enumerate(scan_stamps):
        tt = TicToc()
        pose = system.lidar_odometry.generate_odom(float(stamp),
                                                   streams.scans[si])
        timers.add("odometry", tt.toc())
        est_poses.append(pose)
        if system.register.is_converge or system.map_manager.is_submap_empty():
            n_conv += 1
        if system.map_manager.update_pending():
            tt.tic()
            system.map_manager.update_map()
            timers.add("map_update", tt.toc())
        if progress and si % 50 == 0:
            lg.info("scan %d/%d", si, len(scan_stamps))

    wall = tt_all.elapsed()
    with system.map_manager.kf_obj.lock:
        kfs = system.map_manager.kf_obj.keyframes
        kf_count = len(kfs)
        kf_stamps = np.array([kf.stamp for kf in kfs])
        kf_poses = (np.stack([kf.pose for kf in kfs]) if kfs
                    else np.zeros((0, 4, 4)))
    return SlamResult(
        stamps=scan_stamps,
        poses=np.stack(est_poses) if est_poses else np.zeros((0, 4, 4)),
        timers=timers,
        wall_time=wall,
        keyframe_count=kf_count,
        converged_frac=n_conv / max(len(est_poses), 1),
        extras={"kf_stamps": kf_stamps, "kf_poses": kf_poses},
    )


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: synthetic end-to-end run of the lo-mode LOAM slice."""
    import argparse

    ap = argparse.ArgumentParser(description="simpleslam_tpu_torch offline replay")
    ap.add_argument("--config", default=None, help="params.json path")
    ap.add_argument("--synthetic", action="store_true",
                    help="run the synthetic world (the only input ported yet)")
    ap.add_argument("--scans", type=int, default=120)
    ap.add_argument("--mode", default=None, choices=[None, "lo", "lio"])
    ap.add_argument("--pcr", default=None, choices=[None, "loam", "ndt", "vgicp"])
    ap.add_argument("--out", default=None, help="map save dir")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = Params.load(args.config) if args.config else Params.load()
    if args.mode:
        cfg["mode"] = args.mode
    if args.pcr:
        cfg["frontend"]["pcr"] = args.pcr
    if args.out:
        cfg["saveMapDir"] = args.out
    Params.load(cfg)
    _check_ported(cfg)

    lg = Logger.get_instance()
    world = sim.make_world(seed=args.seed)
    streams = sim.simulate_sequence(world, n_scans=args.scans, seed=args.seed)
    system = SlamSystem()
    result = run_offline(system, streams, progress=True)
    system.shutdown()

    ate = sim.ate_rmse(streams.gt_poses, result.poses)
    rpe = sim.rpe_rmse(streams.gt_poses, result.poses, delta=10)
    seq_dur = streams.scan_stamps[-1] - streams.scan_stamps[0]
    lg.info("finished %d scans in %.2fs (%.1fx realtime) on %s",
            len(streams.scan_stamps), result.wall_time,
            seq_dur / max(result.wall_time, 1e-9), system.register.device)
    lg.info("ATE rmse %.3f m, RPE(1s) rmse %.3f m, %d keyframes, conv %.1f%%",
            ate, rpe, result.keyframe_count, 100 * result.converged_frac)
    print(result.timers.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
