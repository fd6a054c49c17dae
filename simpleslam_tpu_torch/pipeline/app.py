"""Offline replay harness — the framework's ``app/main.cpp``, in PyTorch.

Port of ``simpleslam_tpu/pipeline/app.py``: the object graph (frontend, map
manager, lidar odometry, the LOAM / NDT / VGICP register, the EKF proxy of
lio mode, pose-graph backend, loop closure) and the deterministic
scan-by-scan replay of a ``SensorStreams`` bundle, with wheel/IMU messages
fed to the EKF proxy in stamp order and map updates and backend passes run
inline at their event points; ``main --streamed`` drives
``pipeline/streamed.py`` instead, and ``pipeline/threaded.py`` holds the
resident-thread form. The input is the synthetic world, a recorded ROS1 bag
(``--bag``) or a KITTI velodyne directory (``--kitti``), both read by
``pipeline/bagio.py``; with ``vis.enable`` the aligned scans go to
``pipeline/vis.py``.

``tpu.mesh_devices = n`` runs on ``n`` ``torch.distributed`` ranks, one
process each: ``main`` starts them itself (``parallel.multihost.run_hosts``)
or, under ``torchrun``, joins the group the environment describes. Every
rank runs the same replay; rank 0 writes the artifacts and the report.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..models.frontend import Frontend
from ..models.lidarodometry import LidarOdometry
from ..models.mapmanager import MapManager
from ..models.registration import make_register
from ..parallel.mesh import check_world, group_is_up, is_writer
from ..utils.config import Params
from ..utils.logging import Logger
from ..utils.profiling import annotate, trace
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


class SlamSystem:
    """Object graph owner (app/main.cpp:103-139 role)."""

    def __init__(self, config: Optional[dict] = None, pcd_file: Optional[str] = None):
        if config is not None:
            Params.load(config)
        cfg = Params.get_instance()
        # a mesh of n > 1 ranks needs its process group up (raises, naming
        # the launchers, when it is not)
        check_world(int(cfg["tpu"].get("mesh_devices", 0)))
        self.cfg = cfg
        self.lg = Logger.get_instance()
        self.mode = cfg["mode"]

        self.vis = None
        if cfg["vis"].get("enable", False) and is_writer():
            from .vis import Vis

            self.vis = Vis(out_dir=cfg["vis"].get("out_dir") or None)

        self.register = make_register()
        self.map_manager = MapManager(self.register, pcd_file=pcd_file)
        self.ekf_proxy = None
        local_deque = None
        if self.mode == "lio":
            from ..models.filter import EkfOdomProxy

            self.ekf_proxy = EkfOdomProxy()
            local_deque = self.ekf_proxy.local_odom
        self.frontend = Frontend(local_deque)
        self.lidar_odometry = LidarOdometry(self.frontend, self.map_manager,
                                            self.register, vis=self.vis)

        self.backend = None
        self.loop_closure = None
        if cfg["backend"].get("enable", True):
            from ..models.backend import Backend

            lcm = None
            if cfg["backend"]["lc"]["enable"]:
                from ..models.loopclosure import LoopClosureManager

                lcm = LoopClosureManager(self.map_manager)
            self.loop_closure = lcm
            self.backend = Backend(self.frontend, self.map_manager, lcm)

    def prewarm(self) -> None:
        """Run the event-driven device work (the pose-graph solves at the
        current bucket sizes, the loop-closure verification chain) once
        before the stream, so its first-call costs never stall it."""
        if self.backend is not None:
            self.backend.prewarm()
        if self.loop_closure is not None:
            self.loop_closure.prewarm()

    def shutdown(self) -> None:
        """Save artifacts (Backend dtor + MapManager semantics)."""
        if self.backend is not None:
            self.backend.save()
        else:
            self.map_manager.save_trajectory()
            self.map_manager.save_kfs()
        if self.vis is not None:
            self.vis.close()


def run_offline(system: SlamSystem, streams: sim.SensorStreams,
                progress: bool = False) -> SlamResult:
    """Deterministic replay of one sequence (bag-mode semantics): sensor
    messages are dispatched in stamp order (wheel/IMU feed the EKF proxy in
    lio mode); each scan runs the full odometry step; a pending map update,
    then a pending backend pass and the loop-closure turn, run right after
    it, as the reference's map and backend threads would."""
    lg = Logger.get_instance()
    timers = StageTimers()
    tt_all = TicToc()
    wheel_i = 0
    imu_i = 0
    est_poses: List[np.ndarray] = []
    n_conv = 0
    scan_stamps = np.asarray(streams.scan_stamps)
    for si, stamp in enumerate(scan_stamps):
        # Feed the lower-rate streams up to the NEXT scan stamp: in the
        # reference the bag loop keeps dispatching while the LO thread works,
        # so the EKF deque always holds entries bracketing the scan being
        # matched (getClosestLocalOdom's lower_bound + retry,
        # Frontend.cpp:25-52). The synchronous analogue is a one-scan ingest
        # lookahead.
        feed_until = (
            scan_stamps[si + 1] if si + 1 < len(scan_stamps)
            else stamp + (scan_stamps[-1] - scan_stamps[0])
            / max(len(scan_stamps) - 1, 1))
        if system.ekf_proxy is not None:
            n_imu, n_wheel = len(streams.imu_stamps), len(streams.wheel_stamps)
            while imu_i < n_imu or wheel_i < n_wheel:
                ti = streams.imu_stamps[imu_i] if imu_i < n_imu else np.inf
                tw = (streams.wheel_stamps[wheel_i] if wheel_i < n_wheel
                      else np.inf)
                if min(ti, tw) > feed_until:
                    break
                if ti <= tw:
                    system.ekf_proxy.imu_handler(ti, streams.imu_quats[imu_i])
                    imu_i += 1
                else:
                    system.ekf_proxy.wheel_handler(
                        tw, streams.wheel_poses[wheel_i])
                    wheel_i += 1

        tt = TicToc()
        with annotate("odometry"):
            pose = system.lidar_odometry.generate_odom(float(stamp),
                                                       streams.scans[si])
        timers.add("odometry", tt.toc())
        est_poses.append(pose)
        if system.register.is_converge or system.map_manager.is_submap_empty():
            n_conv += 1
        if system.map_manager.update_pending():
            tt.tic()
            with annotate("map_update"):
                system.map_manager.update_map()
            timers.add("map_update", tt.toc())
        if (system.backend is not None
                and system.map_manager.kf_obj.is_event_coming()):
            tt.tic()
            system.backend.optim_once()
            timers.add("backend", tt.toc())
            # the LC thread's synchronous turn: detect on the contexts the
            # backend just added, then let the backend consume the LC event
            if system.loop_closure is not None:
                tt.tic()
                if system.loop_closure.lc_handler_once():
                    system.backend.optim_once()
                timers.add("loop_closure", tt.toc())
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


def _rank_main(payload: dict, num_processes: int, process_id: int) -> dict:
    """One rank of a multi-device CLI run (``parallel.multihost``)."""
    return {"rc": main(payload["argv"])}


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: one end-to-end replay (offline, or ``--streamed``) of the
    synthetic world, a recorded bag or a KITTI velodyne directory.

    With ``tpu.mesh_devices = n > 1`` outside a process group, it runs the
    same command on ``n`` ranks it starts (torchrun's environment, when
    present, names the group instead), prints rank 0's output and returns
    rank 0's code."""
    import argparse
    import os
    import sys

    ap = argparse.ArgumentParser(description="simpleslam_tpu_torch offline replay")
    ap.add_argument("--config", default=None, help="params.json path")
    ap.add_argument("--synthetic", action="store_true",
                    help="run the synthetic world (the default input)")
    ap.add_argument("--bag", default=None, metavar="PATH",
                    help="replay a recorded ROS1 bag (the reference's "
                         "primary mode, app/main.cpp:155-207)")
    ap.add_argument("--scan-topic", default="/lidar_points")
    ap.add_argument("--wheel-topic", default="/wheel_odom")
    ap.add_argument("--imu-topic", default="/imu")
    ap.add_argument("--kitti", default=None, metavar="VELODYNE_DIR",
                    help="replay a KITTI-style velodyne .bin sequence")
    ap.add_argument("--scans", type=int, default=120)
    ap.add_argument("--mode", default=None, choices=[None, "lo", "lio"])
    ap.add_argument("--pcr", default=None, choices=[None, "loam", "ndt", "vgicp"])
    ap.add_argument("--streamed", action="store_true",
                    help="use the streamed executor (device-resident pose "
                         "chain, K-scan batches)")
    ap.add_argument("--out", default=None, help="map save dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a torch.profiler trace into DIR/trace.json")
    args = ap.parse_args(argv)

    cfg = Params.load(args.config) if args.config else Params.load()
    if args.mode:
        cfg["mode"] = args.mode
    if args.pcr:
        cfg["frontend"]["pcr"] = args.pcr
    if args.out:
        cfg["saveMapDir"] = args.out
    Params.load(cfg)
    n_ranks = int(cfg["tpu"].get("mesh_devices", 0))
    if n_ranks > 1 and not group_is_up():
        from ..parallel import multihost

        dev_type = "cuda" if str(cfg["torch"]["device"]).startswith("cuda") \
            else "cpu"
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # under torchrun
            multihost.init_from_env(dev_type)
        else:
            argv = list(sys.argv[1:] if argv is None else argv)
            try:
                res = multihost.run_hosts(n_ranks, f"{__name__}:_rank_main",
                                          {"argv": argv}, timeout=1e9,
                                          device=dev_type)
            finally:
                for i, (out, _) in enumerate(multihost.LAST_LOGS[:1]):
                    print(out, end="")
            return int(res[0]["rc"])

    lg = Logger.get_instance()
    if args.bag:
        from . import bagio

        streams = bagio.streams_from_bag(
            args.bag, args.scan_topic, args.wheel_topic, args.imu_topic)
        has_gt = False
    elif args.kitti:
        from . import bagio

        streams = bagio.kitti_streams(args.kitti, max_scans=args.scans)
        has_gt = False
    else:
        world = sim.make_world(seed=args.seed)
        streams = sim.simulate_sequence(world, n_scans=args.scans,
                                        seed=args.seed)
        has_gt = True
    system = SlamSystem()
    system.prewarm()
    with trace(args.trace):
        if args.streamed:
            from .streamed import run_streamed

            result = run_streamed(system, streams, progress=True)
        else:
            result = run_offline(system, streams, progress=True)
    system.shutdown()

    if not is_writer():
        return 0
    ate = rpe = float("nan")  # recorded data carries no inline ground truth
    if has_gt:
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
