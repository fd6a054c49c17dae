"""Per-scan odometry pipeline (reference LidarOdometry).

Parity with ``frontend/src/LidarOdometry.cpp:89-246`` (call stack SURVEY.md
§3.2): pose prediction (reloc > odom2map * local_odom > last global odom),
scan voxel downsample, scan2map through the configured PCR backend, planar
clamp (SixDof2Mobile), keyframe selection (> 1 m gap), GlobalOdom push and
odom2map update.

Port of ``simpleslam_tpu/models/lidarodometry.py``. The host-side pose
chain stays f64 numpy; the scan is padded onto the register's device, where
downsample, registration and planar clamp run in f32, and the refined pose
comes back in one host read.
"""

from __future__ import annotations

import threading

import numpy as np

from ..ops import pointcloud as pcops
from ..utils.config import Params
from ..utils.logging import Logger
from .frontend import Frontend, Odometry
from .mapmanager import KeyFrame, MapManager
from .registration import make_register


def _fractional_pose(step: np.ndarray, s: float) -> np.ndarray:
    """``step ** s`` for small rigid steps: scaled translation + scaled
    axis-angle (exact enough for inter-scan motion prediction)."""
    if abs(s - 1.0) < 1e-9:
        return step
    out = np.eye(4)
    out[:3, 3] = step[:3, 3] * s
    R = step[:3, :3]
    cos_a = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    ang = np.arccos(cos_a)
    if ang > np.pi - 1e-6:
        # near-pi rotation: the axis extraction divides by 2*sin(ang) ~ 0 and
        # would produce NaNs; fall back to the unscaled step (the reference's
        # raw-last-pose behavior, LidarOdometry.cpp:137-153)
        return step
    if ang > 1e-8:
        axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) / (2 * np.sin(ang))
        a = ang * s
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        out[:3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)
    return out


class LidarOdometry:
    def __init__(self, frontend: Frontend, map_manager: MapManager,
                 register=None, vis=None):
        cfg = Params.get_instance()
        self.lg = Logger.get_instance()
        self.frontend = frontend
        self.map_manager = map_manager
        self.grid_size = float(cfg["downSampleVoxelGridSize"])
        self.ds_capacity = int(cfg["tpu"]["ds_scan_capacity"])
        self.scan_capacity = int(cfg["tpu"]["scan_capacity"])
        self.register = register if register is not None else make_register()
        self.vis = vis
        self._vis_topic = cfg["vis"]["align"].strip("/")

        self.reloc = False
        self.reloc_pose = np.eye(4)
        self._reloc_lock = threading.Lock()
        self._velocity_model = bool(
            cfg["frontend"].get("velocity_model", True))

    # rviz /initialpose hook (RelocDataProxy -> setRelocFlag, LidarOdometry.cpp:67-77)
    def set_reloc_flag(self, pose: np.ndarray) -> None:
        with self._reloc_lock:
            self.reloc_pose = pose.copy()
            self.reloc = True

    def generate_odom(self, stamp: float, scan_xyz: np.ndarray) -> np.ndarray:
        """Process one scan; returns the refined body pose (4, 4 float64)."""
        fe = self.frontend
        mm = self.map_manager

        # ---- initial pose (LidarOdometry.cpp:121-153) -----------------------
        with self._reloc_lock:
            init_pose = self.reloc_pose.copy()
            reloc = self.reloc
            self.reloc = False
        local_odom = fe.get_closest_local_odom(stamp, retries=1)
        if reloc:
            self.lg.info("reloc-ing...")
            fe.global_odom.clear()
        elif local_odom is not None and fe.is_init_odom2map():
            init_pose = fe.odom2map.load() @ local_odom.odom
        else:
            items = fe.global_odom.snapshot()
            cidx = Frontend.get_closest_item(items, stamp)
            if cidx <= -1 or not items:
                self.lg.warn("global odom deque has not enough items to infer "
                             "average velocity model!!")
            else:
                if abs(items[cidx].stamp - stamp) > 0.15:
                    self.lg.warn("closest odom is out-dated!!")
                init_pose = items[cidx].odom.copy()
                # constant-velocity prediction: the reference's log message
                # (LidarOdometry.cpp:137 "average velocity model") names the
                # intent but the code falls back to the raw last pose; with a
                # near-zero-error prediction the GN loop converges in 2-3
                # iterations instead of running all 8, which is both faster
                # and tighter. Gated by frontend.velocity_model (default on).
                if self._velocity_model and cidx >= 1:
                    prev = items[cidx - 1]
                    dt_pair = items[cidx].stamp - prev.stamp
                    if 1e-6 < dt_pair < 0.5:
                        step = np.linalg.inv(prev.odom) @ items[cidx].odom
                        scale = np.clip((stamp - items[cidx].stamp) / dt_pair,
                                        0.0, 3.0)
                        init_pose = items[cidx].odom @ _fractional_pose(
                            step, scale)

        # ---- scan2map + planar clamp (LidarOdometry.cpp:163-211), fused into
        # one device call (downsample + register + SixDof2Mobile) ------------
        ds_scan = None
        if not mm.is_submap_empty():
            pc = pcops.from_numpy(scan_xyz, self.scan_capacity,
                                  self.register.device)
            target = mm.get_target()  # snapshot under the submap lock
            init_pose, converged, ds_scan = self.register.odometry_step(
                pc, target, init_pose, self.grid_size, self.ds_capacity)
            if not converged:
                self.lg.warn("pcr not converge!!")
        elif self.register.planar_clamp:
            init_pose = self.register.clamp(init_pose)
        mm.set_cur_pose(init_pose)

        kf_xyz = self._keyframe_cloud(scan_xyz)
        kf = KeyFrame(stamp, init_pose, kf_xyz)
        if mm.is_submap_empty():
            self.lg.warn("at first, no submap here for now, build the map!!")
            mm.put_keyframe(kf)
            # Build the first submap SYNCHRONOUSLY: the reference can afford
            # to just notify its map thread (the C++ build is ms-fast,
            # MapManager.cpp:151-201), but here the first build pays a
            # one-time XLA compile — an async notify would let every scan
            # until it finishes skip registration and dead-reckon (measured:
            # 26 of 40 scans in threaded mode, ATE 3.4 m). Blocking this one
            # scan keeps bag-mode backpressure honest instead.
            mm.update_map()
        else:
            self._select_keyframe(kf)

        fe.global_odom.push_back(Odometry(stamp, init_pose), block=False)
        if local_odom is not None:
            if not fe.is_init_odom2map():
                fe.set_init_odom2map()
                self.lg.info("init odom2map!!")
            fe.odom2map.store(init_pose @ np.linalg.inv(local_odom.odom))

        # vis publish of the aligned scan (LidarOdometry.cpp:226): a try-lock
        # handoff that drops the frame when the vis worker is busy
        if self.vis is not None and ds_scan is not None:
            self.vis.publish_pc(self._vis_topic, pcops.to_numpy(ds_scan),
                                init_pose)
        return init_pose

    def _select_keyframe(self, kf: KeyFrame) -> None:
        """Keyframe admission: MapManager owns the whole policy (the
        selectKeyFrame pre-gate + the nearest-KF insert gate)."""
        if self.map_manager.select_gate(kf.pose):
            self.map_manager.put_keyframe(kf)

    def _keyframe_cloud(self, scan_xyz: np.ndarray) -> np.ndarray:
        """Keyframes store the host cloud downsampled at the map grid (the
        reference stores raw and downsamples on save; we downsample up front
        to bound memory, same content the submap consumes)."""
        return self.map_manager._host_downsample(scan_xyz)
