"""Threaded (live-style) pipeline: the reference's resident-thread topology.

Mirrors the thread structure of the reference app (SURVEY.md §2.3):
ingest/bag thread (producer) ∥ LO thread ∥ map-update thread ∥ backend optim
thread ∥ LC thread (``app/main.cpp:137-139``, ``MapManager.cpp:86-91``,
``Backend.cpp:122``, ``LoopClosureManager.cpp:24``), connected by the same
primitives: the bounded lidar deque with blocking (bag) vs drop-oldest (live)
backpressure (``LidarDataProxy.cpp:45-49``), the KeyFramesObj event condvar,
and the map-update notify event.

Port of ``simpleslam_tpu/pipeline/threaded.py``. Device-compute note: every
thread enqueues its device work on the one default CUDA stream, where
launches run in the order they were queued; the threads overlap host work
(submap assembly, factor bookkeeping) with device execution. Tensors are
mutable, so no thread writes into a tensor that another thread's queued
kernel may read: the map thread builds a new target and swaps the reference
under the submap lock (``MapManager.update_map``), and the LO thread
registers against the snapshot it took. The LOAM loop kernel's workspace is
keyed by (device, stream) behind a lock, which is safe because launches on
one stream do not overlap; the threads must not be given streams of their
own without giving the kernel a workspace per launch.

``run_threaded`` is the live-mode twin of ``app.run_offline`` (same streams
in, same SlamResult out); the offline harness stays the deterministic
benchmark path.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from ..utils.concurrency import ResidentThread, SafeDeque
from ..utils.config import Params
from ..utils.logging import Logger
from ..utils.tictoc import StageTimers, TicToc
from .app import SlamResult, SlamSystem
from . import simulate as sim


class ThreadedRunner:
    """Owns the resident threads around a ``SlamSystem``."""

    def __init__(self, system: SlamSystem, bag_mode: bool = True):
        cfg = Params.get_instance()
        self.lg = Logger.get_instance()
        self.system = system
        self.bag_mode = bag_mode  # blocking push (bag) vs drop-oldest (live)
        self.lidar_deque: SafeDeque = SafeDeque(int(cfg["dataproxy"]["lidar_size"]))
        self._exit = threading.Event()
        self.est_poses: List[np.ndarray] = []
        self.est_stamps: List[float] = []
        self.timers = StageTimers()
        self._threads: List[ResidentThread] = []

    # -- thread bodies -------------------------------------------------------
    def _lo_body(self) -> None:
        item = self.lidar_deque.consume_front(block=True, timeout=0.1)
        if item is None:
            return
        stamp, scan = item
        with self.timers.span("odometry"):
            pose = self.system.lidar_odometry.generate_odom(stamp, scan)
        self.est_poses.append(pose)
        self.est_stamps.append(stamp)

    def _map_body(self) -> None:
        mm = self.system.map_manager
        if not mm._set_update.wait(timeout=0.1):
            return
        with self.timers.span("map_update"):
            mm.update_map()

    def _backend_body(self) -> None:
        kf_obj = self.system.map_manager.kf_obj
        with kf_obj.lock:
            ok = kf_obj.event_cv.wait_for(
                lambda: kf_obj._event != 0 or self._exit.is_set(), timeout=0.1)
        if not ok or self._exit.is_set():
            return
        with self.timers.span("backend"):
            self.system.backend.optim_once()

    def _lc_body(self) -> None:
        lcm = self.system.loop_closure
        if lcm.n_contexts <= lcm.lc_size:
            time.sleep(0.02)
            return
        with self.timers.span("loop_closure"):
            lcm.lc_handler_once()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._threads.append(ResidentThread(self._lo_body, name="lo"))
        self._threads.append(ResidentThread(self._map_body, name="map"))
        if self.system.backend is not None:
            self._threads.append(ResidentThread(self._backend_body, name="backend"))
        if self.system.loop_closure is not None:
            self._threads.append(ResidentThread(self._lc_body, name="lc"))

    def stop(self) -> None:
        # drain: wait until every queued scan is consumed and map/backend idle
        while len(self.lidar_deque):
            time.sleep(0.01)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            kf_obj = self.system.map_manager.kf_obj
            # keyframe events count as pending work only where a backend
            # thread consumes them (without one they would hold the drain
            # until its deadline)
            busy = (self.system.map_manager.update_pending()
                    or (self.system.backend is not None
                        and kf_obj.is_event_coming()))
            lcm = self.system.loop_closure
            if lcm is not None and lcm.n_contexts > lcm.lc_size:
                busy = True
            if not busy:
                break
            time.sleep(0.02)
        self._exit.set()
        kf_obj = self.system.map_manager.kf_obj
        with kf_obj.lock:
            kf_obj.event_cv.notify_all()
        for t in self._threads:
            t.stop()
        self.lidar_deque.abort()
        for t in self._threads:
            t.join(timeout=5.0)


def run_threaded(system: SlamSystem, streams: sim.SensorStreams,
                 realtime_rate: Optional[float] = None) -> SlamResult:
    """Replay ``streams`` through the threaded pipeline.

    ``realtime_rate=None`` replays as fast as backpressure allows (bag mode);
    a float paces dispatch at that multiple of real time (live emulation).

    One rank only: its resident threads meet at times of each process's
    own, so the backend's sharded solves could not be issued in the same
    order on several ranks. A mesh of more than one rank replays through
    ``streamed.run_streamed``.
    """
    from ..parallel.mesh import world

    if world()[1] > 1:
        raise ValueError(
            "run_threaded runs on one rank: on a mesh of more than one rank "
            "replay through pipeline.streamed.run_streamed")
    runner = ThreadedRunner(system, bag_mode=realtime_rate is None)
    runner.start()
    tt_all = TicToc()

    events = []
    for si, stamp in enumerate(streams.scan_stamps):
        events.append((float(stamp), "scan", si))
    if system.ekf_proxy is not None:
        for i, t in enumerate(streams.wheel_stamps):
            events.append((float(t), "wheel", i))
        for i, t in enumerate(streams.imu_stamps):
            events.append((float(t), "imu", i))
    order = {"imu": 0, "wheel": 1, "scan": 2}
    events.sort(key=lambda e: (e[0], order[e[1]]))

    t0 = streams.scan_stamps[0] if len(streams.scan_stamps) else 0.0
    wall0 = time.monotonic()
    for stamp, kind, i in events:
        if realtime_rate:
            lag = (stamp - t0) / realtime_rate - (time.monotonic() - wall0)
            if lag > 0:
                time.sleep(lag)
        if kind == "scan":
            runner.lidar_deque.push_back((stamp, streams.scans[i]),
                                         block=runner.bag_mode)
        elif kind == "wheel":
            system.ekf_proxy.wheel_handler(stamp, streams.wheel_poses[i])
        else:
            system.ekf_proxy.imu_handler(stamp, streams.imu_quats[i])

    runner.stop()
    wall = tt_all.elapsed()

    order_idx = np.argsort(runner.est_stamps) if runner.est_stamps else []
    poses = (np.stack([runner.est_poses[i] for i in order_idx])
             if len(order_idx) else np.zeros((0, 4, 4)))
    with system.map_manager.kf_obj.lock:
        kf_count = len(system.map_manager.kf_obj.keyframes)
    return SlamResult(
        stamps=np.asarray(sorted(runner.est_stamps)),
        poses=poses,
        timers=runner.timers,
        wall_time=wall,
        keyframe_count=kf_count,
        converged_frac=1.0,
        extras={"n_processed": len(runner.est_poses),
                "n_scans": len(streams.scan_stamps)},
    )
