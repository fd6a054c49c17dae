"""Streamed odometry executor: device-resident pose chain, one result read
per batch.

Port of ``simpleslam_tpu/pipeline/streamed.py`` (lo and lio mode, one
device):

- scans are voxel-downsampled, spatially sorted and quantized to int16 on
  the host by a producer thread (``_ScanPrep``: chunked GIL-free C++ calls,
  bounded lookahead), so each scan uploads ~48 KB;
- keyframe clouds are uploaded once into the map manager's device store, and
  submap targets are rebuilt on the device from it (``update_map_device``),
  double-buffered behind the next registration batch;
- K scans run as one batch (``_batch_body``): the prediction (lo: constant
  velocity with the step capped at ``STEP_CAP``; lio: ``odom2map`` composed
  with the scan's EKF local odometry), the configured register
  (``loam.gn_loop``: one launch of the kernel K3 per scan on CUDA; NDT and
  VGICP: their fixed-count loops), the planar clamp and the NaN guard, with
  no host read in between and the pose chain
  (``pose_prev``, ``pose_prev2``, ``odom2map``) kept in device tensors that
  feed the next batch directly. The batch's packed (K, 21) result rows are
  read back once, when the batch retires;
- lio mode fuses the wheel+IMU tape on the host in 4096-event chunks, just
  far enough ahead of each batch (``_LocalOdomFeeder``), and uploads the
  batch's (K, 4, 4) local odometry with its scans;
- with ``vis.enable`` every retired scan is handed to the visualizer
  (``pipeline/vis.py``, a try-lock handoff) as its host-side prepped row
  and the pose just read, so a publish touches the device nowhere;
- keyframe admission, backend passes and loop closure run at batch
  boundaries, behind the odometry by up to ``tpu.pipeline_depth`` batches:
  on a resident worker thread (``_BackendWorker``), or inline with
  ``tpu.sync_backend`` (deterministic). A solve's rigid correction reaches
  the device chain, the recorded trajectory at and after the solve's last
  keyframe, and the batches still in flight; with the worker, every scan is
  re-based on its anchor keyframe's final pose at shutdown.

The reference's one-program ``lax.scan`` over the batch is a Python loop
over its scans here that only enqueues device work (the GN loop and its exit
tests run inside K3; NDT and VGICP run their iteration a fixed number of
times with a frozen state once done). Not ported yet: the mesh-sharded batch
(``tpu.mesh_devices``, ROADMAP item 12).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from .. import native
from ..models import filter as flt
from ..models.mapmanager import KeyFrame, KFEvent
from ..models.registration import register_kind
from ..ops import geometry as geo
from ..ops.pointcloud import PAD_COORD, PointCloud
from ..utils.config import Params
from ..utils.logging import Logger
from ..utils.tictoc import StageTimers, TicToc
from . import simulate as sim
from .app import SlamResult, SlamSystem

# Scan rows are uploaded as int16 at UPLOAD_SCALE metres per count (~3.8 mm
# over +-125 m, below sensor noise; returns beyond the range are dropped by
# the host prep). 32767 is the padding sentinel.
UPLOAD_SCALE = 125.0 / 32767.0
UPLOAD_PAD = 32767

# Unconditional cap on the constant-velocity prediction's per-scan
# translation (metres): inert for any physical sensor at scan rate, it stops
# the velocity model from amplifying a chain inconsistency (see _batch_body).
STEP_CAP = 5.0


def upload_cloud(raw_q: torch.Tensor) -> PointCloud:
    """One uploaded (C, 3) int16 scan row back to a padded cloud in metres
    (validity from the UPLOAD_PAD sentinel): the registration's queries."""
    mask = raw_q[:, 0] != UPLOAD_PAD
    raw = torch.where(mask[:, None], raw_q.to(torch.float32) * UPLOAD_SCALE,
                      torch.full(raw_q.shape, PAD_COORD, device=raw_q.device))
    return PointCloud(raw, torch.zeros_like(raw[:, 0]), mask)


def _batch_body(ds_stack: torch.Tensor, target, pose_prev: torch.Tensor,
                pose_prev2: torch.Tensor, odom2map: torch.Tensor, kind: str,
                clamp: bool, degen: float, jump_cap: float = 0.0,
                local_odoms: Optional[torch.Tensor] = None):
    """K odometry steps on the device chain.

    ``ds_stack`` is (K, C, 3) int16 host-prepped scans (validity from the
    UPLOAD_PAD sentinel). ``local_odoms`` is the (K, 4, 4) EKF local
    odometry of the scans in lio mode, None in lo mode. Returns ((pose_K,
    pose_{K-1}, odom2map_K), packed (K, 21)), a packed row being [pose16,
    converged, fitness, gn_iters, gn_gathers, n_valid]. ``odom2map`` passes
    through in lo mode.

    Nothing in here reads a value from the device: every decision (the NaN
    guard, the jump rejection) is a ``torch.where``, so on the GPU the K
    registrations queue up behind each other and the batch's one host read
    is that of its packed rows when it retires.
    """
    rows = []
    prev, prev2, o2m = pose_prev, pose_prev2, odom2map
    for k, raw_q in enumerate(ds_stack):
        pc = upload_cloud(raw_q)
        if local_odoms is not None:
            # loose coupling: predict through odom2map (LidarOdometry.cpp:129)
            init = geo.pose_compose(o2m, local_odoms[k])
        else:
            # constant-velocity prediction with the extrapolated per-scan
            # translation capped unconditionally: once two chain poses
            # disagree by D, uncapped extrapolation re-applies D every scan
            # (measured in the reference package: a 3 m disagreement grew to
            # 1e33 m within ~40 keyframes); no sensor moves 5 m between
            # 10 Hz scans
            step = geo.pose_compose(geo.pose_inverse(prev2), prev)
            st_t = step[:3, 3]
            scale = torch.clamp(
                STEP_CAP / torch.clamp(torch.linalg.norm(st_t), min=1e-9),
                max=1.0)
            step = geo.make_pose(step[:3, :3], st_t * scale)
            init = geo.pose_compose(prev, step)
        pose, conv, fit, iters, gathers, support = register_kind(
            pc, target, init, kind, degen)
        if clamp:  # planar clamp each frame (frontend.planar_clamp config)
            pose = geo.six_dof_to_mobile(pose)
        # NaN safety is unconditional (one non-finite pose poisons the
        # chain); the jump rejection is opt-in (tpu.max_scan_jump_m), since
        # rejecting measured worse than using results as-is
        ok = torch.all(torch.isfinite(pose))
        if jump_cap > 0:
            jump = torch.linalg.norm(pose[:3, 3] - init[:3, 3])
            ok = ok & (jump <= torch.where(conv, jump_cap, jump_cap / 3.0))
        pose = torch.where(ok, pose, init)
        if local_odoms is not None:
            # odom2map update (LidarOdometry.cpp:238)
            o2m = geo.pose_compose(pose, geo.pose_inverse(local_odoms[k]))
        tail = torch.stack([(ok & conv).to(torch.float32),
                            fit.to(torch.float32), iters.to(torch.float32),
                            gathers.to(torch.float32),
                            support.to(torch.float32)])
        rows.append(torch.cat([pose.reshape(16), tail]))
        prev2, prev = prev, pose
    return (prev, prev2, o2m), torch.stack(rows)


def _apply_delta(delta: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    return geo.reorthonormalize(geo.pose_compose(delta, pose))


class _BackendWorker:
    """Resident backend + loop-closure thread (the optimHandler role,
    Backend.cpp:270-346).

    Waits on the keyframe event bus, runs ``Backend.optim_once`` (with the
    loop-closure retrievals queued before its result read) and the
    loop-closure turn, and publishes each solve's rigid correction; the main
    loop applies pending corrections between batches. Its device work goes
    onto the same stream as the odometry's. An exception here is stored and
    raised in the main loop at its next ``drain``/``wait_progress``.
    """

    def __init__(self, system: SlamSystem, timers: StageTimers):
        self.system = system
        self.kf_obj = system.map_manager.kf_obj
        self.timers = timers
        self._deltas: List[tuple] = []  # (delta 4x4, solve kf count)
        self._dlock = threading.Lock()
        self._stop = False
        self._error: Optional[BaseException] = None
        # keyframe-count watermark of the last serviced event (backpressure)
        with self.kf_obj.lock:
            self.serviced_kf_count = len(self.kf_obj.keyframes)
        self._progress = threading.Condition()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="backend")
        self.thread.start()

    def _run(self) -> None:
        kf = self.kf_obj
        tt = TicToc()
        try:
            while True:
                with kf.lock:
                    while kf._event == KFEvent.NONE and not self._stop:
                        kf.event_cv.wait(timeout=0.1)
                    if kf._event == KFEvent.NONE and self._stop:
                        return
                    stamp = kf.event_stamp
                sys_ = self.system
                tt.tic()
                hook = (sys_.loop_closure.dispatch_queries
                        if sys_.loop_closure is not None else None)
                if sys_.backend.optim_once(pre_fetch_hook=hook):
                    self._push(sys_.backend.last_delta,
                               sys_.backend.last_kf_count)
                self.timers.add("backend", tt.toc())
                # how far the worker runs behind the odometry loop
                self.timers.add("backend_lag", time.monotonic() - stamp)
                if sys_.loop_closure is not None:
                    tt.tic()
                    if sys_.loop_closure.lc_handler_once():
                        if sys_.backend.optim_once():
                            self._push(sys_.backend.last_delta,
                                       sys_.backend.last_kf_count)
                    self.timers.add("lc", tt.toc())
                with self.kf_obj.lock:
                    n_now = len(self.kf_obj.keyframes)
                with self._progress:
                    self.serviced_kf_count = n_now
                    self._progress.notify_all()
        except BaseException as e:  # raised again in the main loop
            self._error = e
            with self._progress:
                self._progress.notify_all()

    def _push(self, delta: np.ndarray, kf_count: int) -> None:
        with self._dlock:
            self._deltas.append((delta.copy(), kf_count))

    def _check(self) -> None:
        if self._error is not None:
            raise RuntimeError("backend worker died") from self._error

    def wait_progress(self, timeout: float) -> None:
        """Block until the worker services another event (backpressure)."""
        self._check()
        with self._progress:
            self._progress.wait(timeout=timeout)

    def drain(self) -> List[tuple]:
        self._check()
        with self._dlock:
            out, self._deltas = self._deltas, []
        return out

    def close(self) -> List[tuple]:
        """Finish the queued events, stop, return the final corrections."""
        self._stop = True
        with self.kf_obj.lock:
            self.kf_obj.event_cv.notify_all()
        self.thread.join()
        return self.drain()


class _ScanPrep:
    """Producer thread: host downsample + spatial sort + int16 quantization
    into the padded upload layout (the LidarDataProxy role,
    dataproxy/src/LidarDataProxy.cpp), in chunks through one GIL-free native
    call each, with bounded lookahead (``depth`` scans ahead of the
    consumer)."""

    def __init__(self, scans, grid: float, capacity: int, depth: int = 64,
                 chunk: int = 16, sort_grid: float = 0.0):
        self.scans = scans
        self.grid = grid
        self.capacity = capacity
        self.sort_grid = sort_grid
        self.depth = depth
        self.chunk = chunk
        self._results = {}
        self._consumed = 0  # lowest index not yet consumed
        self._cv = threading.Condition(threading.Lock())
        self._stop = False
        self._error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="scanprep")
        self.thread.start()

    def _run(self) -> None:
        n = len(self.scans)
        try:
            nxt = 0
            while nxt < n:
                with self._cv:
                    while (not self._stop
                           and nxt - self._consumed >= self.depth):
                        self._cv.wait(timeout=0.5)
                    if self._stop:
                        return
                lo, hi = nxt, min(nxt + self.chunk, n)
                # sorting by sensor-frame voxel key at the target grid makes
                # consecutive queries read neighbouring rows of the target
                qrows, cnts = native.voxel_downsample_sort_quant_batch(
                    [np.asarray(self.scans[i], np.float32)
                     for i in range(lo, hi)],
                    self.grid, self.capacity, self.sort_grid, UPLOAD_SCALE)
                with self._cv:
                    for k, i in enumerate(range(lo, hi)):
                        self._results[i] = (qrows[k], int(cnts[k]))
                    self._cv.notify_all()
                nxt = hi
        except BaseException as e:  # raised again in get()
            with self._cv:
                self._error = e
                self._cv.notify_all()

    def get(self, i: int):
        """Scan ``i``'s prepped row and count (blocks until it is ready; 60 s
        of producer silence is an error)."""
        with self._cv:
            while i not in self._results:
                if self._error is not None:
                    raise RuntimeError("scan prep worker died") \
                        from self._error
                if not self._cv.wait(timeout=60.0):
                    raise RuntimeError("scan prep timed out")
            out = self._results.pop(i)
            if i >= self._consumed:
                self._consumed = i + 1
                self._cv.notify_all()  # release the backpressured producer
        return out

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self.thread.join(timeout=5.0)


class _LocalOdomFeeder:
    """Incremental wheel+IMU fusion for lio mode.

    Fuses the event tape in fixed 4096-event chunks through
    ``models/filter.ekf_replay_chunk`` (the filter state is carried across
    chunks, bit-identical to the whole-tape replay), advancing only far
    enough to finalize the local odoms each scan batch needs — the
    streaming, head-free shape of the reference proxy
    (EkfOdomProxy.cpp:185-248). The replay runs on the host (see
    ``models/filter.py`` for why).

    Padding note: pad rows perturb the carry (an IMU pad row consumes the
    update flag and shrinks P on a zero-innovation update), so only the
    final chunk — after which no real event follows — is ever padded.
    """

    CHUNK = 4096

    def __init__(self, streams, scan_stamps: np.ndarray,
                 local_np: np.ndarray):
        (self.ev_stamps, self.ev_iswheel, self.ev_xy, self.ev_wyaw,
         self.ev_iyaw) = flt.build_tape_arrays(
            streams.wheel_stamps, streams.wheel_poses,
            streams.imu_stamps, streams.imu_quats)
        self.n_events = len(self.ev_stamps)
        self.carry = flt.ekf_carry0()
        self.pos = 0
        self.lo_stamps = np.zeros(0)
        self.lo_states = np.zeros((0, 3))
        self.scan_stamps = scan_stamps
        self.local_np = local_np
        self.filled = 0  # scans whose local_np row is final
        self.n_chunks = 0

    def _advance_chunk(self) -> None:
        lo, hi = self.pos, min(self.pos + self.CHUNK, self.n_events)
        sl = slice(lo, hi)
        im = ~self.ev_iswheel[sl]
        last_iyaw = float(self.ev_iyaw[sl][im][-1]) if im.any() else 0.0
        tape = flt.pad_tape_chunk(
            self.ev_stamps[sl], self.ev_iswheel[sl], self.ev_xy[sl],
            self.ev_wyaw[sl], self.ev_iyaw[sl], self.CHUNK, last_iyaw)
        self.carry, res = flt.ekf_replay_chunk(self.carry, tape)
        self.lo_stamps = np.concatenate(
            [self.lo_stamps, res.stamps.astype(np.float64)[res.emitted]])
        self.lo_states = np.concatenate(
            [self.lo_states, res.states.astype(np.float64)[res.emitted]])
        self.pos = hi
        self.n_chunks += 1

    def ensure(self, hi_scan: int) -> None:
        """Finalize ``local_np`` rows [0, hi_scan] (blocking fuse as needed).

        A row is final once an emitted odom with a later stamp exists (the
        nearest-of-two bracket is then decided) or the tape is exhausted.
        """
        if hi_scan < self.filled:
            return
        t = float(self.scan_stamps[hi_scan])
        while self.pos < self.n_events and (
                len(self.lo_stamps) == 0 or self.lo_stamps[-1] <= t):
            self._advance_chunk()
        if len(self.lo_stamps) == 0:
            raise ValueError("lio mode needs wheel odometry in the stream")
        # nearest-stamp local odom per scan (the vectorized
        # Frontend::getClosestLocalOdom, Frontend.cpp:25-52)
        ts = self.scan_stamps[self.filled: hi_scan + 1]
        nearest = np.clip(np.searchsorted(self.lo_stamps, ts), 1,
                          len(self.lo_stamps) - 1)
        nearest -= (ts - self.lo_stamps[nearest - 1]
                    < self.lo_stamps[nearest] - ts).astype(int)
        for k, st in zip(range(self.filled, hi_scan + 1),
                         self.lo_states[nearest]):
            c, sn = np.cos(st[2]), np.sin(st[2])
            self.local_np[k, 0, 0] = c
            self.local_np[k, 0, 1] = -sn
            self.local_np[k, 1, 0] = sn
            self.local_np[k, 1, 1] = c
            self.local_np[k, 0, 3] = st[0]
            self.local_np[k, 1, 3] = st[1]
        self.filled = hi_scan + 1


def run_streamed(system: SlamSystem, streams: sim.SensorStreams,
                 sync_every: int = 16, progress: bool = False,
                 device_probe: bool = False) -> SlamResult:
    """Replay ``streams`` through the streamed executor (lo or lio mode), in
    batches of ``sync_every`` scans.

    ``device_probe=True`` blocks on each batch right after it is enqueued
    and books the wait as ``device_exec``: the time from the first launch of
    the batch to its last kernel's end, at the cost of the pipelining (the
    host no longer runs ahead of the device). The result read is then booked
    in two parts, ``fetch_wait`` (what of the batch the host still had to
    wait for) and ``fetch_xfer`` (the copy of the packed rows), instead of
    ``fetch``. The poses are the same either way.

    With ``SIMPLESLAM_DEBUG_SUPPORT`` set in the environment, every retired
    scan prints its support, converged flag, iterations and position.
    """
    lg = Logger.get_instance()
    cfg = Params.get_instance()
    if int(cfg["tpu"].get("mesh_devices", 0)):
        raise NotImplementedError(
            "the mesh-sharded streamed batch (tpu.mesh_devices > 0) is not "
            "ported to simpleslam_tpu_torch yet (ROADMAP item 12)")
    timers = StageTimers()
    tt_all = TicToc()
    tt = TicToc()
    stats = {"gn_iters": 0.0, "gn_gathers": 0.0, "n_batches": 0, "n_reg": 0,
             "support_sum": 0.0, "support_min": float("inf"),
             "n_deltas": 0, "n_dropped_deltas": 0}

    mm = system.map_manager
    mm.enable_device_store()
    dev = system.register.device
    grid = float(system.lidar_odometry.grid_size)
    # scan-row capacity (the registration query axis): auto mode sizes it
    # from the first scan's downsampled occupancy (+20 %, 512-aligned),
    # latched on the system so later runs keep the same shapes
    dsc = getattr(system, "_streamed_scan_capacity", None)
    if dsc is None:
        dsc = int(cfg["tpu"].get("ds_scan_capacity", 8192))
        if bool(cfg["tpu"].get("auto_scan_capacity", True)) \
                and len(streams.scans):
            cnt0 = len(native.voxel_downsample_first(
                np.asarray(streams.scans[0], np.float32), grid))
            dsc = max(2048, min(dsc, -(-int(cnt0 * 1.2) // 512) * 512))
        dsc = min(dsc, mm.kf_capacity)  # scan rows must fit kf-store rows
        system._streamed_scan_capacity = dsc
    kind = system.register.KIND
    mode = system.mode
    clamp = bool(cfg["frontend"].get("planar_clamp", True))
    degen = float(system.register.degen_per_row)
    # jump rejection defaults off (results are used as-is, as the reference
    # does); NaN safety and the STEP_CAP are unconditional
    jump_cap = float(cfg["tpu"].get("max_scan_jump_m", 0.0))

    scan_stamps = np.asarray(streams.scan_stamps)
    n_scans = len(scan_stamps)
    est_poses = np.tile(np.eye(4), (n_scans, 1, 1))
    # every scan records the keyframe that anchored it, so late solves reach
    # already-recorded poses: retroactively (the rigid delta to scans at and
    # after the solve's last keyframe, Backend.cpp:333-342), then at
    # shutdown by re-basing each scan on its anchor's final pose
    scan_anchor = np.full(n_scans, -1, np.int64)   # scan -> keyframe idx
    kf_scan_idx: List[int] = []                    # keyframe -> scan idx
    with mm.kf_obj.lock:
        kf_scan_idx.extend([-1] * len(mm.kf_obj.keyframes))  # resumed kfs
    retired_hi = 0                                 # scans recorded so far
    n_conv = 0

    # lio: fuse the wheel+IMU stream incrementally in chunks (the feeder
    # advances just past each batch's stamps, keeping the EKF off the
    # startup critical path) and pick the closest local odom per scan
    local_np = np.tile(np.eye(4, dtype=np.float32), (n_scans, 1, 1))
    feeder: Optional[_LocalOdomFeeder] = None
    if mode == "lio":
        tt.tic()
        feeder = _LocalOdomFeeder(streams, scan_stamps, local_np)
        feeder.ensure(0)  # the chain anchor needs scan 0's local odom
        timers.add("ekf_replay", tt.toc())

    # spatial sort at the LOAM dense-map grid, or at the NDT/VGICP voxel
    # resolution (their Gaussian lookups coalesce the same way)
    sort_grid = getattr(system.register, "TARGET_GRID",
                        getattr(system.register, "RESOLUTION", 0.0))
    prep = _ScanPrep(streams.scans, grid, dsc, sort_grid=float(sort_grid))
    # tpu.sync_backend: service keyframe events inline at batch boundaries
    # instead of on the worker thread — throughput pays the serialized
    # solves, accuracy becomes a function of the data alone
    sync_backend = (bool(cfg["tpu"].get("sync_backend", False))
                    and system.backend is not None)
    worker = (_BackendWorker(system, timers)
              if system.backend is not None and not sync_backend else None)

    try:
        # --- bootstrap: a fresh map is seeded by scan 0, unregistered ---
        def _dequant(row: np.ndarray, cnt: int) -> np.ndarray:
            """Valid prefix of an int16 upload row, back in metres (f32)."""
            return row[:cnt].astype(np.float32) * np.float32(UPLOAD_SCALE)

        si = 0
        start_pose = mm.cur_pose.load().copy()
        odom2map_np = np.eye(4)
        if mode == "lio":
            # odom2map so the chain starts at start_pose for the first
            # local odom
            odom2map_np = start_pose @ np.linalg.inv(
                local_np[0].astype(np.float64))
        if mm.is_submap_empty():
            tt.tic()
            row0, cnt0 = prep.get(0)
            pose0 = start_pose if mode != "lio" else (
                odom2map_np @ local_np[0].astype(np.float64))
            est_poses[0] = pose0
            n_conv += 1
            mm.set_cur_pose(pose0)
            xyz0 = _dequant(row0, cnt0)
            lg.warn("at first, no submap here for now, build the map!!")
            kf0 = KeyFrame(float(scan_stamps[0]), pose0, xyz0)
            if mm.put_keyframe(kf0):
                with mm.kf_obj.lock:
                    kf_idx = len(mm.kf_obj.keyframes) - 1
                mm.store_keyframe_cloud(kf_idx, xyz0)
                kf_scan_idx.append(0)
            mm.update_map_device()
            scan_anchor[0] = len(kf_scan_idx) - 1
            retired_hi = 1
            si = 1
            timers.add("bootstrap", tt.toc())

        def _pose_t(p: np.ndarray) -> torch.Tensor:
            return torch.tensor(np.asarray(p, np.float32), device=dev)

        pose_prev = _pose_t(est_poses[si - 1] if si else start_pose)
        pose_prev2 = pose_prev  # zero-velocity start
        odom2map = _pose_t(odom2map_np)
        kf_rows = {}  # scan idx -> prepped row kept for keyframe upload
        debug_support = bool(os.environ.get("SIMPLESLAM_DEBUG_SUPPORT"))
        vis = system.vis
        vis_topic = cfg["vis"]["align"].strip("/")

        def _wait_for_device() -> None:
            """Block until the device has run everything enqueued so far."""
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

        def dispatch(si: int, pose_prev, pose_prev2, odom2map):
            """Prep + upload + register one batch. A final partial batch
            registers only its real scans (the Python loop needs no fixed
            K), so the chain it leaves is that of the last real scan: the
            reference pads the tail to K by repeating the last scan and
            then rewinds the poses and ``odom2map``; here there is nothing
            to rewind."""
            batch = list(range(si, min(si + sync_every, n_scans)))
            if feeder is not None:
                tt.tic()
                feeder.ensure(batch[-1])  # finalize this batch's local odoms
                timers.add("ekf_replay", tt.toc())
            mm.commit_pending_target()  # double-buffer swap boundary
            target = mm.get_target()
            tt.tic()
            rows = np.empty((len(batch), dsc, 3), np.int16)
            for k, i in enumerate(batch):
                row, cnt = prep.get(i)
                rows[k] = row
                kf_rows[i] = (row, cnt)
            timers.add("prep", tt.toc())
            tt.tic()
            rows_d = torch.from_numpy(rows).to(dev)
            locals_d = (torch.from_numpy(
                local_np[batch[0]: batch[-1] + 1]).to(dev)
                if mode == "lio" else None)
            timers.add("upload", tt.toc())
            tt.tic()
            (pose_prev, pose_prev2, odom2map), packed = _batch_body(
                rows_d, target, pose_prev, pose_prev2, odom2map, kind, clamp,
                degen, jump_cap, locals_d)
            if device_probe:
                _wait_for_device()
                timers.add("device_exec", tt.toc())
            timers.add("dispatch", tt.toc())
            # the map rebuild runs behind the batch just registered and is
            # committed at the next dispatch (double buffering)
            if mm.update_pending():
                tt.tic()
                mm.update_map_device(defer_swap=True)
                timers.add("map_update", tt.toc())
            return batch, packed, pose_prev, pose_prev2, odom2map

        def retire(batch, packed, corr) -> None:
            """Read one batch's results back (once) and do the lagged host
            bookkeeping. ``corr`` composes every backend delta applied to the
            device chain after this batch was dispatched: the batch's poses
            predate them and are re-based into the current map frame here."""
            nonlocal n_conv, retired_hi
            tt.tic()
            if device_probe:
                _wait_for_device()
                timers.add("fetch_wait", tt.toc())
                stacked = packed.cpu().numpy()
                timers.add("fetch_xfer", tt.toc())
            else:
                stacked = packed.cpu().numpy()
                timers.add("fetch", tt.toc())
            nb = len(batch)
            stats["n_batches"] += 1
            stats["n_reg"] += nb
            stats["gn_iters"] += float(np.sum(stacked[:nb, 18]))
            stats["gn_gathers"] += float(np.sum(stacked[:nb, 19]))
            sup = stacked[:nb, 20]
            stats["support_sum"] += float(np.sum(sup))
            stats["support_min"] = min(stats["support_min"],
                                       float(np.min(sup)))
            if debug_support:
                for k, i in enumerate(batch):
                    print(f"scan {i} sup {int(sup[k])} conv "
                          f"{int(stacked[k, 16])} iters {int(stacked[k, 18])} "
                          f"pos {stacked[k, 3]:.1f},{stacked[k, 7]:.1f}",
                          flush=True)
            tt.tic()
            for k, i in enumerate(batch):
                pose = corr @ stacked[k, :16].reshape(4, 4).astype(np.float64)
                conv = stacked[k, 16] > 0.5
                n_conv += bool(conv)
                if not conv:
                    lg.warn("pcr not converge!!")
                est_poses[i] = pose
                mm.set_cur_pose(pose)  # fires the > 1 m map-update notify
                if mm.select_gate(pose):  # MapManager owns the admission
                    row, cnt = kf_rows[i]
                    xyz = _dequant(row, cnt)
                    if mm.put_keyframe(
                            KeyFrame(float(scan_stamps[i]), pose, xyz)):
                        with mm.kf_obj.lock:
                            kf_idx = len(mm.kf_obj.keyframes) - 1
                        mm.store_keyframe_cloud(kf_idx, xyz)
                        kf_scan_idx.append(i)
                scan_anchor[i] = len(kf_scan_idx) - 1
                if vis is not None:
                    # the aligned scan, from what the host already holds (its
                    # prepped row and the pose just read): no device access
                    vis.publish_pc(vis_topic, _dequant(*kf_rows[i]), pose)
                kf_rows.pop(i, None)
            retired_hi = batch[-1] + 1
            timers.add("bookkeep", tt.toc())

            # backend corrections reach the chain after every solve that ran
            # (optimHandler applies its delta per pass, Backend.cpp:310-346)
            if worker is not None:
                for delta, kf_count in worker.drain():
                    _apply_backend_delta(delta, kf_count)
            elif sync_backend and mm.kf_obj.is_event_coming():
                # the optimHandler turn run inline (see sync_backend above)
                tt.tic()
                be = system.backend
                hook = (system.loop_closure.dispatch_queries
                        if system.loop_closure is not None else None)
                if be.optim_once(pre_fetch_hook=hook):
                    _apply_backend_delta(be.last_delta, be.last_kf_count)
                timers.add("backend", tt.toc())
                if system.loop_closure is not None:
                    tt.tic()
                    if system.loop_closure.lc_handler_once():
                        if be.optim_once():
                            _apply_backend_delta(be.last_delta,
                                                 be.last_kf_count)
                    timers.add("lc", tt.toc())

        def _apply_backend_delta(delta_np: np.ndarray, kf_count: int) -> None:
            """Broadcast one solve's rigid correction everywhere pose state
            lives: the device chain (future scans), the recorded trajectory at
            and after the solve's last keyframe (the GlobalOdom rewrite,
            Backend.cpp:333-342), and the in-flight batches' re-base."""
            nonlocal pose_prev, pose_prev2, odom2map
            # a non-finite or implausibly large delta never reaches the chain
            if (not np.isfinite(delta_np).all()
                    or np.linalg.norm(delta_np[:3, 3]) > 1e3):
                lg.error("dropping non-finite/implausible backend delta")
                stats["n_dropped_deltas"] += 1
                return
            delta = _pose_t(delta_np)
            pose_prev = _apply_delta(delta, pose_prev)
            pose_prev2 = _apply_delta(delta, pose_prev2)
            odom2map = _apply_delta(delta, odom2map)
            wm = (kf_scan_idx[kf_count - 1]
                  if 0 < kf_count <= len(kf_scan_idx) else -1)
            wm = max(wm, 0)
            if wm < retired_hi:
                est_poses[wm:retired_hi] = np.einsum(
                    "ab,nbc->nac", delta_np, est_poses[wm:retired_hi])
            for ent in pending:
                ent[2] = delta_np @ ent[2]
            stats["n_deltas"] += 1

        def _consume_reloc(si: int) -> None:
            """An /initialpose reloc (LidarOdometry.set_reloc_flag) resets the
            device chain at the next batch boundary (RelocDataProxy role);
            in lio mode it also re-anchors odom2map so the next init equals
            the reloc pose (LidarOdometry.cpp:121-129's reloc branch)."""
            nonlocal pose_prev, pose_prev2, odom2map
            lo = system.lidar_odometry
            with lo._reloc_lock:
                if not lo.reloc:
                    return
                rpose = lo.reloc_pose.copy()
                lo.reloc = False
            lg.info("reloc-ing...")
            pose_prev = _pose_t(rpose)
            pose_prev2 = pose_prev  # zero-velocity restart
            if feeder is not None:
                nxt = min(si, n_scans - 1)
                feeder.ensure(nxt)
                odom2map = _pose_t(rpose @ np.linalg.inv(
                    local_np[nxt].astype(np.float64)))

        # pipelined drive: up to ``depth`` batches are dispatched before the
        # oldest retires, so keyframe admission and corrections reach the chain
        # up to depth * sync_every scans late (the reference's map and backend
        # threads lag the same way)
        depth = max(1, int(cfg["tpu"].get("pipeline_depth", 2)))
        # backpressure on backend events: with more than this many admitted
        # keyframes unserviced by the worker, dispatch blocks until it
        # catches up
        # (LidarDataProxy.cpp:45-49 blocking push); <= 0 disables
        max_backlog = int(cfg["tpu"].get("backend_max_backlog_kf", 12))

        def _backlogged() -> bool:
            return (worker is not None and max_backlog > 0
                    and len(kf_scan_idx) - worker.serviced_kf_count
                    > max_backlog)

        pending = deque()
        while si < n_scans or pending:
            if si < n_scans and not _backlogged():
                # corrections reach the chain before more scans register
                if worker is not None:
                    for delta_, kfc_ in worker.drain():
                        _apply_backend_delta(delta_, kfc_)
                _consume_reloc(si)
                batch, packed, pose_prev, pose_prev2, odom2map = dispatch(
                    si, pose_prev, pose_prev2, odom2map)
                si = batch[-1] + 1
                pending.append([batch, packed, np.eye(4)])
            if pending and (len(pending) >= depth or si >= n_scans
                            or _backlogged()):
                done = pending.popleft()
                retire(done[0], done[1], done[2])
                if progress:
                    lg.info("scan %d/%d", done[0][-1] + 1, n_scans)
            elif _backlogged() and not pending and si < n_scans:
                tt.tic()
                worker.wait_progress(timeout=0.05)
                timers.add("backend_backpressure", tt.toc())
    except BaseException:
        if worker is not None:
            worker._stop = True  # it exits at its next idle wait
        raise
    finally:
        prep.close()
    if worker is not None:
        # drain the queued keyframe events (the reference joins its optim
        # thread at shutdown, Backend.cpp:349-358)
        for delta, kf_count_ in worker.close():
            _apply_backend_delta(delta, kf_count_)
    wall = tt_all.elapsed()
    with mm.kf_obj.lock:
        kf_count = len(mm.kf_obj.keyframes)
        kf_stamps = np.array([kf.stamp for kf in mm.kf_obj.keyframes])
        kf_poses = (np.stack([kf.pose for kf in mm.kf_obj.keyframes])
                    if mm.kf_obj.keyframes else np.zeros((0, 4, 4)))
    if worker is not None and len(kf_scan_idx):
        # re-base every scan on its anchor keyframe's final optimized pose:
        # scan i keeps its registration-measured offset to its anchor (both
        # recorded in one map frame), re-rooted at the anchor's final pose
        base = est_poses.copy()
        for i in range(n_scans):
            a = int(scan_anchor[i])
            if a < 0 or a >= len(kf_scan_idx):
                continue
            j = kf_scan_idx[a]
            if j < 0 or a >= len(kf_poses):
                continue  # resumed keyframe with no scan in this run
            est_poses[i] = kf_poses[a] @ np.linalg.inv(base[j]) @ base[i]
    n_reg = max(stats["n_reg"], 1)
    return SlamResult(
        stamps=scan_stamps,
        poses=est_poses,
        timers=timers,
        wall_time=wall,
        keyframe_count=kf_count,
        converged_frac=n_conv / max(n_scans, 1),
        extras={
            "gn_iters_mean": round(stats["gn_iters"] / n_reg, 3),
            "gn_gathers_mean": round(stats["gn_gathers"] / n_reg, 3),
            "n_batches": stats["n_batches"],
            "scan_capacity": dsc,
            "support_mean": round(stats["support_sum"] / n_reg, 1),
            "support_min": (int(stats["support_min"])
                            if stats["n_batches"] else 0),
            "n_deltas": stats["n_deltas"],
            "n_dropped_deltas": stats["n_dropped_deltas"],
            "ekf_chunks": feeder.n_chunks if feeder is not None else 0,
            # the reference's evaluation artifact: optimized keyframe TUM
            "kf_stamps": kf_stamps,
            "kf_poses": kf_poses,
        },
    )
