"""Loop-closure detection + verification (reference LoopClosureManager).

Port of ``simpleslam_tpu/models/loopclosure.py``
(``backend/src/LoopClosureManager.cpp:11-127``):
- ``add_context``: one place-recognition descriptor per new keyframe — from
  the device keyframe store when the streamed executor keeps one (no cloud
  upload), else from the host cloud downsampled at
  ``contextDownSampleGridSize`` (:28-37);
- ``lc_handler_once``: each unprocessed context is queried; a candidate is
  verified by VGICP in loop-closure mode against a history submap of
  ``+-historySubmapRange`` neighbour keyframes (:40-60), seeded with the
  descriptor's yaw hint on large-angle revisits; a converged match with
  fitness < ``fitnessThreshold`` (and within the optional correction gate)
  becomes an ``LCResult`` and fires the LC event (:62-119).

As in the reference package, the accepted between-measurement uses the
VGICP-refined pose, ``between = old_pose^-1 * refined`` (the reference's
``old_pose^-1 * cur_pose`` carries no correction signal).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..ops import pointcloud as pcops
from ..utils import tictoc
from ..utils.concurrency import SafeDeque
from ..utils.config import Params
from ..utils.logging import Logger
from .context import make_context
from .mapmanager import MapManager
from .registration import VgicpRegister


@dataclass
class LCResult:
    from_idx: int
    to_idx: int
    between: np.ndarray  # (4, 4): T_from^-1 * T_to_refined


# Seed the verification from the descriptor yaw hint when it disagrees with
# the current estimate by more than this (rad): VGICP's loosened radius
# absorbs translation drift but not a large rotation error.
YAW_SEED_THRESH = 0.35


def _wrap_angle(a: float) -> float:
    return float(np.arctan2(np.sin(a), np.cos(a)))


class LoopClosureManager:
    def __init__(self, map_manager: MapManager, context=None):
        cfg = Params.get_instance()
        lc_cfg = cfg["backend"]["lc"]
        self.lg = Logger.get_instance()
        self.map_manager = map_manager
        self.kf_obj = map_manager.kf_obj
        self.device = torch.device(cfg["torch"]["device"])

        self.context_ds = float(lc_cfg["contextDownSampleGridSize"])
        self.history_range = int(lc_cfg["historySubmapRange"])
        self.fitness_thresh = float(lc_cfg["fitnessThreshold"])
        # optional plausibility gate on the implied correction (metres);
        # 0 disables (reference behaviour)
        self.max_correction = float(lc_cfg.get("maxCorrectionMeters", 0.0))
        self.n_rejected_correction = 0

        self.context = context if context is not None else make_context()
        self.lc_size = 0  # processed watermark (lc_size_)

        self.register = VgicpRegister()
        self.register.init_for_lc()
        self._lc_queue_cap = int(lc_cfg.get("queueSize", 128))
        self.lc_queue: SafeDeque[LCResult] = SafeDeque(self._lc_queue_cap)
        self._ctx_capacity = int(cfg["tpu"]["ds_scan_capacity"])
        self._submap_capacity = int(cfg["tpu"]["submap_capacity"])
        # one history-submap target per (old_key, window-pose fingerprint):
        # consecutive revisit queries often hit the same map region
        self._target_cache: dict = {}
        self._target_cache_max = 8
        self._pending_queries = None
        self.dropped_closures = 0  # accepted-but-dropped (queue overflow)
        # detector funnel: queries -> candidates -> converged verifications
        # -> accepts (= n_lc_edges on the backend)
        self.n_queries = 0
        self.n_candidates = 0
        self.n_verify_converged = 0

    @property
    def n_contexts(self) -> int:
        return self.context.n_contexts

    def prewarm(self) -> None:
        """Run the verification chain (target build, align, fitness) once on
        synthetic data at the production capacities before the stream, so
        its first-call costs (allocator growth, solver handles) do not land
        on the first real candidate."""
        rng = np.random.default_rng(0)
        sub = rng.uniform(-20.0, 20.0, (4096, 3)).astype(np.float32)
        src = sub[:1024] + rng.normal(0.0, 0.02, (1024, 3)).astype(np.float32)
        target = self.register.build_target(
            pcops.from_numpy(sub, self._submap_capacity, self.device),
            torch.zeros(3, dtype=torch.float32, device=self.device))
        self.register.scan2map(
            pcops.from_numpy(src, self._ctx_capacity, self.device), target,
            np.eye(4))
        self.register.get_fitness_score()

    # -- context ingestion (LoopClosureManager.cpp:28-37; call under kf lock) --
    def add_context(self) -> None:
        with tictoc.span("sc_ingest"):
            self._add_context()

    def _add_context(self) -> None:
        kfs = self.kf_obj.keyframes
        new = list(range(self.context.n_contexts, len(kfs)))
        if not new:
            return
        # device-store path: the keyframe clouds already live on the device
        # (row index == keyframe index), downsampled at the map grid — valid
        # when the context grid is that grid
        store = self.map_manager._kf_store
        grid_ok = abs(self.context_ds - self.map_manager.grid_size) < 1e-9
        if (store is not None and grid_ok
                and hasattr(self.context, "add_contexts_from_store")):
            with self.map_manager.kf_store_lock:
                self.context.add_contexts_from_store(
                    self.map_manager._kf_store, new)
            return
        self.context.add_contexts(
            [(native.voxel_downsample_first(kfs[i].xyz, self.context_ds),
              kfs[i].pose) for i in new])

    # -- retrieval overlap ----------------------------------------------------
    def dispatch_queries(self) -> None:
        """Queue the new contexts' retrievals without reading them back; the
        next ``lc_handler_once`` collects them."""
        with tictoc.span("sc_query"):
            new_ids = list(range(self.lc_size, self.n_contexts))
            if new_ids and hasattr(self.context, "query_dispatch"):
                self._pending_queries = (new_ids,
                                         self.context.query_dispatch(new_ids))

    # -- history submap (LoopClosureManager.cpp:40-60; call under kf lock) -----
    def _history_submap(self, key: int) -> np.ndarray:
        kfs = self.kf_obj.keyframes
        sel = [i for i in range(key - self.history_range,
                                key + self.history_range + 1)
               if 0 <= i < len(kfs)]
        merged = native.transform_concat(
            [kfs[i].xyz for i in sel],
            np.stack([kfs[i].pose for i in sel]) if sel else np.zeros((0, 4, 4)))
        return native.voxel_downsample_first(merged, self.context_ds)

    # -- detection pass (LoopClosureManager.cpp:62-119) ------------------------
    def lc_handler_once(self) -> int:
        """Process all new contexts; returns the number of accepted closures."""
        accepted = 0
        new_ids = list(range(self.lc_size, self.n_contexts))
        if not new_ids:
            return 0
        pend, self._pending_queries = self._pending_queries, None
        if pend is not None and pend[0] == new_ids:
            queries = self.context.query_collect(pend[1])
        else:
            queries = self.context.query_many(new_ids)
        self.n_queries += len(new_ids)
        for i, q in zip(new_ids, queries):
            old_key = q.idx
            if old_key < 0:
                continue
            self.n_candidates += 1
            self.lg.info("%d to %d min dist: %.4f", i, old_key, q.min_dist)

            with self.kf_obj.lock:
                kfs = self.kf_obj.keyframes
                old_pose = kfs[old_key].pose.copy()
                cur_pose = kfs[i].pose.copy()
                scan_xyz = kfs[i].xyz
                sel = [k for k in range(old_key - self.history_range,
                                        old_key + self.history_range + 1)
                       if 0 <= k < len(kfs)]
                fprint = np.stack([kfs[k].pose for k in sel]).tobytes()
                cached = self._target_cache.get(old_key)
                submap = (None if cached is not None and cached[0] == fprint
                          else self._history_submap(old_key))

            if submap is None:
                target = cached[1]
            else:
                if len(submap) > self._submap_capacity:
                    self.lg.warn("LC submap truncated: %d > capacity %d",
                                 len(submap), self._submap_capacity)
                target = self.register.build_target(
                    pcops.from_numpy(submap, self._submap_capacity,
                                     self.device),
                    torch.tensor(old_pose[:3, 3].astype(np.float32),
                                 device=self.device))
                if len(self._target_cache) >= self._target_cache_max:
                    self._target_cache.pop(next(iter(self._target_cache)))
                self._target_cache[old_key] = (fprint, target)
            # yaw-hint seeding: rotate the init about z so the relative yaw
            # matches the descriptor alignment for large-angle revisits
            init_pose = cur_pose
            psi_old = np.arctan2(old_pose[1, 0], old_pose[0, 0])
            psi_cur = np.arctan2(cur_pose[1, 0], cur_pose[0, 0])
            dpsi = _wrap_angle(psi_old - q.yaw - psi_cur)
            if abs(dpsi) > YAW_SEED_THRESH:
                c, s = np.cos(dpsi), np.sin(dpsi)
                rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
                init_pose = cur_pose.copy()
                init_pose[:3, :3] = rz @ cur_pose[:3, :3]
                self.lg.info("yaw-hint seed: rotating LC init by %.2f rad",
                             dpsi)

            src = pcops.from_numpy(scan_xyz, self._ctx_capacity, self.device)
            refined, conv = self.register.scan2map(src, target, init_pose)
            fs = self.register.get_fitness_score()
            self.lg.info("%d to %d fitness score: %.4f (conv=%s)",
                         old_key, i, fs, conv)
            self.n_verify_converged += bool(conv)
            if conv and fs < self.fitness_thresh:
                corr = float(np.linalg.norm(refined[:3, 3] - cur_pose[:3, 3]))
                if self.max_correction > 0 and corr > self.max_correction:
                    self.n_rejected_correction += 1
                    self.lg.warn(
                        "rejecting closure %d->%d: implied correction "
                        "%.2f m > %.2f m gate", old_key, i, corr,
                        self.max_correction)
                    continue
                between = np.linalg.inv(old_pose) @ refined
                if len(self.lc_queue) >= self._lc_queue_cap:
                    # drop-oldest overflow loses an accepted factor: count it
                    self.dropped_closures += 1
                    self.lg.error(
                        "LC queue overflow: dropping oldest accepted "
                        "closure (%d dropped so far)", self.dropped_closures)
                self.lc_queue.push_back(LCResult(old_key, i, between),
                                        block=False)
                accepted += 1

        self.lc_size = self.n_contexts
        if accepted:
            self.kf_obj.lc_is_happening()
        return accepted
