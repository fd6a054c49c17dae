"""Backend: keyframe pose-graph optimization + correction broadcast.

Port of ``simpleslam_tpu/models/backend.py`` (reference
``backend/src/Backend.cpp:29-360``) for one device, with the GTSAM iSAM2
pimpl replaced by ``ops/posegraph.py``:

- prior factor on keyframe 0 (``addPrior``, Backend.cpp:85);
- odometry Between factors from the nearest keyframe at insertion time
  (``mClosestKfIdx``, Backend.cpp:240-252), measured from the current
  estimates (``from.between(to)``, :245);
- LC factors drained from the loop-closure queue (:255-268);
- the event-driven pass (``optimHandler``, :270-346): new keyframes add
  contexts, persist clouds and add odometry factors; LC events add loop
  factors; then solve, write back the optimized poses and broadcast the
  rigid correction ``delta = kf_back_new * kf_back_old^-1``;
- g2o save/reload (:125-222) and TUM save on shutdown (:349-358).

The device factor graph is preallocated at bucket sizes (x4 growth up to
``tpu.max_keyframes`` / ``tpu.max_edges``); each event writes only its new
pose and edge rows into it, in place, and the solved poses stay on the
device between events. One host read per solve fetches the packed result.

Noise models (Backend.cpp:90-97; gtsam orders (rot, trans), ours is
(trans, rot)): variances
  prior: rot (1e-2, 1e-2, pi/72), trans (1e-1, 1e-1, 1e-1)
  odom:  rot 1e-4, trans 1e-1      lc: all 1e-1
"""

from __future__ import annotations

import math
import os
import threading
from typing import List, Optional

import numpy as np
import torch

from ..ops import posegraph as pgo
from ..utils import fileio
from ..utils.config import Params
from ..utils.logging import Logger
from .frontend import Frontend
from .mapmanager import KFEvent, MapManager

# diagonal variances in OUR ordering [trans(3), rot(3)]
PRIOR_VAR = np.array([1e-1, 1e-1, 1e-1, 1e-2, 1e-2, math.pi / 72])
ODOM_VAR = np.array([1e-1, 1e-1, 1e-1, 1e-4, 1e-4, 1e-4])
LC_VAR = np.array([1e-1, 1e-1, 1e-1, 1e-1, 1e-1, 1e-1])


def _pack_solve(res: pgo.SolveResult) -> torch.Tensor:
    """The whole solve result in one buffer, for one host read per event."""
    return torch.cat([res.poses.reshape(-1),
                      torch.stack([res.cost0, res.cost,
                                   res.iters.to(res.cost.dtype)])])


class Backend:
    def __init__(self, frontend: Frontend, map_manager: MapManager,
                 lcm=None):
        cfg = Params.get_instance()
        self.lg = Logger.get_instance()
        self.frontend = frontend
        self.map_manager = map_manager
        self.lcm = lcm
        self.kf_obj = map_manager.kf_obj
        self.save_map_dir: str = cfg["saveMapDir"]
        self.device = torch.device(cfg["torch"]["device"])

        tpu = cfg["tpu"]
        if int(tpu.get("mesh_devices", 0)):
            raise NotImplementedError(
                "the sharded pose-graph solve (tpu.mesh_devices > 0) is not "
                "ported to simpleslam_tpu_torch yet (ROADMAP item 12)")
        self.k_cap = int(tpu["max_keyframes"])
        self.e_cap = int(tpu["max_edges"])
        # bucketed device capacities: the padded solve costs O(capacity) per
        # LM iteration, so buckets grow x4 on demand
        self._k_bucket = min(int(tpu.get("kf_bucket", 128)), self.k_cap)
        self._e_bucket = min(int(tpu.get("edge_bucket", 512)), self.e_cap)

        # factor storage (host mirror for g2o persistence)
        self.edge_i: List[int] = []
        self.edge_j: List[int] = []
        self.edge_T: List[np.ndarray] = []
        self.edge_var: List[np.ndarray] = []
        self.n_lc_edges = 0  # accepted loop-closure factors
        self.prior_pose: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        # Odometry-only graphs built in-session are exactly consistent (each
        # between is measured from the poses it constrains; corrections are
        # rigid), so their solve is a provable no-op and is skipped. Loop
        # closures, a reloaded g2o graph and a second edge on an (i, j) pair
        # are the stress sources; once stressed, always stressed.
        self._graph_stressed = False
        self._edge_pairs: set = set()
        self.n_skipped_noop_solves = 0
        self.n_solves = 0  # solves that ran (observability)
        self.n_discarded_solves = 0
        self.n_bucket_growths = 0
        self.last_delta = np.eye(4)
        self.last_kf_count = 0

        # device-resident factor graph: built once per bucket size, then
        # each event writes its new rows in place
        self._g: Optional[pgo.PoseGraph] = None
        self._k_dev = 0  # pose rows synced to the device
        self._e_dev = 0  # edge rows synced to the device

        self._load_factor_graph()

    # -- factor building (Backend.cpp:224-268) -------------------------------
    def _add_between(self, i: int, j: int, T_ij: np.ndarray,
                     var: np.ndarray) -> None:
        if len(self.edge_i) >= self.e_cap:
            self.lg.error("factor graph edge capacity (%d) exceeded, "
                          "dropping edge!", self.e_cap)
            return
        if (i, j) in self._edge_pairs:
            self._graph_stressed = True  # duplicate pair: may disagree
        self._edge_pairs.add((i, j))
        self.edge_i.append(i)
        self.edge_j.append(j)
        self.edge_T.append(T_ij.copy())
        self.edge_var.append(var)

    def add_odom_factor(self) -> None:
        """Called under kf_obj.lock. Factors for keyframes [kf_nums, len)."""
        kfs = self.kf_obj.keyframes
        n = self.kf_obj.kf_nums
        if n == 0 and kfs:
            self.prior_pose = kfs[0].pose.copy()
            n = 1
        cidx = 0
        for i in range(max(n, 1), len(kfs)):
            from_idx = self.kf_obj.closest_kf_idx[cidx]
            cidx += 1
            self.lg.info("factor graph add edge from %d to %d", from_idx, i)
            self._add_between(from_idx, i,
                              np.linalg.inv(kfs[from_idx].pose) @ kfs[i].pose,
                              ODOM_VAR)

    def add_loop_factor(self) -> None:
        if self.lcm is None:
            return
        while True:
            r = self.lcm.lc_queue.consume_front()
            if r is None:
                break
            n0 = len(self.edge_i)
            self._add_between(r.from_idx, r.to_idx, r.between, LC_VAR)
            self.n_lc_edges += len(self.edge_i) - n0
            if len(self.edge_i) > n0:
                self._graph_stressed = True

    # -- the optimization pass (Backend.cpp:270-346) --------------------------
    def optim_once(self, pre_fetch_hook=None) -> bool:
        """One event-driven pass; returns True if a solve ran and moved the
        graph. ``pre_fetch_hook`` runs after the solve is queued and before
        its result is read (the streamed worker queues the loop-closure
        retrievals there)."""
        with self.kf_obj.lock:
            event = self.kf_obj.get_and_reset_event()
            if event == KFEvent.NONE:
                return False
            if event & KFEvent.NEW_KF:
                if self.lcm is not None:
                    self.lcm.add_context()
                self.map_manager.save_kfs()
                self.add_odom_factor()
                self.kf_obj.kf_nums = len(self.kf_obj.keyframes)
                self.kf_obj.closest_kf_idx.clear()
            if event & KFEvent.LC:
                self.lg.info("loop closure comes in backend!")
                self.add_loop_factor()
            kf_poses = [kf.pose.copy() for kf in self.kf_obj.keyframes]

        if not kf_poses or self.prior_pose is None:
            return False
        if not self._graph_stressed:
            # provable no-op (see _graph_stressed): skip the solve, but still
            # fire the hook so the retrieval it queues is not lost
            if pre_fetch_hook is not None:
                pre_fetch_hook()
            self.n_skipped_noop_solves += 1
            self.last_delta = np.eye(4)
            self.last_kf_count = len(kf_poses)
            return False
        opt = self._solve(kf_poses, strong=bool(event & KFEvent.LC),
                          pre_fetch_hook=pre_fetch_hook)

        # no-op solve short-circuit: a consistent graph leaves every pose in
        # place; broadcasting f32 round-trip noise as a "correction" would
        # perturb the pose chain for nothing
        moved = max(
            (float(np.linalg.norm(o[:3, 3] - p[:3, 3]))
             for o, p in zip(opt, kf_poses)), default=0.0)
        if moved < 1e-4:
            self.last_delta = np.eye(4)
            self.last_kf_count = len(kf_poses)
            return False
        # solver sanity: a non-finite or blown-up solve is never written back
        if not all(np.isfinite(o).all() for o in opt) or moved > 1e4:
            self.lg.error("discarding non-finite/blown-up solve "
                          "(max move %.1f m)", moved)
            self.n_discarded_solves += 1
            return False

        with self.kf_obj.lock:
            kfs = self.kf_obj.keyframes
            n = min(len(opt), len(kfs))
            latest_pose = kfs[-1].pose.copy()
            for i in range(n):
                kfs[i].pose = opt[i]
            delta = kfs[-1].pose @ np.linalg.inv(latest_pose)

        # re-orthonormalize (T2SE3 role) on the host
        u, _, vt = np.linalg.svd(delta[:3, :3])
        delta[:3, :3] = u @ vt

        self.frontend.global_odom.replace_all(
            lambda o: type(o)(o.stamp, delta @ o.odom))
        self.frontend.odom2map.store(delta @ self.frontend.odom2map.load())
        # the rigid correction at the solve's last keyframe, for executors
        # holding pose state outside the frontend (the streamed device chain)
        self.last_delta = delta
        self.last_kf_count = n
        return True

    def _solve(self, kf_poses: List[np.ndarray], strong: bool,
               pre_fetch_hook=None) -> List[np.ndarray]:
        k = len(kf_poses)
        with self._lock:
            e = len(self.edge_i)
            g = self._sync_graph(kf_poses)
        # iSAM2-equivalent budget: a few damped GN steps per keyframe event,
        # a stronger re-solve on loop closure (Backend.cpp:301-304)
        res = pgo.solve(g, max_iters=12 if strong else 4, cg_iters=64)
        self.n_solves += 1
        self._g = g._replace(poses=res.poses)  # stays on the device
        packed = _pack_solve(res)
        if pre_fetch_hook is not None:
            pre_fetch_hook()
        packed = packed.cpu().numpy()  # one host read per event
        cost0, cost, n_it = packed[-3], packed[-2], packed[-1]
        self.lg.info("posegraph solve: k=%d e=%d chi2 %.4f -> %.4f (%d iters)",
                     k, e, float(cost0), float(cost), int(n_it))
        opt = packed[:-3].reshape(-1, 4, 4)[:k].astype(np.float64)
        out = []
        for i in range(k):
            T = np.eye(4)
            T[:3, :4] = opt[i][:3, :4]
            out.append(T)
        return out

    def _sync_graph(self, kf_poses: List[np.ndarray]) -> pgo.PoseGraph:
        """The device graph with this event's new pose and edge rows written
        in place (the caller holds ``self._lock``); a bucket growth rebuilds
        it at the larger size."""
        k = len(kf_poses)
        e = len(self.edge_i)
        while k > self._k_bucket:
            self._k_bucket = min(self._k_bucket * 4, self.k_cap)
            self._g = None
            self.n_bucket_growths += 1
        while e > self._e_bucket:
            self._e_bucket = min(self._e_bucket * 4, self.e_cap)
            self._g = None
            self.n_bucket_growths += 1
        if self._g is None:
            self._g = self._build_graph(kf_poses)
            self._k_dev, self._e_dev = k, e
            return self._g
        g, dev = self._g, self.device
        ki, en = self._k_dev, self._e_dev
        if ki < k:
            g.poses[ki:k] = torch.tensor(
                np.asarray(kf_poses[ki:k], np.float32), device=dev)
            g.kf_mask[ki:k] = True
        if en < e:
            g.edge_i[en:e] = torch.tensor(self.edge_i[en:e], device=dev)
            g.edge_j[en:e] = torch.tensor(self.edge_j[en:e], device=dev)
            g.edge_T[en:e] = torch.tensor(
                np.asarray(self.edge_T[en:e], np.float32), device=dev)
            g.edge_info[en:e] = torch.tensor(
                1.0 / np.asarray(self.edge_var[en:e], np.float32), device=dev)
            g.edge_mask[en:e] = True
        self._k_dev, self._e_dev = k, e
        return g

    def _build_graph(self, kf_poses: List[np.ndarray]) -> pgo.PoseGraph:
        k = len(kf_poses)
        kc, ec = self._k_bucket, self._e_bucket
        poses = np.tile(np.eye(4, dtype=np.float32), (kc, 1, 1))
        poses[:k] = np.asarray(kf_poses, np.float32)
        e = len(self.edge_i)
        ei = np.zeros(ec, np.int64)
        ej = np.zeros(ec, np.int64)
        eT = np.tile(np.eye(4, dtype=np.float32), (ec, 1, 1))
        einfo = np.zeros((ec, 6), np.float32)
        if e:
            ei[:e] = self.edge_i
            ej[:e] = self.edge_j
            eT[:e] = np.asarray(self.edge_T, np.float32)
            einfo[:e] = 1.0 / np.asarray(self.edge_var, np.float32)
        dev = self.device
        return pgo.PoseGraph(
            poses=torch.tensor(poses, device=dev),
            kf_mask=torch.tensor(np.arange(kc) < k, device=dev),
            edge_i=torch.tensor(ei, device=dev),
            edge_j=torch.tensor(ej, device=dev),
            edge_T=torch.tensor(eT, device=dev),
            edge_info=torch.tensor(einfo, device=dev),
            edge_mask=torch.tensor(np.arange(ec) < e, device=dev),
            prior_pose=torch.tensor(np.asarray(self.prior_pose, np.float32),
                                    device=dev),
            prior_info=torch.tensor((1.0 / PRIOR_VAR).astype(np.float32),
                                    device=dev),
        )

    # -- persistence (Backend dtor + g2o I/O) ---------------------------------
    def save(self) -> None:
        """TUM + g2o save (Backend.cpp:349-358); also persists keyframe pcds."""
        self.map_manager.save_kfs()
        self.map_manager.save_trajectory()
        if not self.save_map_dir:
            return
        os.makedirs(self.save_map_dir, exist_ok=True)
        with self.kf_obj.lock:
            kf_poses = [kf.pose for kf in self.kf_obj.keyframes]
        with self._lock:
            edges = [
                (i, j, T, np.diag(1.0 / var))
                for i, j, T, var in zip(self.edge_i, self.edge_j,
                                        self.edge_T, self.edge_var)
            ]
        fileio.write_g2o(os.path.join(self.save_map_dir, "fg.g2o"),
                         np.asarray(kf_poses) if kf_poses
                         else np.zeros((0, 4, 4)), edges)

    def _load_factor_graph(self) -> None:
        """g2o reload for remapping (loadFactorGraph, Backend.cpp:105-222)."""
        if not self.save_map_dir:
            return
        path = os.path.join(self.save_map_dir, "fg.g2o")
        if not fileio.is_file(path):
            return
        poses, edges = fileio.load_g2o(path)
        with self.kf_obj.lock:
            nk = len(self.kf_obj.keyframes)
            if len(poses) != nk:
                self.lg.warn("g2o vertices (%d) != reloaded keyframes (%d); "
                             "dropping factor graph", len(poses), nk)
                return
            for i in range(nk):
                self.kf_obj.keyframes[i].pose = poses[i]
            self.kf_obj.kf_nums = nk
        if len(poses):
            self.prior_pose = poses[0].copy()
        for i, j, T, info in edges:
            var = 1.0 / np.clip(np.diag(info), 1e-12, None)
            self._add_between(int(i), int(j), T, var)
        if edges:
            # a reloaded graph's consistency cannot be assumed: always solve
            self._graph_stressed = True
        self.lg.info("reloaded factor graph: %d vertices, %d edges",
                     len(poses), len(edges))

    # -- startup warm-up --------------------------------------------------------
    def prewarm(self) -> None:
        """Run the weak- and strong-event solves once on a dummy graph at the
        current bucket sizes before the stream, so their first-call costs
        (allocator growth, solver library handles) do not land mid-run.
        Touches no graph state."""
        kc, ec = self._k_bucket, self._e_bucket
        dev = self.device
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        g = pgo.PoseGraph(
            poses=eye.repeat(kc, 1, 1),
            kf_mask=torch.arange(kc, device=dev) < 2,
            edge_i=torch.zeros(ec, dtype=torch.int64, device=dev),
            edge_j=(torch.arange(ec, device=dev) < 1).to(torch.int64),
            edge_T=eye.repeat(ec, 1, 1),
            edge_info=torch.ones((ec, 6), dtype=torch.float32, device=dev),
            edge_mask=torch.arange(ec, device=dev) < 1,
            prior_pose=eye,
            prior_info=torch.ones(6, dtype=torch.float32, device=dev))
        for iters in (4, 12):
            _pack_solve(pgo.solve(g, max_iters=iters, cg_iters=64)).cpu()
