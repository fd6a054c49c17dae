"""Place-recognition context plugin API (reference ContextBase family).

Port of ``simpleslam_tpu/models/context.py``: the plugin interface of
``backend/include/backend/ContextBase.hpp:19-39`` (``add_context``,
``query``, save/load hooks) and its two plugins:

- **ScanContext** (``backend/src/ScanContext.cpp:56-278``): a fixed-capacity
  device database of descriptors; the tensor math is ``ops/scancontext.py``.
  Descriptors are written into their rows in place.
- **DistContext** (``backend/src/DistContext.cpp:14-31``, completed): the
  nearest past keyframe within ``distThres`` metres in the xy-plane.

Plugins are selected by ``backend.context.used`` in the config.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..ops import pointcloud as pcops
from ..ops import scancontext as sc
from ..utils.config import Params
from ..utils.logging import Logger


class QueryResult(NamedTuple):
    """Matched context id (or -1) + yaw alignment hint (ContextBase.hpp:24-27)."""

    idx: int
    yaw: float
    min_dist: float


class ContextBase:
    """Descriptor plugin API (ContextBase.hpp:19-39).

    ``add_context`` ingests one keyframe source (xyz cloud + pose);
    ``query(id)`` matches context ``id`` against strictly older contexts.
    """

    def __init__(self) -> None:
        self.n_contexts = 0

    def add_context(self, xyz: np.ndarray, pose: np.ndarray) -> None:
        raise NotImplementedError

    def query(self, qid: int) -> QueryResult:
        raise NotImplementedError

    # batched forms; device-database plugins override them
    def add_contexts(self, items) -> None:
        for xyz, pose in items:
            self.add_context(xyz, pose)

    def query_many(self, qids) -> List[QueryResult]:
        return [self.query(q) for q in qids]

    # persistence hooks (stubs in the reference too, ContextBase.hpp:35-38)
    def save_context(self, path: str) -> None:
        pass

    def load_context(self, path: str) -> None:
        pass


class ScanContext(ContextBase):
    """Fixed-capacity device database of ScanContext descriptors."""

    def __init__(self) -> None:
        super().__init__()
        cfg = Params.get_instance()
        sc_cfg = cfg["backend"]["context"]["scancontext"]
        self.lg = Logger.get_instance()
        self.num_exclude_recent = int(sc_cfg["numExcludeRecent"])
        self.num_candidates = int(sc_cfg["numCandidatesFromTree"])
        self.dist_thres = float(sc_cfg["scDistThres"])
        self.lidar_height = float(cfg["tf"]["lidar_height"])
        self._cap = int(cfg["tpu"]["max_keyframes"])
        self._pc_capacity = int(cfg["tpu"]["ds_scan_capacity"])
        self.device = torch.device(cfg["torch"]["device"])
        self.descs = torch.zeros((self._cap, sc.NUM_RING, sc.NUM_SECTOR),
                                 dtype=torch.float32, device=self.device)
        self.ring_keys = torch.zeros((self._cap, sc.NUM_RING),
                                     dtype=torch.float32, device=self.device)

    def _ingest(self, xyz: torch.Tensor, mask: torch.Tensor) -> bool:
        if self.n_contexts >= self._cap:
            self.lg.error("context capacity (%d) exceeded!", self._cap)
            return False
        d = sc.make_descriptor(xyz, mask, self.lidar_height)
        self.descs[self.n_contexts] = d
        self.ring_keys[self.n_contexts] = sc.ring_key(d)
        self.n_contexts += 1
        return True

    def add_context(self, xyz: np.ndarray, pose: np.ndarray) -> None:
        pc = pcops.from_numpy(xyz, self._pc_capacity, self.device)
        self._ingest(pc.xyz, pc.mask)

    def add_contexts_from_store(self, store: torch.Tensor, kf_indices) -> None:
        """Device-side ingest from the resident keyframe store (row index ==
        keyframe index): no cloud upload. The caller holds the store lock."""
        for kf_i in kf_indices:
            xyz = store[kf_i]
            if not self._ingest(xyz, xyz[:, 0] < 0.5 * pcops.PAD_COORD):
                break

    def query(self, qid: int) -> QueryResult:
        return self.query_many([qid])[0]

    def query_dispatch(self, qids) -> torch.Tensor:
        """Queue the retrievals of ``qids`` without a host read: a (n, 3)
        device tensor [idx, yaw, min_dist] for ``query_collect``."""
        rows = []
        for q in qids:
            r = sc.query(self.descs, self.ring_keys, int(q),
                         self.num_exclude_recent, self.dist_thres,
                         num_candidates=self.num_candidates)
            rows.append(torch.stack([r.idx.to(torch.float32), r.yaw,
                                     r.min_dist]))
        if not rows:
            return torch.zeros((0, 3), dtype=torch.float32, device=self.device)
        return torch.stack(rows)

    @staticmethod
    def query_collect(pend: torch.Tensor) -> List[QueryResult]:
        packed = pend.cpu().numpy()  # one host read for the whole batch
        return [QueryResult(int(p[0]), float(p[1]), float(p[2]))
                for p in packed]

    def query_many(self, qids) -> List[QueryResult]:
        return self.query_collect(self.query_dispatch(qids))

    @staticmethod
    def _npy_path(path: str) -> str:
        # np.save appends '.npy' to bare paths but np.load does not
        return path if path.endswith(".npy") else path + ".npy"

    def save_context(self, path: str) -> None:
        np.save(self._npy_path(path),
                self.descs[: self.n_contexts].cpu().numpy())

    def load_context(self, path: str) -> None:
        arr = np.load(self._npy_path(path))
        n = min(len(arr), self._cap)
        d = torch.from_numpy(np.asarray(arr[:n], np.float32)).to(self.device)
        self.descs[:n] = d
        self.ring_keys[:n] = sc.ring_key(d)
        self.n_contexts = n


class DistContext(ContextBase):
    """2D-translation-distance context (DistContext.cpp:14-31, completed):
    nearest past keyframe within ``distThres`` m in the xy-plane, skipping
    the ``numExcludeRecent`` newest. No yaw hint (0.0)."""

    def __init__(self, dist_thres: float = 5.0,
                 num_exclude_recent: Optional[int] = None) -> None:
        super().__init__()
        cfg = Params.get_instance()
        sc_cfg = cfg["backend"]["context"]["scancontext"]
        self.dist_thres = float(
            cfg["backend"]["context"].get("distcontext", {}).get(
                "distThres", dist_thres))
        self.num_exclude_recent = (
            num_exclude_recent if num_exclude_recent is not None
            else int(sc_cfg["numExcludeRecent"]))
        self._xy: list = []

    def add_context(self, xyz: np.ndarray, pose: np.ndarray) -> None:
        self._xy.append(np.asarray(pose[:2, 3], np.float64))
        self.n_contexts = len(self._xy)

    def query(self, qid: int) -> QueryResult:
        allowed = qid - self.num_exclude_recent
        if allowed <= 0:
            return QueryResult(-1, 0.0, float("inf"))
        past = np.stack(self._xy[:allowed])
        d = np.linalg.norm(past - self._xy[qid][None, :], axis=1)
        best = int(np.argmin(d))
        if d[best] < self.dist_thres:
            return QueryResult(best, 0.0, float(d[best]))
        return QueryResult(-1, 0.0, float(d[best]))


def make_context(kind: Optional[str] = None) -> ContextBase:
    """Config-driven plugin factory (``backend.context.used``)."""
    if kind is None:
        kind = Params.get_instance()["backend"]["context"].get(
            "used", "scancontext")
    if kind == "scancontext":
        return ScanContext()
    if kind == "distcontext":
        return DistContext()
    raise ValueError(f"unknown context plugin: {kind}")
