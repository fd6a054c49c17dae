"""Visualization egress: named point-cloud/trajectory export, never blocking.

The reference's ``Vis`` (``dataproxy/src/Vis.cpp:13-107``) is a registry of
named ROS point-cloud publishers drained by a dedicated thread behind a
try-lock so visualization can never stall the compute path (:61-70). With no
ROS here, the sinks are files (PLY point clouds, TUM trajectories) or a user
callback (e.g. rerun/open3d feeds) — same contract: ``publish_pc`` is a
try-lock handoff that drops the frame if the vis worker is busy.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..utils.concurrency import ResidentThread
from ..utils.config import Params
from ..utils.logging import Logger

Sink = Callable[[str, np.ndarray, Optional[np.ndarray]], None]


def write_ply(path: str, xyz: np.ndarray) -> None:
    """Minimal binary-little-endian PLY writer (xyz float32)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(xyz)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(xyz.tobytes())


class Vis:
    """Named publisher registry + dedicated drain thread (Vis.cpp role)."""

    def __init__(self, out_dir: Optional[str] = None, sink: Optional[Sink] = None):
        cfg = Params.get_instance()
        self.lg = Logger.get_instance()
        self.enabled = bool(cfg["vis"].get("enable", False)) or sink is not None \
            or out_dir is not None
        self.out_dir = out_dir
        self._sink = sink
        self._topics: Dict[str, int] = {}
        self._pending: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._thread: Optional[ResidentThread] = None
        if self.enabled:
            if self.out_dir:
                os.makedirs(self.out_dir, exist_ok=True)
            self._thread = ResidentThread(self._drain, name="vis")

    def register_pc_pub(self, name: str) -> None:
        with self._lock:
            self._topics.setdefault(name, 0)

    def publish_pc(self, name: str, xyz: np.ndarray,
                   pose: Optional[np.ndarray] = None) -> bool:
        """Non-blocking handoff: drops the frame if the worker holds the lock
        (notifyPC try-lock semantics, Vis.cpp:61-70). Returns False on drop."""
        if not self.enabled:
            return False
        acquired = self._lock.acquire(blocking=False)
        if not acquired:
            return False
        try:
            if name not in self._topics:
                self._topics[name] = 0
            self._pending[name] = (np.asarray(xyz), pose)
            self._cv.notify()
            return True
        finally:
            self._lock.release()

    def _drain(self) -> None:
        with self._lock:
            if not self._pending:
                self._cv.wait(timeout=0.1)
            items = list(self._pending.items())
            self._pending.clear()
            for name, _ in items:
                self._topics[name] += 1
            counters = {name: self._topics[name] for name, _ in items}
        for name, (xyz, pose) in items:
            if pose is not None:
                R, t = pose[:3, :3].astype(np.float32), pose[:3, 3].astype(np.float32)
                xyz = xyz @ R.T + t
            if self._sink is not None:
                self._sink(name, xyz, pose)
            if self.out_dir:
                write_ply(os.path.join(
                    self.out_dir, f"{name}_{counters[name]:05d}.ply"), xyz)

    def close(self) -> None:
        if self._thread is not None:
            self._drain()  # final flush
            self._thread.stop()
            self._thread.join(timeout=2.0)
