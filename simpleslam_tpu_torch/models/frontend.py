"""Frontend state hub: odometry deques + odom->map transform.

Reference: ``frontend/include/frontend/Frontend.hpp:18-75`` and
``frontend/src/Frontend.cpp:6-58`` — two odometry deques (LocalOdom from the
EKF at wheel rate, GlobalOdom from scan matching) and the loose-coupling
transform ``odom2map`` with the update scheme
``T^m_o = T^m_b (T^o_b)^-1`` / prediction ``T^m_b = T^m_o T^o_b``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..utils.concurrency import AtomicVar, SafeDeque
from ..utils.config import Params
from ..utils.logging import Logger


@dataclass
class Odometry:
    stamp: float
    odom: np.ndarray  # (4, 4)


class Frontend:
    def __init__(self, local_deque: Optional[SafeDeque] = None):
        cfg = Params.get_instance()["frontend"]
        self.lg = Logger.get_instance()
        # lio mode shares the EKF proxy's deque; lo mode owns an (empty) one.
        # NB: must be an identity check — SafeDeque has __len__, so an empty
        # shared deque is falsy and `or` would silently disconnect it.
        self.local_odom: SafeDeque = (
            local_deque if local_deque is not None else SafeDeque(int(cfg["local_size"]))
        )
        self.global_odom: SafeDeque = SafeDeque(int(cfg["global_size"]))
        self.odom2map = AtomicVar(np.eye(4))
        self._odom2map_init = False

    def is_init_odom2map(self) -> bool:
        return self._odom2map_init

    def set_init_odom2map(self) -> None:
        self._odom2map_init = True

    def get_closest_local_odom(self, stamp: float, retries: int = 4,
                               wait_s: float = 0.005) -> Optional[Odometry]:
        """Lower-bound by stamp with bounded retry, pruning consumed entries
        (Frontend.cpp:25-52). Returns None when no bracketing entry exists.
        """
        for attempt in range(retries):
            items: List[Odometry] = self.local_odom.snapshot()
            if items:
                stamps = [o.stamp for o in items]
                idx = _lower_bound(stamps, stamp)
                if idx < len(items):
                    chosen = items[idx]
                    if idx > 0 and abs(items[idx - 1].stamp - stamp) < abs(chosen.stamp - stamp):
                        chosen = items[idx - 1]
                    # prune everything strictly older than the chosen entry
                    self.local_odom.prune_front(lambda o: o.stamp < chosen.stamp)
                    return chosen
            if attempt + 1 < retries:
                time.sleep(wait_s)
        return None

    @staticmethod
    def get_closest_item(items: List[Odometry], stamp: float) -> int:
        """Nearest-stamp scan (Frontend.hpp getClosestItem). -1 if empty."""
        if not items:
            return -1
        diffs = [abs(o.stamp - stamp) for o in items]
        return int(np.argmin(diffs))


def _lower_bound(stamps: List[float], stamp: float) -> int:
    lo, hi = 0, len(stamps)
    while lo < hi:
        mid = (lo + hi) // 2
        if stamps[mid] < stamp:
            lo = mid + 1
        else:
            hi = mid
    return lo
