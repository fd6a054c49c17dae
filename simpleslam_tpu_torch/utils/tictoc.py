"""Steady-clock stopwatch for stage-boundary tracing.

Reference: ``common/time/tictoc.hpp:29-62``. Formats inline as seconds with
``f"{tt}"``; also powers the per-stage timing report in the replay harness.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict


class TicToc:
    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def toc(self) -> float:
        """Elapsed seconds, and restart."""
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        return dt

    def __format__(self, spec: str) -> str:
        return format(self.elapsed(), spec or ".3f")

    def __str__(self) -> str:
        return f"{self.elapsed():.3f}"


class StageTimers:
    """Accumulating named stage timers (sum / count / mean) for pipeline profiling."""

    def __init__(self) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        # full sample series per stage (a few thousand floats/run): lets
        # long-run benches report trends (e.g. backend_lag first vs last
        # quartile), not just means
        self.series: Dict[str, list] = defaultdict(list)

    def add(self, name: str, seconds: float) -> None:
        self.total[name] += seconds
        self.count[name] += 1
        self.series[name].append(seconds)

    def mean(self, name: str) -> float:
        c = self.count[name]
        return self.total[name] / c if c else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self.total):
            lines.append(
                f"{name:24s} total={self.total[name]:8.3f}s "
                f"n={self.count[name]:6d} mean={self.mean(name)*1e3:8.3f}ms"
            )
        return "\n".join(lines)
