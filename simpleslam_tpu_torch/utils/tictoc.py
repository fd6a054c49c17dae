"""Steady-clock stopwatch and the port's span recorder.

Reference: ``common/time/tictoc.hpp:29-62``. ``TicToc`` formats inline as
seconds with ``f"{tt}"``. ``StageTimers.span(name)`` times one stage of a
run: its wall time and count (as ``add`` books them), on request the
calling thread's CPU time over it, and one record whose start is on the
clock ``torch.profiler`` stamps its events with; while a profiler session is
active anywhere in the process it also opens a profiler range of the same
name, so the stage shows on the trace's host timeline beside the work it
launched. On the stage's own path a span only reads its clocks and queues
its record: the sums and the ring are made when they are read.

``span(name)`` (the module function) books into the ``StageTimers`` bound to
the calling thread with ``bound(timers)``: the executors bind their run's
timers on each thread they run on, so code below them (the batch body, the
models) names its stages without a timers argument. Unbound, it does
nothing.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, Optional

import torch.autograd.profiler as _autograd_profiler
# the profiler's light range: a host event only, where
# ``torch.profiler.record_function`` is mirrored onto the device timeline (a
# ``gpu_user_annotation`` over the kernels it launched) that a trace reader
# would count as device work; its entry also costs less
from torch._C._profiler import _RecordFunctionFast as profiler_range

# records kept per run (the newest); older ones are counted in ``dropped``
RING_RECORDS = 65536


class TicToc:
    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def __format__(self, spec: str) -> str:
        return format(self.elapsed(), spec or ".3f")

    def __str__(self) -> str:
        return f"{self.elapsed():.3f}"


def profiler_active() -> bool:
    """True while a ``torch.profiler`` session runs anywhere in the process
    (a module flag the profiler sets on start and clears on stop; the
    autograd ``_profiler_enabled()`` is thread-local and reads False on a
    thread the session did not start on)."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    """One timed stage (see ``StageTimers.span``)."""

    __slots__ = ("timers", "name", "cpu", "start_ns", "t0", "c0", "rf")

    def __init__(self, timers: "StageTimers", name: str, cpu: bool) -> None:
        self.timers = timers
        self.name = name
        self.cpu = cpu

    def __enter__(self) -> "_Span":
        # the profiler's clock; perf_counter moved by one offset a run
        # strays from it by microseconds on a loaded host
        self.start_ns = time.time_ns()
        self.t0 = time.perf_counter_ns()
        self.c0 = time.thread_time_ns() if self.cpu else 0
        self.rf = None
        if profiler_active():
            self.rf = profiler_range(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        # the CPU interval lies inside the wall one: cpu <= wall
        cpu_ns = time.thread_time_ns() - self.c0 if self.cpu else None
        dur_ns = time.perf_counter_ns() - self.t0
        # the record only; the sums are made when they are read, off the
        # stage's own path
        self.timers._queue.append((self.name, threading.current_thread().name,
                                   self.start_ns, dur_ns, cpu_ns))


class StageTimers:
    """Named stage timers of one run.

    ``total`` / ``count`` / ``series``: wall seconds per stage (sum, number,
    every sample); ``cpu``: the booking thread's CPU seconds per stage (spans
    that read it); ``records``: ``(name, thread name, start_ns, dur_ns,
    cpu_ns)`` of the newest ``RING_RECORDS`` spans, ``start_ns`` on
    ``time.time_ns`` (the profiler's clock), ``cpu_ns`` None where the span
    read no CPU time, with ``dropped`` counting the older ones;
    ``counters``: per-event counts that are not times (``tally``). Spans may
    be booked from several threads: a span only appends its record to a
    queue (thread-safe), and the sums and the ring are made from the queue
    under a lock when any of them is read."""

    def __init__(self) -> None:
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)
        # full sample series per stage (a few thousand floats/run): lets
        # long-run benches report trends (e.g. backend_lag first vs last
        # quartile), not just means
        self._series: Dict[str, list] = defaultdict(list)
        self._cpu: Dict[str, float] = defaultdict(float)
        self._records: deque = deque(maxlen=RING_RECORDS)
        self._dropped = 0
        self._queue: deque = deque()
        self.counters: Dict[str, list] = defaultdict(list)
        self._lock = threading.Lock()

    def span(self, name: str, cpu: bool = False) -> _Span:
        """Context manager timing one stage named ``name``; ``cpu=True``
        also books the thread's CPU time over it. That takes two system
        calls, which hold the interpreter's lock: 3.5 us each on an idle
        H100 host, 46 us at the median and up to 6 ms in a drive there,
        against about 2.1 us for a whole span without them. So only the
        spans whose CPU time a metric reads ask for it."""
        return _Span(self, name, cpu)

    def add(self, name: str, seconds: float) -> None:
        """Book a sample that is not a span (e.g. a lag)."""
        with self._lock:
            self._total[name] += seconds
            self._count[name] += 1
            self._series[name].append(seconds)

    def _fold(self) -> None:
        """Move the queued spans into the sums and the ring."""
        with self._lock:
            q = self._queue
            while q:
                rec = q.popleft()
                name, dur_ns, cpu_ns = rec[0], rec[3], rec[4]
                seconds = dur_ns * 1e-9
                self._total[name] += seconds
                self._count[name] += 1
                self._series[name].append(seconds)
                if cpu_ns is not None:
                    self._cpu[name] += cpu_ns * 1e-9
                if len(self._records) == RING_RECORDS:
                    self._dropped += 1
                self._records.append(rec)

    @property
    def total(self) -> Dict[str, float]:
        self._fold()
        return self._total

    @property
    def count(self) -> Dict[str, int]:
        self._fold()
        return self._count

    @property
    def series(self) -> Dict[str, list]:
        self._fold()
        return self._series

    @property
    def cpu(self) -> Dict[str, float]:
        self._fold()
        return self._cpu

    @property
    def records(self) -> deque:
        self._fold()
        return self._records

    @property
    def dropped(self) -> int:
        self._fold()
        return self._dropped

    def tally(self, name: str, values) -> None:
        """Append per-event counts (e.g. each registration's iterations)."""
        with self._lock:
            self.counters[name].extend(float(v) for v in values)

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


_bound = threading.local()
_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def bound(timers: Optional[StageTimers]) -> Iterator[None]:
    """Bind ``timers`` to the calling thread for ``span`` (the previous
    binding comes back on exit)."""
    prev = getattr(_bound, "timers", None)
    _bound.timers = timers
    try:
        yield
    finally:
        _bound.timers = prev


def span(name: str, cpu: bool = False):
    """``StageTimers.span(name, cpu)`` on the timers bound to the calling
    thread; a no-op on a thread with none."""
    timers = getattr(_bound, "timers", None)
    return _NO_SPAN if timers is None else _Span(timers, name, cpu)

