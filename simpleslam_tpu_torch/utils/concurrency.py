"""Concurrency primitives: bounded MPMC deque, resident threads, atomic vars.

These are the host-side pipeline glue of the framework — the same roles as
the reference's ``common/utils/SafeDeque.hpp:14-217`` (bounded deque with
blocking vs drop-oldest backpressure and ``abort()``),
``common/utils/Thread.hpp:13-61`` (loop-forever worker with stop/resume), and
``common/utils/Atomic.hpp:7-30`` (mutex-guarded load/store). Device compute
stays in jitted JAX functions; these primitives only move Python object
handles (host arrays / metadata) between pipeline stages.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, Generic, List, Optional, TypeVar

T = TypeVar("T")


class SafeDeque(Generic[T]):
    """Bounded MPMC deque.

    ``push_back(x, block=True)`` blocks while full (offline-replay
    backpressure — what paces bag replay to compute speed in the reference,
    ``dataproxy/src/LidarDataProxy.cpp:45-49``); ``block=False`` drops the
    oldest element instead (live mode). ``abort()`` wakes all blocked
    producers/consumers and poisons the queue.
    """

    def __init__(self, capacity: int = 0):
        self._capacity = capacity  # 0 => unbounded
        self._dq: Deque[T] = deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._aborted = False

    def push_back(self, item: T, block: bool = True, timeout: Optional[float] = None) -> bool:
        with self._lock:
            if self._capacity > 0:
                if block:
                    ok = self._not_full.wait_for(
                        lambda: len(self._dq) < self._capacity or self._aborted,
                        timeout=timeout,
                    )
                    if not ok or self._aborted:
                        return False
                elif len(self._dq) >= self._capacity:
                    self._dq.popleft()  # drop-oldest
            if self._aborted:
                return False
            self._dq.append(item)
            self._not_empty.notify()
            return True

    def consume_front(self, block: bool = False, timeout: Optional[float] = None) -> Optional[T]:
        with self._lock:
            if block:
                ok = self._not_empty.wait_for(
                    lambda: len(self._dq) > 0 or self._aborted, timeout=timeout
                )
                if not ok:
                    return None
            if self._aborted and not self._dq:
                return None
            if not self._dq:
                return None
            item = self._dq.popleft()
            self._not_full.notify()
            return item

    def consume_back(self) -> Optional[T]:
        with self._lock:
            if not self._dq:
                return None
            item = self._dq.pop()
            self._not_full.notify()
            return item

    def back(self) -> Optional[T]:
        with self._lock:
            return self._dq[-1] if self._dq else None

    def front(self) -> Optional[T]:
        with self._lock:
            return self._dq[0] if self._dq else None

    def clear(self) -> None:
        with self._lock:
            self._dq.clear()
            self._not_full.notify_all()

    def abort(self) -> None:
        with self._lock:
            self._aborted = True
            self._not_full.notify_all()
            self._not_empty.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def empty(self) -> bool:
        return len(self) == 0

    def snapshot(self) -> List[T]:
        """Locked copy of contents (replaces the reference's escape-hatch
        getLock()/getDequeInThreadUnsafeWay())."""
        with self._lock:
            return list(self._dq)

    def replace_all(self, fn: Callable[[T], T]) -> None:
        """Apply ``fn`` to every element under the lock (the backend's
        correction broadcast over the GlobalOdom deque, Backend.cpp:333-342)."""
        with self._lock:
            self._dq = deque(fn(x) for x in self._dq)

    def prune_front(self, pred: Callable[[T], bool]) -> None:
        """Pop from the front while ``pred`` holds (consumed-entry pruning)."""
        with self._lock:
            while self._dq and pred(self._dq[0]):
                self._dq.popleft()
            self._not_full.notify_all()


class ResidentThread:
    """Loop-forever worker calling ``fn()`` until stopped (Thread.hpp:13-61).

    ``fn`` is invoked repeatedly; it should block internally on its own
    condition (queue/event) and return promptly once per wakeup.
    """

    def __init__(self, fn: Callable[[], None], name: str = "resident"):
        self._fn = fn
        self._stop = threading.Event()
        self._pause = threading.Event()  # set => paused
        self._resume_cv = threading.Condition()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._pause.is_set():
                with self._resume_cv:
                    self._resume_cv.wait(timeout=0.1)
                continue
            self._fn()

    def stop(self) -> None:
        self._stop.set()
        with self._resume_cv:
            self._resume_cv.notify_all()

    Stop = stop

    def pause(self) -> None:
        self._pause.set()

    def resume(self) -> None:
        self._pause.clear()
        with self._resume_cv:
            self._resume_cv.notify_all()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout=timeout)

    def is_alive(self) -> bool:
        return self._thread.is_alive()


class AtomicVar(Generic[T]):
    """Mutex-guarded load/store (Atomic.hpp:7-30); used for the odom->map pose."""

    def __init__(self, value: T):
        self._lock = threading.Lock()
        self._value = value

    def load(self) -> T:
        with self._lock:
            return self._value

    def store(self, value: T) -> None:
        with self._lock:
            self._value = value
