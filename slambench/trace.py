"""One ``torch.profiler`` session over one drive, reduced to what the
per-layer readers need: the device's busy time (the union of its
operations' intervals), K3's launches and device time, the kernel launches,
the device operations that took most time, and the idle gaps by the host
operation that was running in them.

A session counts only when the K3 launches it saw equal the launches the
program counted over it (``loam_kernels.K3_LAUNCHES``): the profiler on the
card can lose device events as a process ages, and a window that lost some
would read as idle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

K3_KERNEL = "gn_loop_kernel"


def short_name(name: str) -> str:
    """A kernel's function name without namespace, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.split("<")[0].split()[-1] if name.strip() else "?"


@dataclass
class Session:
    window_s: float
    k3_counted: int                  # the program's count over the session
    k3_seen: int = 0                 # K3 launches in the trace
    k3_s: float = 0.0                # K3's device time
    kernels: int = 0                 # kernel launches (copies and fills apart)
    busy_s: float = 0.0
    ops: Dict[str, float] = field(default_factory=dict)
    gaps: Dict[str, float] = field(default_factory=dict)

    @property
    def accepted(self) -> bool:
        return self.k3_seen == self.k3_counted and self.busy_s > 0


def _events(prof):
    """(name, is_device, start_s, end_s) of every event of the session."""
    out = []
    try:
        evs = prof.profiler.kineto_results.events()
        for e in evs:
            dev = "cuda" in str(e.device_type()).lower()
            if hasattr(e, "start_ns"):
                a, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                a, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
            out.append((e.name(), dev, a, a + d))
        return out
    except AttributeError:
        pass
    from torch.autograd import DeviceType
    for e in prof.events():
        out.append((e.name, e.device_type == DeviceType.CUDA,
                    e.time_range.start * 1e-6, e.time_range.end * 1e-6))
    return out


def reduce(events, window_s: float, k3_counted: int) -> Session:
    """The session's figures from its events."""
    s = Session(window_s, k3_counted)
    dev = sorted((a, b, n) for n, d, a, b in events if d and b > a)
    host = sorted((a, b, n) for n, d, a, b in events if not d and b > a)
    ops = defaultdict(float)
    for a, b, n in dev:
        low = n.lower()
        sn = short_name(n) if not low.startswith(("memcpy", "memset")) else n
        ops[sn] += b - a
        if not low.startswith(("memcpy", "memset")):
            s.kernels += 1
        if sn == K3_KERNEL:
            s.k3_seen += 1
            s.k3_s += b - a
    merged = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    s.busy_s = sum(b - a for a, b in merged)
    starts = [a for a, _, _ in host]
    gaps = defaultdict(float)
    for (_, b0), (a1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (b0 + a1)
        what = "host outside any op"
        k = bisect.bisect_right(starts, mid) - 1
        for j in range(k, max(k - 64, -1), -1):
            if host[j][1] >= mid:
                what = host[j][2]
                break
        gaps[what] += a1 - b0
    s.ops = dict(ops)
    s.gaps = dict(gaps)
    return s


def profile(fn, k3_count):
    """``fn()`` under one profiler session: (its result, the Session).
    ``k3_count()`` reads the program's K3 launch counter."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    k0 = k3_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return out, reduce(_events(prof), window, k3_count() - k0)


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
