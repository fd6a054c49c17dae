"""Find the phase of a whole ``chip_smoke.py`` run after which torch.profiler
stops seeing the card's kernels.

    python3 tools/profiler_bisect.py [chip_smoke.py arguments]
    python3 tools/profiler_bisect.py --age SECONDS [--every S] [--busy]

Runs ``chip_smoke.main()`` in this process as it is, with a probe before
every phase and once more at the end. A probe profiles calls of one K3
launch on the entry hook's sorted-table fixture
(``simpleslam_tpu_torch.entry``), a launch that no path counts (it
restores the launch counters and calls the wrapper beneath
``loam.gn_loop``): through ``chip_smoke.call_device`` as the run measures,
then in one session each with 0, 0.01, 0.1 and 1 s of idle time before the
first call and after the last inside the profiler's window. Each probe
prints one line: whether each saw the K3 launches, the host-to-device lag
from a launch call to its kernel as the profiler's timeline places them,
CUDA events around the same call, the profiler sessions the run has
started so far, the live threads, the sync debug mode and whether a
profiler is still enabled. With ``--age`` no path runs: the probe comes
every ``--every`` seconds (20) in a process that does nothing else, the
card idle in between or, with ``--busy``, running K3 back to back: does
the profiler fail with the process's age or with its work? The last line
is a JSON summary: the first
phase after which ``call_device`` saw no K3, and how many probes saw none
at each idle time. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

COUNTERS = ("K1_LAUNCHES", "K2_LAUNCHES", "K3_LAUNCHES", "K4_LAUNCHES",
            "K1_PLAIN_CUDA_CALLS", "K2_PLAIN_CUDA_CALLS",
            "K3_PLAIN_CUDA_CALLS", "K4_PLAIN_CUDA_CALLS")
SESSIONS = [0]
PROBES = []


def count_sessions() -> None:
    """Count every ``torch.profiler.profile`` session the run starts."""
    from torch.profiler import profile

    start = profile.start

    def counted(self, *a, **k):
        SESSIONS[0] += 1
        return start(self, *a, **k)

    profile.start = counted


# idle time (s) before the first call and after the last, inside the window
PADS_S = (0.0, 0.01, 0.1, 1.0)


class Probe:
    """One K3 launch on the entry hook's table fixture, uncounted."""

    def __init__(self):
        from simpleslam_tpu_torch import entry
        from simpleslam_tpu_torch.ops import loam
        from simpleslam_tpu_torch.ops import loam_kernels as lk

        self.lk = lk
        _, (src, vm, init) = entry.entry(device="cuda")
        self.call = lambda: lk.gn_loop_fused(src.xyz, src.mask, vm, init,
                                             loam.MAX_ITERS, 0.0)

    def session(self, pad: float, calls: int = 5):
        """One profiler session of ``calls`` calls with ``pad`` seconds of
        idle time before the first and after the last: (K3 events seen,
        median us from a launch call on the host to its kernel's start on
        the device, as the profiler's timeline places them)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(calls):
                self.call()
            torch.cuda.synchronize()
            time.sleep(pad)
        evs = prof.events()
        k3 = sorted(e.time_range.start for e in evs
                    if e.device_type == DeviceType.CUDA
                    and "gn_loop_kernel" in e.name)
        host = sorted(e.time_range.start for e in evs
                      if e.device_type == DeviceType.CPU
                      and "LaunchCooperativeKernel" in e.name)
        lag = (statistics.median(k - h for k, h in zip(k3, host))
               if k3 and len(k3) == len(host) else None)
        return len(k3), lag

    def __call__(self, after: str) -> None:
        saved = {k: getattr(self.lk, k) for k in COUNTERS}
        sessions = SESSIONS[0]
        try:
            t = cs.call_device(self.call, calls=5)
            ev = cs.events_ms(self.call, 10)
            pads = {pad: self.session(pad) for pad in PADS_S}
        finally:
            for k, v in saved.items():
                setattr(self.lk, k, v)
        hits = [v for k, v in (t.by_kernel.items() if t else ())
                if "gn_loop_kernel" in k]
        seen = bool(hits)
        rec = {"after": after, "k3_seen": seen,
               "k3_launches_per_call": hits[0][0] if seen else 0,
               "k3_device_us": 1e3 * hits[0][1] if seen else None,
               "events_us_per_call": 1e3 * ev,
               "sessions_before": sessions,
               "threads": threading.active_count(),
               "sync_debug_mode": torch.cuda.get_sync_debug_mode(),
               "profiler_enabled": torch._C._autograd._profiler_enabled(),
               "padded": {str(p): v for p, v in pads.items()}}
        PROBES.append(rec)
        print(f"PROBE after {after!r}: call_device "
              + (f"saw K3 {rec['k3_launches_per_call']} x per call, "
                 f"{rec['k3_device_us']:.2f} us" if seen
                 else "saw NO K3 launch")
              + f"; CUDA events {rec['events_us_per_call']:.2f} us per call; "
              + "; ".join(f"pad {p} s: K3 {n}/5" + (
                  "" if lag is None else f", launch to kernel {lag:.1f} us")
                  for p, (n, lag) in pads.items())
              + f"; sessions so far {sessions}; threads {rec['threads']}; "
              f"sync debug mode {rec['sync_debug_mode']}; profiler enabled "
              f"{rec['profiler_enabled']}", flush=True)


def age(seconds: float, every: float, busy: bool) -> None:
    """No path at all: a probe every ``every`` seconds for ``seconds``, the
    card idle in between, or with ``busy`` K3 launched back to back."""
    cs.environment()
    cs.build()
    probe = Probe()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        probe(f"{time.perf_counter() - t0:.0f} s of "
              + ("back-to-back K3" if busy else "idle time"))
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < every:
            if busy:
                for _ in range(100):
                    probe.call()
                torch.cuda.synchronize()
            else:
                time.sleep(0.5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--age", type=float, default=0.0, metavar="SECONDS",
                    help="run no path: probe a process this old")
    ap.add_argument("--every", type=float, default=20.0, metavar="SECONDS")
    ap.add_argument("--busy", action="store_true",
                    help="with --age: K3 back to back between probes")
    args, rest = ap.parse_known_args()
    count_sessions()
    t0 = time.perf_counter()
    rc = 0
    if args.age:
        age(args.age, args.every, args.busy)
    else:
        rc = whole_run(rest)
    first = next((p["after"] for p in PROBES if not p["k3_seen"]), None)
    print(json.dumps({
        "chip_smoke_rc": rc, "seconds": time.perf_counter() - t0,
        "probes": len(PROBES), "profiler_sessions": SESSIONS[0],
        "first_empty_after": first,
        "call_device_empty": sum(not p["k3_seen"] for p in PROBES),
        "empty_by_pad_s": {str(pad): sum(p["padded"][str(pad)][0] == 0
                                         for p in PROBES)
                           for pad in PADS_S}}))
    return 0


def whole_run(argv) -> int:
    """``chip_smoke.main()`` with ``argv``, a probe before every phase and
    one after the last; its exit code."""
    state = {"probe": None, "last": "start"}
    phase = cs.phase

    def probing_phase(name: str) -> None:
        if state["probe"] is None and state["last"] not in ("start",
                                                            "environment"):
            state["probe"] = Probe()
        if state["probe"] is not None:
            state["probe"](state["last"])
        state["last"] = name
        phase(name)

    cs.phase = probing_phase
    sys.argv = [os.path.join(ROOT, "chip_smoke.py")] + list(argv)
    try:
        rc = cs.main()
    except SystemExit as e:
        rc = e.code
    if state["probe"] is not None:
        state["probe"](state["last"] + " (and the rest of the run)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
