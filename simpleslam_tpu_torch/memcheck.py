"""Long-run runtime sanity of the streamed executor on the GPU.

The reference project pairs a valgrind leak check with a bounded-run app
mode (``memcheck.sh:13-14``, ``app/main.cpp:143-150``). For this runtime the
equivalent failure modes are:

- **rebuilds**: a kernel library or host helper compiled again mid-run (each
  build is seconds; the steady state must add none);
- **a kernel that quietly gives way**: a registration that went through a
  plain PyTorch version instead of its CUDA kernel;
- **host memory growth**: Python-side bookkeeping that accumulates per scan
  beyond the expected keyframe store;
- **device memory growth**: tensors kept alive per scan instead of being
  replaced (the keyframe store and the two map buffers are preallocated, so
  allocated bytes and live allocations must plateau).

One long sequence is mapped through ``run_streamed`` in segments with one
``SlamSystem``; after each segment the harness records host RSS, the CUDA
allocator's allocated and reserved bytes, its live allocations and its
segment allocations (``cudaMalloc`` calls), compiler runs
(``ops/_build.BUILDS``) and the kernel counters against the registrations.
Memory is compared between segment 1 and the last one: segment 0 pays the
first-use allocations, and a map rebuild may still step the reserved pool
once. On the CPU only the host-side checks run.

Usage: python -m simpleslam_tpu_torch.memcheck [n_segments]
           [scans_per_segment] [--out FILE] [--device cpu]
Prints one JSON line (and writes it to --out); exit code 0 iff all checks
pass.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Optional

# host RSS may grow by this much between segment 1 and the last, plus one
# target-map footprint (the allocator's high-water mark across rebuilds)
RSS_NOISE_MB = 80.0
# device bytes allocated may differ by one map buffer (a rebuilt target that
# waits for its swap) plus this much; live allocations by this many handles
DEVICE_NOISE_MB = 32.0
DEVICE_ALLOCATIONS_NOISE = 64


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


def run_memcheck(n_segments: int = 4, scans_per_segment: int = 48,
                 seed: int = 0, device: Optional[str] = None,
                 streams=None) -> dict:
    """Map ``n_segments * scans_per_segment`` scans in segments and check
    the steady state (see the module docstring). ``device`` overrides the
    config's ``torch.device``; ``streams`` replaces the sequence simulated
    from ``seed`` (it must hold that many scans)."""
    import torch

    from .ops import _build
    from .ops import loam_kernels as lk
    from .pipeline import app, simulate as sim
    from .pipeline.streamed import run_streamed
    from .utils.config import Params
    from .utils.logging import Logger

    if n_segments < 2:
        raise ValueError("memcheck compares segment 1 with the last one: "
                         "it needs at least 2 segments")
    Logger.get_instance().set_level(logging.ERROR)
    cfg = {"mode": "lo",
           "backend": {"enable": True, "lc": {"enable": False}},
           "frontend": {"pcr": "loam"}}
    if device is not None:
        cfg["torch"] = {"device": device}
    Params.load(cfg)

    n = n_segments * scans_per_segment
    if streams is None:
        streams = sim.simulate_sequence(sim.make_world(seed=seed), n_scans=n,
                                        seed=seed)
    elif len(streams.scans) < n:
        raise ValueError(f"{len(streams.scans)} scans given, {n} needed")

    def segment(lo, hi):
        sl = slice(lo, hi)
        return sim.SensorStreams(
            streams.scan_stamps[sl], streams.scans[sl], streams.gt_poses[sl],
            streams.wheel_stamps[:0], streams.wheel_poses[:0],
            streams.imu_stamps[:0], streams.imu_quats[:0])

    system = app.SlamSystem()
    dev = system.register.device
    on_cuda = dev.type == "cuda"
    segments = []
    for s in range(n_segments):
        builds0 = _build.BUILDS
        lk.reset_counts()
        # a fresh map is seeded by its first scan, which is not registered
        registrations = scans_per_segment - int(
            system.map_manager.is_submap_empty())
        run_streamed(system, segment(s * scans_per_segment,
                                     (s + 1) * scans_per_segment))
        row = {
            "segment": s,
            "new_builds": _build.BUILDS - builds0,
            "rss_mb": round(_rss_mb(), 1),
            "registrations": registrations,
            "k3_launches": lk.K3_LAUNCHES,
            "plain_cuda_calls": (lk.K1_PLAIN_CUDA_CALLS
                                 + lk.K2_PLAIN_CUDA_CALLS
                                 + lk.K3_PLAIN_CUDA_CALLS
                                 + lk.K4_PLAIN_CUDA_CALLS),
        }
        if on_cuda:
            torch.cuda.synchronize(dev)
            st = torch.cuda.memory_stats(dev)
            row.update({
                "allocated_mb": round(
                    torch.cuda.memory_allocated(dev) / 1e6, 3),
                "reserved_mb": round(torch.cuda.memory_reserved(dev) / 1e6, 3),
                "live_allocations": int(st["allocation.all.current"]),
                "segment_allocations": int(st["segment.all.allocated"]),
            })
        segments.append(row)

    # -- checks ---------------------------------------------------------------
    first, last = segments[1], segments[-1]
    builds_ok = all(s["new_builds"] == 0 for s in segments[1:])
    tpu = Params.get_instance()["tpu"]
    dims = [max(int(d) // 2, 1) for d in tpu["dense_grid_dims"]]
    map_mb = (dims[0] * dims[1] * dims[2]
              * 8 * int(tpu.get("loam_slab_size", 24)) * 3 * 2) / 1e6
    rss_growth = last["rss_mb"] - first["rss_mb"]
    rss_ok = rss_growth < RSS_NOISE_MB + map_mb
    out = {
        "metric": "memcheck",
        "device": str(dev),
        "segments": segments,
        "steady_state_builds_ok": builds_ok,
        "rss_growth_mb": round(rss_growth, 1),
        "rss_ok": rss_ok,
        "map_footprint_mb": round(map_mb, 1),
    }
    ok = builds_ok and rss_ok
    if on_cuda:
        kernels_ok = all(s["k3_launches"] == s["registrations"]
                         and s["plain_cuda_calls"] == 0 for s in segments)
        alloc_growth = last["allocated_mb"] - first["allocated_mb"]
        handles_growth = last["live_allocations"] - first["live_allocations"]
        reserved_growth = last["reserved_mb"] - first["reserved_mb"]
        device_ok = (alloc_growth <= map_mb + DEVICE_NOISE_MB
                     and reserved_growth <= map_mb + DEVICE_NOISE_MB
                     and handles_growth <= DEVICE_ALLOCATIONS_NOISE)
        out.update({
            "kernels_ok": kernels_ok,
            "allocated_growth_mb": round(alloc_growth, 3),
            "reserved_growth_mb": round(reserved_growth, 3),
            "live_allocations_growth": handles_growth,
            "segment_allocations_growth": (last["segment_allocations"]
                                           - first["segment_allocations"]),
            "device_memory_ok": device_ok,
        })
        ok = ok and kernels_ok and device_ok
    out["ok"] = bool(ok)
    return out


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="steady-state check of the streamed executor")
    ap.add_argument("n_segments", nargs="?", type=int, default=4)
    ap.add_argument("scans_per_segment", nargs="?", type=int, default=48)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--device", default=None,
                    help="override the config's torch.device (e.g. cpu)")
    args = ap.parse_args(argv)
    out = run_memcheck(args.n_segments, args.scans_per_segment,
                       device=args.device)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
