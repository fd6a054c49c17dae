"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py [--scans N] [--kernels-only] [--only PATHS]

Drives ``simpleslam_tpu_torch`` (never jax) through twenty-three phases and
fails with a nonzero exit on the first problem:

1. environment: card name and power limit (nvidia-smi), torch / CUDA
   versions, TF32 flags; no CUDA device is a failure;
2. build: the CUDA kernels of ``simpleslam_tpu_torch/csrc`` with nvcc;
3. kernels against their plain PyTorch versions at main-path shapes (a
   merged map at dims (96, 96, 16) x 24 points, 8192 queries): K1
   ``fit_and_linearize_merged`` and K2 ``plane_normal_equations`` within the
   reference's tolerances, K1 bit-identical across two calls, K2's sums
   bit-identical to its body compiled for the host (``native.k2_host``, the
   same layout and fixed order); K1 and K2 at 5 and 131 queries (fewer than
   the grid's blocks) and with every query masked out; the device time of
   one K1 and one K2 wrapper call over all its launches, which must be one
   (torch.profiler; PyTorch's fills of new tensors counted apart); K3
   ``gn_loop_fused`` (the whole GN loop in one launch) against its plain
   version ``gn_loop_stepwise`` from the on-pose start and from a 0.25 m
   offset start, degeneracy guard off and on: pose within 1e-4 m and
   1e-5 rad, the same iterations / gathers / converged and n_valid within
   4 rows, bit-identical across two calls; then K3 against the stepwise
   loop at the edges of its layout (1000 queries, 500 valid ones, none valid)
   on the same submap as a merged map, a dense map and a sorted table of
   65536 and of 4096 keys (above and within the kernel's sampled key index);
   median times from CUDA events, K3's device time from ``torch.profiler``,
   the grid barrier's cost and the loop's barrier floor (iterations x one
   barrier), and K3's device time split into a launch's fixed part and an
   iteration with a K1 and with a K2 phase;
4. the lo-mode LOAM slice: ``SlamSystem`` + ``run_offline`` on the bench's
   ``lo`` config and sequence;
5. streamed lo: the bench's ``lo`` config through ``run_streamed`` (batches
   of 32 scans) on the bench's 150-scan sequence at full width;
6. streamed full: the bench's headline ``full`` config (pose-graph backend
   on its worker thread, ScanContext + VGICP loop closure) on the same
   sequence, after ``SlamSystem.prewarm``; then K1, K2 and K3 against their
   plain versions (as in 3) on this path's own inputs: its last target and
   its last scans prepped as the executor preps them, at the latched scan
   capacity, with the times that the kernels JSON line reports. K3 is held
   against the stepwise loop on its last 48 scans (two starts, guard off
   and on): a comparison whose counts differ is reported, and more than 1 %
   of them over phases 3 and 6 is a failure;
7. loop closure: the courtyard loop of tests/test_pipeline_lc.py (world and
   config copied here) with ``tpu.sync_backend``, run twice: at least one
   accepted closure and one solve that ran, closures within 0.3 m / 5 deg of
   the truth, the four bounds of that test, and bit-identical poses;
   phases 4-7 each check accuracy and finite poses, that K3 was launched
   once per registration and that no plain version (K1's, K2's or the
   stepwise loop) ran on CUDA; 5-7 print scans/s, the streamed stage timers
   and peak device memory, run one batch body with
   ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation
   before the packed read) and print that batch's launches per scan and the
   device's idle share from ``torch.profiler``;
8. streamed lio: the bench's ``lio`` config (wheel+IMU fused by the host
   EKF replay in 4096-event chunks, ``odom2map`` in the device chain, backend
   on) on the same 150 scans: the checks of 5-6, at least one EKF chunk, and
   the ``ekf_replay`` time;
9. NDT odometry and 10. VGICP odometry: streamed lo with ``pcr: ndt`` /
   ``pcr: vgicp`` on the first 60 of those scans at full width (the default
   (192, 192, 32) dense grid) in 16-scan batches, each run twice: finite poses, ATE under the
   0.3 m of tests/test_ndt_vgicp.py, poses bit-identical across the two
   runs, one batch body of 8 scans under sync debugging and under the
   profiler. These registers are plain PyTorch: no kernel of the table is on
   their path, and their K3 / K1 / K2 counts (0) are printed;
11. threaded: ``run_threaded`` in bag mode (ingest, LO, map-update and
   backend threads) with LOAM and the backend on, on those 60 scans: every
   scan processed, ATE inside the streamed limit, K3 once per registration;
12. K4 ``fit_and_linearize_candidates`` against its plain version: first on
   synthetic candidates at C = 1, 7, 192, 216 and 256 (its 1-, 4- and
   16-byte copy paths), with set flags on masked-out queries, with every
   flag off and with every query masked out; then at path shapes: the streamed full path's last submap as a dense map
   (grid 2.0, corner gather, 192 candidates per query) and as a sorted voxel
   table (grid 1.0, slab 8, 27-cell gather, 216 candidates), its last scan
   prepped at the latched capacity: n_valid and the plane set (ok,
   centroid, normal) bit-identical, the normal equations within the
   reference's tolerances, two launches bit-identical; its device time
   beside an empty launch's, the bytes it moves, its bound, CUDA-event
   medians and the plain version's time;
13. ``loam.scan2map`` on both of those targets over the path's last 48 scans
   from the recorded pose and from the 0.25 m offset, with sync debugging
   set to raise: K3 launched once per registration, no K4, K2, K1 or plain
   launch, and the poses beside those of the merged map from the same start
   (different candidate sets: int16 rows there, f32 here, 24 points per 2 m
   voxel against 8 per 1 m voxel; the gap is printed and bounded); then K3
   against ``gn_loop_stepwise`` on the same cases, guard off and on (counts,
   pose within 1e-4 m / 1e-5 rad, bit-identical repeats, the allowance of
   phase 6), and K3's time, device time and bound on each target;
14. the recorded-data path at full width: the bench sequence written as a
   ROS1 bag (``none`` chunks; a 5-scan ``lz4`` bag beside it), read back,
   and run through ``app.main --bag ... --streamed`` in the bench's ``full``
   config with ``vis.enable`` and an output directory; ``eval.evaluate`` of
   the written ``tum.txt`` against the ground-truth TUM file beside the
   bench's in-memory ``full`` run's keyframes; K3 once per registration, PLY
   files written; every scan's pose within 1e-3 m of an in-memory run of the
   same config at the CLI's 16-scan batches, and the same keyframes in the
   two ``tum.txt`` files; then the same from a KITTI velodyne directory of 60
   scans;
15. (none: the benchmark, ``slambench/``, measures the device's busy and
   idle time of the streamed paths);
16. ``memcheck`` on the card, 4 segments of 48 scans: its JSON, ``ok``
   required;
17. the mesh path (``parallel/``, after every other phase): ranks are
   processes; with a card per rank (``chiprun --chips 4``) each takes its
   own and the ranks use NCCL, else they share this card in a gloo group
   (NCCL refuses two ranks on one GPU), so none of its times is a scaling
   number; the ranks' backend must be the rule's. Sharded
   registration on the streamed full path's inputs (its last merged map,
   the same submap as a dense map and a sorted table, its last scan from
   the 0.25 m offset) on 1 rank (here), 2 and 4 ranks: one rank sets no
   hook and is bit-identical to the unsharded ``gn_loop`` (one K3 launch);
   more are within 1e-4 m and 1e-6 rad of the unsharded
   ``gn_loop_stepwise`` with equal iterations and gathers, every rank and
   two runs bit-identical, K1 (merged) or K4 (dense, table) and K2
   launched, K3, the plain versions and the unsharded stepwise loop not;
   K1, K2 and K4 against their plain versions on rank 1's block (K1's and
   K2's device time and launches per wrapper call there, profiled in a
   fresh process: one launch each, or the phase fails); the NDT
   and VGICP sharded batches (2 ranks, pose rows within 5e-3 of the
   one-rank batch); the sharded pose-graph solve in its three modes on a
   256-node ring (cost falls, poses within 1e-3 m of the one-rank PCG
   solve); the streamed pipeline on 2 ranks in the bench ``full`` config
   (150 scans) and the courtyard loop, each held to the single-rank K3
   run of phase 4 or 7 (every registration within phase 3's bounds of K3
   on its own inputs, the same keyframes and closures, ATE within section
   2's limits, every rank and two runs bit-identical, the backend's counts
   equal on every rank; the per-scan gap is printed with the registration
   where it opens, ROADMAP F6); scans/s, collectives per scan and their ms,
   and the host-staged copies of the collectives, beside the card;
18. localization (``SlamSystem(pcd_file=...)``): a mapping run of the
   bench's full config on the bench sequence saves its keyframes, which at
   their saved poses make a global PCD; ``tpu.submap_capacity`` is set to
   hold all of it (its point count is printed); the sequence is localized
   against it streamed (32-scan batches) and offline, and from scan 75
   after ``set_reloc_flag``: every scan registered by one K3 launch, no
   keyframe, ATE under 0.15 m;
19. the hard worlds: the bench's ``adversarial``, ``corridor`` (lio,
   ``loop=False``) and ``forest_dynamic`` (6 moving obstacles) configs,
   degeneracy guard on, 100 scans of which 15 warm up: streamed ATE and
   converged limits (the corridor: the lateral, vertical and yaw bounds of
   tests/test_adversarial.py, and every scan within 25 mm of the port's
   own CPU run); then that file's corridor registration fixture, K3 with
   the guard against ``gn_loop_stepwise``: both within its bounds, the
   unguarded K3 further along the corridor, the gap and the directions
   each eigensolve zeroes printed;
20. the pose graph above the dense cut: the 1536-node ring of
   tests/test_posegraph_scale.py solved on the card at 40 x 256
   iterations (cost under 1e-3 of the start, every pose within 0.05 m of
   the truth, rotations orthonormal to 5e-4), ms per solve, launches per
   CG iteration, one LM iteration under sync debugging and its idle share;
   a 600-node ring within 1e-3 m of the port's CPU solve;
21. multi-lap loop closure: the 400-scan spiral of
   tests/test_pipeline_lc_multi.py with ``tpu.sync_backend``: at least 3
   closures, none dropped, each within 0.3 m of the truth, the keyframe
   map no worse than the raw odometry + 0.02 m and under 0.3 m;
   18, 19 and 21 hold K3 to one launch per registration with no plain
   version, and run one batch body under sync debugging and the profiler,
   as 5-7 do; 18-21 run before 17, which runs last;
22. the single-device entry hook (``simpleslam_tpu_torch.entry``, the
   port's ``__graft_entry__.entry``; right after 3): ``fn(*args)`` on the
   sorted table and on the dense map of its plane-world fixture, each call
   exactly one K3 launch with no plain, stepwise, K1, K2 or K4 call; the
   pose within 1e-5 m / 1e-6 rad of ``gn_loop_stepwise`` with equal counts
   and within 1e-4 m / 1e-5 rad of the hook's CPU run; the wrapper time per
   call (CUDA events), K3's device time per launch (torch.profiler, one
   launch per call or the phase fails) and its bound;
23. the result: a JSON line of the kernels K1-K4 (with the launches of each
   path: K3's launches, for K1 and K2 the times their bodies ran as phases
   of K3, from the recorded gathers and iterations, the K1 phases of the
   ``scan2map`` paths of 13 reading the dense map's or the table's
   candidates, and the standalone launches of the mesh path; K1's and K2's
   launches per wrapper call and the device time of one call; for K4 its
   own launches, on the mesh path's dense and table registrations; K3's
   times and bounds on those targets, its device-time split and barrier
   floor), the nvidia-smi line, and last a JSON line
   ``{"ok": true, "device": ...}``.

``--only entry,lio,ndt,vgicp,threaded,k4,recorded,memcheck,loc,hard,``
``graph,multilap,mesh`` (any subset) drives just the named paths of 8-22 after
the build (a quick check
while working on one of them; ``k4``, ``recorded`` and ``mesh`` run the
streamed full config first, for its inputs) and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

# cuBLAS is deterministic only with a fixed workspace; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# main-path shapes: bench lo config at the default tpu.* capacities
DIMS = (96, 96, 16)       # dense_grid_dims (192, 192, 32) at the 2 m grid
SLAB = 24                 # tpu.loam_slab_size
N_QUERIES = 8192          # tpu.ds_scan_capacity
SUBMAP_CAP = 131072       # tpu.submap_capacity
# tolerances of tests/test_loam_pallas.py (f32, different summation order)
JTJ_RTOL = 2e-5           # of max |J^T J|
JTE_RTOL = 5e-4           # of max |J^T e|
OK_MISMATCH_MAX = 1e-3    # share of queries whose plane gate may flip
# K3 against the stepwise loop: both run the same f32 formulas with sums in
# another order and another 6x6 factorization, so poses agree to rounding
POSE_T_TOL = 1e-4         # metres
POSE_R_TOL = 1e-5         # radians
COUNT_MISMATCH_MAX = 0.01  # share of comparisons whose counts may differ
# K3 against the stepwise loop on the same inputs, counts equal (phases 3, 6
# and 13, FusedTally): the stepwise loop's guarded solve takes its eigenbasis
# in float64, within 1e-7 m of K3's Jacobi step, so the two meet within
# 2e-6 m / 1.2e-7 rad on the H100; the bounds above stay for phase 17's
# sharded registrations (their sums cross ranks) and the corridor fixture
STEPWISE_T_TOL = 1e-5     # metres
STEPWISE_R_TOL = 1e-6     # radians
# n_valid may differ by a few rows where the two loops' poses differ after a
# step: the two 6x6 solves round differently on these ill-conditioned
# systems (the CPU tests hold both against float64), and a gap of 1e-5 m
# moves the 5-NN choice of about one query in 5000
N_VALID_TOL = 4
START_OFFSET = (0.25, -0.15, 0.05)   # the perturbed start, metres
SMALL_OFFSET = (0.03, -0.02, 0.01)   # a start that needs no new gather
DEGEN = 0.02              # loam.DEGEN_EIGEN_PER_ROW (the guard's floor)
N_FUSED_SCANS = 48        # scans of the streamed path K3 is held on
# roofline of the card (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def us(ms) -> str:
    """Milliseconds as microseconds, or "not measured"."""
    return "not measured" if ms is None else f"{1e3 * ms:.2f} us"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, reps: int = 50) -> float:
    """Median milliseconds per call from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def bounds(n_q: int, n_valid: int, n_cand: int, gathers: int = 1,
           iters: int = 1, n_cand_ok=None) -> dict:
    """The least time (ms) the card could take for each kernel's work on
    these inputs, and what sets it: bytes moved once over the memory rate
    against f32 operations over the peak rate.

    K1 reads one int16 row per valid query (masked-out queries need none),
    the queries (p_map, sqrt_r, mask) and writes the planes and the sums;
    about 24 operations per candidate (dequantize, distance, five selection
    rounds) plus about 520 per query (plane fit, gates, the 28-term row).
    K2 streams planes and queries, about 120 operations per query. K3 reads
    the rows once per K1 phase it ran and the scan once; its K2 phases read
    nothing; about 1,500 operations per small step. K4 (when ``n_cand_ok``,
    the count of set candidate flags, is given) needs the flag of every
    candidate of a valid query (1 byte) and the coordinates of those whose
    flag is set (12 bytes): a masked-out query needs no candidate, and its
    flags are all false.
    """
    row = n_cand * 3 * 2
    sums = (36 + 6 + 1) * 4
    k1_bytes = n_valid * row + n_q * (12 + 4 + 1) + n_q * (12 + 12 + 1) + sums
    k1_ops = n_valid * (24 * n_cand + 520)
    k2_bytes = n_q * (12 + 12 + 1 + 12 + 4) + sums
    k2_ops = n_q * 120
    k3_bytes = gathers * n_valid * row + n_q * (12 + 1) + 64 + 80
    k3_ops = gathers * k1_ops + (iters - gathers) * k2_ops + iters * 1500
    work = [("k1", k1_bytes, k1_ops), ("k2", k2_bytes, k2_ops),
            ("k3", k3_bytes, k3_ops)]
    if n_cand_ok is not None:
        # the candidate stream, then the queries, the planes and the sums as
        # K1; K1's operations
        k4_bytes = n_valid * n_cand + n_cand_ok * 12 + n_q * (12 + 4 + 1) \
            + n_q * (12 + 12 + 1) + sums
        work.append(("k4", k4_bytes, k1_ops))
    out = {}
    for name, nbytes, ops in work:
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
        out[name] = (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")
    return out


EVENTS_HOW = "CUDA events around 50 back-to-back launches"


class DeviceCall(NamedTuple):
    """The device work of one call of a function (``call_device``)."""

    ms: float          # device ms of its hand kernels per call
    launches: int      # hand-kernel launches per call
    by_kernel: dict    # kernel name -> (launches per call, device ms per call)
    own_ms: float      # PyTorch's own kernels, copies and fills: ms per call
    own_launches: int  # and their launches per call


def call_device(fn, calls: int = 20):
    """The device work of one call of ``fn`` (a ``DeviceCall``), from
    torch.profiler over ``calls`` calls after a warm-up. A hand kernel is
    any device kernel that is not PyTorch's (``at::``) and no copy or fill;
    under ``torch.use_deterministic_algorithms`` (set here) every
    ``torch.empty`` adds a fill kernel of PyTorch's, counted apart. A
    kernel's launches per call are its events over the calls, rounded (a
    window now and then loses an event), and its time per call that many
    times its mean duration. None when three windows in a row recorded no
    hand kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        durs = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                durs.setdefault(e.name, []).append(
                    1e-3 * (e.time_range.end - e.time_range.start))
        hand, own = {}, [0.0, 0]
        for name, d in durs.items():
            per = round(len(d) / calls)
            ms = per * statistics.fmean(d)
            if "at::" in name or name.lower().startswith(("memcpy",
                                                          "memset")):
                own[0] += ms
                own[1] += per
            elif per:
                hand[name] = (per, ms)
        if hand:
            return DeviceCall(sum(t for _, t in hand.values()),
                              sum(n for n, _ in hand.values()), hand,
                              own[0], own[1])
    return None


def kernel_device_ms(kernel_name: str, fn, calls: int = 20):
    """Device milliseconds per launch of the hand kernel whose name contains
    ``kernel_name``, over ``calls`` calls of ``fn`` (``call_device``); None
    when the profiler saw no launch of it."""
    t = call_device(fn, calls)
    hits = [v for name, v in (t.by_kernel.items() if t else ())
            if kernel_name in name]
    if not hits:
        return None
    return sum(ms for _, ms in hits) / sum(n for n, _ in hits)


def kernel_short_name(name: str) -> str:
    """A device kernel's function name without its namespace, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.split("<")[0].split()[-1] if name.strip() else "?"


def describe_call(t) -> str:
    """``call_device``'s result in words."""
    if t is None:
        return "device time not measured (the profiler saw no hand kernel)"
    return (f"{1e3 * t.ms:.2f} us of device time per call in {t.launches} "
            f"hand launch(es) ("
            + ", ".join(f"{kernel_short_name(k)} {1e3 * v:.2f} us"
                        for k, (_, v) in t.by_kernel.items())
            + f"), PyTorch's own {1e3 * t.own_ms:.2f} us in {t.own_launches} "
            f"launch(es) (fills of new tensors)")


def one_launch_per_call(name: str, t) -> None:
    """Fail unless the profiler saw a wrapper call launch exactly one hand
    kernel (``t`` from ``call_device``)."""
    if t is None:
        fail(f"{name}: the profiler saw no hand kernel, so the launches per "
             "call are not known")
    if t.launches != 1:
        fail(f"{name}: {t.launches} hand-kernel launches per wrapper call, "
             f"expected 1: {t.by_kernel}")


def kernel_device_ms_how(kernel_name: str, fn, bare=None):
    """(device milliseconds per launch of the kernel, how it was measured).
    A profiler window now and then comes back without a device event:
    ``kernel_device_ms`` takes up to three, then CUDA events around 50
    back-to-back calls of ``bare`` (``fn`` unless given) stand in. That is an
    upper bound: the gaps between launches, and any other kernel ``bare``
    launches, count."""
    dev = kernel_device_ms(kernel_name, fn)
    if dev is not None:
        return dev, "torch.profiler"
    return events_ms(bare or fn), EVENTS_HOW


def events_ms(fn, n: int = 50) -> float:
    """Milliseconds per call of ``fn`` from CUDA events around ``n``
    back-to-back calls, after one: an upper bound of its device time (the
    gaps between launches, and every kernel it launches, count)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def device_activity(prof, what: str):
    """(kernels, copies and fills, busy us, span us) of the device events a
    ``torch.profiler`` run of ``what`` recorded; fails when it saw none."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        fail(f"{what}: torch.profiler saw no device event")
    copies = sum(1 for e in evs
                 if e.name.lower().startswith(("memcpy", "memset")))
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return (len(evs) - copies, copies, busy,
            max(b for _, b in spans) - spans[0][0])


class GnRecorder:
    """Observes ``loam.gn_loop`` during a run: keeps every registration's
    iteration and gather counts, start and result on the device and reads
    them once at the end. ``k1_phases`` / ``k2_phases`` are the times K1's
    and K2's bodies ran inside K3; ``records`` is (starts, results,
    iterations, gathers) per registration."""

    def __enter__(self):
        from simpleslam_tpu_torch.ops import loam

        self._loam, self._orig, self._rows = loam, loam.gn_loop, []
        self._poses = []

        def recording(*args, **kwargs):
            res = self._orig(*args, **kwargs)
            self._rows.append(torch.stack([res.iters, res.n_gathers]))
            start = args[2] if len(args) > 2 else kwargs["init_pose"]
            self._poses.append(torch.stack([start.to(torch.float32),
                                            res.pose]))
            return res

        loam.gn_loop = recording
        return self

    def __exit__(self, *exc):
        self._loam.gn_loop = self._orig
        counts = (torch.stack(self._rows).cpu().numpy() if self._rows
                  else np.zeros((0, 2), np.int64))
        poses = (torch.stack(self._poses).cpu().numpy().astype(np.float64)
                 if self._poses else np.zeros((0, 2, 4, 4)))
        self.n_reg = len(counts)
        self.k1_phases = int(counts[:, 1].sum())
        self.k2_phases = int((counts[:, 0] - counts[:, 1]).sum())
        self.records = (poses[:, 0], poses[:, 1], counts[:, 0], counts[:, 1])
        return False


def environment() -> str:
    phase("environment")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    import simpleslam_tpu_torch  # noqa: F401  (sets the TF32 flags)

    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device count "
          f"{torch.cuda.device_count()}")
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    torch.use_deterministic_algorithms(True)
    return card


def build() -> None:
    phase("build")
    from simpleslam_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS:.2f} s)")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")


def kernel_submap(dev):
    """A simulated submap (downsampled, with its centre), and one scan's
    queries with the scan's pose."""
    from simpleslam_tpu_torch.ops import pointcloud as pcops
    from simpleslam_tpu_torch.ops import voxel as vox
    from simpleslam_tpu_torch.pipeline import simulate as sim

    world = sim.make_world(seed=0)
    _, poses = sim.make_trajectory(40, 0.1, speed=1.5)
    rng = np.random.default_rng(0)
    clouds = []
    for i in (0, 10, 20, 30):
        s = sim.simulate_scan(world, sim.sensor_from_body(poses[i]),
                              n_az=1800, n_el=16, rng=rng)
        clouds.append(s @ poses[i][:3, :3].T + poses[i][:3, 3])
    sub = pcops.from_numpy(np.concatenate(clouds).astype(np.float32),
                           SUBMAP_CAP, dev)
    center = torch.tensor(poses[15][:3, 3].astype(np.float32), device=dev)
    ds_sub = pcops.compact(vox.voxel_downsample(sub, 0.5, center), SUBMAP_CAP)
    scan = sim.simulate_scan(world, sim.sensor_from_body(poses[16]),
                             n_az=1800, n_el=16, rng=rng)
    src = pcops.compact(vox.voxel_downsample(
        pcops.from_numpy(scan, 32768, dev), 0.5), N_QUERIES)
    return ds_sub, center, src, torch.tensor(poses[16].astype(np.float32),
                                             device=dev)


def kernel_inputs(dev):
    """A real merged map from a simulated submap, and one scan's queries."""
    from simpleslam_tpu_torch.ops import geometry as geo
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import voxel as vox

    ds_sub, center, src, pose = kernel_submap(dev)
    vm = vox.build_merged_dense_voxel_map(ds_sub, 2.0, center, DIMS, SLAB)
    off = offset_pose(pose)
    print(f"map rows {tuple(vm.rows.shape)} int16 "
          f"({vm.rows.numel() * 2 / 1e6:.1f} MB), queries {src.capacity} "
          f"({int(src.mask.sum())} valid)")
    sqrt_r = loam.source_sqrt_range(src)
    p_on = geo.transform_points(pose, src.xyz)
    p_off = geo.transform_points(off, src.xyz)
    return vm, src, sqrt_r, p_on, p_off, pose


def compare(name, got, ref):
    """Max abs error of (J^T J, J^T e), after the tolerance checks."""
    jtj, jte, nv = got[:3]
    jtj0, jte0, nv0 = ref[:3]
    scale = float(jtj0.abs().max())
    escale = float(jte0.abs().max()) + 1e-9
    e_jtj = float((jtj - jtj0).abs().max())
    e_jte = float((jte - jte0).abs().max())
    print(f"  {name}: n_valid {int(nv)} vs plain {int(nv0)}; "
          f"|dJtJ| {e_jtj:.3e} (limit {JTJ_RTOL * scale:.3e}), "
          f"|dJte| {e_jte:.3e} (limit {JTE_RTOL * escale:.3e})")
    if int(nv) != int(nv0) or int(nv0) < 100:
        fail(f"{name}: n_valid {int(nv)} vs plain {int(nv0)}")
    if e_jtj > JTJ_RTOL * scale or e_jte > JTE_RTOL * escale:
        fail(f"{name}: normal equations disagree with the plain version")
    return max(e_jtj, e_jte)


def hold_kernels(label: str, vm, src, sqrt_r, p_on, p_off) -> dict:
    """K1 and K2 against their plain versions on one scan's queries at an
    on-pose and a perturbed map placement; K1 and K2 repeat bit for bit.
    Returns the max abs errors."""
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    errs = {"k1": 0.0, "k2": 0.0}
    for tag, p_map in (("on-pose", p_on), ("perturbed", p_off)):
        tag = f"{label} {tag}"
        got = lk.fit_and_linearize_merged(vm, p_map, sqrt_r, src.mask)
        ref = lk.fit_and_linearize_merged_plain(vm, p_map, sqrt_r, src.mask)
        torch.cuda.synchronize()
        errs["k1"] = max(errs["k1"], compare(f"K1 {tag}", got, ref))
        ok, ok0 = got[3].ok, ref[3].ok
        mism = int((ok != ok0).sum())
        print(f"  K1 {tag}: plane ok {int(ok.sum())} vs plain {int(ok0.sum())},"
              f" mismatch {mism} of {ok.numel()}")
        if mism > OK_MISMATCH_MAX * ok.numel():
            fail(f"K1 {tag}: plane gate mismatch {mism}")
        both = ok & ok0
        dn = float((got[3].normal[both] - ref[3].normal[both]).abs().max())
        dc = float((got[3].centroid[both] - ref[3].centroid[both]).abs().max())
        print(f"  K1 {tag}: max |d normal| {dn:.3e}, max |d centroid| {dc:.3e} m")
        again = lk.fit_and_linearize_merged(vm, p_map, sqrt_r, src.mask)
        same = all(torch.equal(a, b) for a, b in zip(
            (*got[:3], *got[3]), (*again[:3], *again[3])))
        print(f"  K1 {tag}: second call bit-identical: {same}")
        if not same:
            fail("K1 is not deterministic")
    # K2 on the frozen on-pose planes at the perturbed pose (a GN iteration)
    planes = lk.fit_and_linearize_merged(vm, p_on, sqrt_r, src.mask)[3]
    got = lk.plane_normal_equations(planes, p_off, sqrt_r)
    ref = lk.plane_normal_equations_plain(planes, p_off, sqrt_r)
    torch.cuda.synchronize()
    errs["k2"] = compare(f"K2 {label} frozen planes", got, ref)
    again = lk.plane_normal_equations(planes, p_off, sqrt_r)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("K2 is not deterministic")
    k2_against_host(f"K2 {label} frozen planes", got, planes, p_off, sqrt_r)
    return errs


def k2_against_host(tag: str, got, planes, p_map, sqrt_r) -> None:
    """K2's sums against its body compiled for the host
    (``native.k2_host``, csrc/fixed_sums.h) on the card's grid: the same
    layout, order and f32 / f64 operations, so the same bits."""
    from simpleslam_tpu_torch import native
    from simpleslam_tpu_torch.ops import _build

    grid = _build.library().loam_gn_loop_grid()
    host = native.k2_host(*(t.cpu().numpy() for t in planes),
                          p_map.cpu().numpy(), sqrt_r.cpu().numpy(), grid)
    same = (np.array_equal(host[0].view(np.uint32),
                           got[0].cpu().numpy().view(np.uint32))
            and np.array_equal(host[1].view(np.uint32),
                               got[1].cpu().numpy().view(np.uint32))
            and host[2] == int(got[2]))
    print(f"  {tag}: bit-identical to K2's body on the host ({grid} "
          f"blocks): {same}")
    if not same:
        fail(f"{tag}: the card's sums are not its host body's")


def k1_k2_edge_cases(vm, src, sqrt_r, p_map) -> None:
    """K1 and K2 against their plain versions where the layout is thin:
    fewer queries than blocks (5, 131), and every query masked out (no row:
    exact zeros); n_valid and the plane gates equal, the sums within the
    tolerances, two calls bit-identical, one launch each."""
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    cases = {f"Q={n}": (p_map[:n], sqrt_r[:n], src.mask[:n])
             for n in (5, 131)}
    cases["all masked"] = (p_map, sqrt_r, torch.zeros_like(src.mask))
    for case, (p, sr, m) in cases.items():
        got = lk.fit_and_linearize_merged(vm, p, sr, m)
        again = lk.fit_and_linearize_merged(vm, p, sr, m)
        k2 = lk.plane_normal_equations(got[3], p, sr)
        k2_again = lk.plane_normal_equations(got[3], p, sr)
        one_launch_per_call(f"K1 {case}", call_device(
            lambda: lk.fit_and_linearize_merged(vm, p, sr, m)))
        one_launch_per_call(f"K2 {case}", call_device(
            lambda: lk.plane_normal_equations(got[3], p, sr)))
        ref = lk.fit_and_linearize_merged_plain(vm, p, sr, m)
        ref2 = lk.plane_normal_equations_plain(got[3], p, sr)
        for name, a, b, c in (("K1", got[:3], ref[:3], again[:3]),
                              ("K2", k2, ref2, k2_again)):
            jtj, jte = b[0].abs().max(), b[1].abs().max()
            ok = (int(a[2]) == int(b[2])
                  and float((a[0] - b[0]).abs().max()) <= JTJ_RTOL * jtj
                  and float((a[1] - b[1]).abs().max()) <= JTE_RTOL * jte
                  and all(torch.equal(x, y) for x, y in zip(a, c)))
            print(f"  {name} {case}: n_valid {int(a[2])} vs plain "
                  f"{int(b[2])}, sums within the tolerances and two calls "
                  f"bit-identical: {ok}")
            if not ok:
                fail(f"{name} {case}: off its plain version")
        if not torch.equal(got[3].ok, ref[3].ok) or (
                case == "all masked" and (got[3].centroid.any()
                                          or got[3].normal.any())):
            fail(f"K1 {case}: plane gates differ from the plain version")


CALL_HOW = ("torch.profiler, every hand-kernel launch of one wrapper call, "
            "mean of 20 calls")
CALL_HOW_FRESH = CALL_HOW + ", in a fresh process"


def time_kernels(vm, src, sqrt_r, p_on, p_off) -> dict:
    """Median ms of each kernel's wrapper and of its plain version, and K1's
    and K2's device ms per wrapper call over all the call's launches
    (torch.profiler) with the launches per call; a call that launches more
    than one kernel fails."""
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    planes = lk.fit_and_linearize_merged(vm, p_on, sqrt_r, src.mask)[3]
    calls = {
        "k1": call_device(lambda: lk.fit_and_linearize_merged(
            vm, p_on, sqrt_r, src.mask)),
        "k2": call_device(lambda: lk.plane_normal_equations(planes, p_off,
                                                            sqrt_r))}
    for k, c in calls.items():
        print(f"  {k.upper()}: {describe_call(c)}")
        one_launch_per_call(k.upper(), c)
    return {
        **{k + "_dev": (None if c is None else c[0])
           for k, c in calls.items()},
        **{k + "_dev_how": CALL_HOW for k in calls},
        **{k + "_launches": (None if c is None else c[1])
           for k, c in calls.items()},
        "k1": time_ms(lambda: lk.fit_and_linearize_merged(
            vm, p_on, sqrt_r, src.mask)),
        "k1_plain": time_ms(lambda: lk.fit_and_linearize_merged_plain(
            vm, p_on, sqrt_r, src.mask)),
        "k2": time_ms(lambda: lk.plane_normal_equations(planes, p_off, sqrt_r)),
        "k2_plain": time_ms(lambda: lk.plane_normal_equations_plain(
            planes, p_off, sqrt_r)),
    }


def _rot_angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Angle of Ra^T Rb from its skew part, in f64 (arccos of the trace
    cannot resolve 1e-5 rad)."""
    dR = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    return 0.5 * float(np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                                       dR[1, 0] - dR[0, 1]]))


class FusedTally:
    """K3 against ``gn_loop_stepwise`` over many comparisons."""

    def __init__(self):
        self.n = self.count_mismatches = self.n_valid_gaps = 0
        self.t_err = self.r_err = 0.0

    def compare(self, tag: str, src, vm, start, degen: float, verbose=True):
        from simpleslam_tpu_torch.ops import loam

        got = loam.gn_loop(src, vm, start, degen_per_row=degen)
        again = loam.gn_loop(src, vm, start, degen_per_row=degen)
        ref = loam.gn_loop_stepwise(src, vm, start, degen_per_row=degen)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K3 {tag}: two launches differ: not deterministic")
        c_got = (int(got.iters), int(got.n_gathers), int(got.n_valid),
                 bool(got.converged))
        c_ref = (int(ref.iters), int(ref.n_gathers), int(ref.n_valid),
                 bool(ref.converged))
        p, q = got.pose.cpu().numpy(), ref.pose.cpu().numpy()
        if not np.isfinite(p).all():
            fail(f"K3 {tag}: non-finite pose")
        t_err = float(np.linalg.norm(p[:3, 3].astype(np.float64) - q[:3, 3]))
        r_err = _rot_angle(p[:3, :3], q[:3, :3])
        self.n += 1
        if c_got[:2] != c_ref[:2] or c_got[3] != c_ref[3] \
                or abs(c_got[2] - c_ref[2]) > N_VALID_TOL:
            # a threshold fell the other way on a rounding difference: the
            # two loops took different steps, so the poses are not compared
            self.count_mismatches += 1
            print(f"  K3 {tag}: counts (iters, gathers, n_valid, converged) "
                  f"{c_got} vs stepwise {c_ref}; poses {t_err:.3e} m, "
                  f"{r_err:.3e} rad apart")
            return got
        if c_got[2] != c_ref[2]:
            self.n_valid_gaps += 1
            print(f"  K3 {tag}: n_valid {c_got[2]} vs stepwise {c_ref[2]} "
                  f"(iters {c_got[0]}, gathers {c_got[1]} the same); poses "
                  f"{t_err:.3e} m, {r_err:.3e} rad apart")
        self.t_err, self.r_err = max(self.t_err, t_err), max(self.r_err, r_err)
        if verbose:
            print(f"  K3 {tag}: iters {c_got[0]}, gathers {c_got[1]}, n_valid "
                  f"{c_got[2]}, converged {c_got[3]} (stepwise: n_valid "
                  f"{c_ref[2]}, the rest the same); pose {t_err:.3e} m, "
                  f"{r_err:.3e} rad from stepwise; second launch bit-identical")
        if t_err > STEPWISE_T_TOL or r_err > STEPWISE_R_TOL:
            fail(f"K3 {tag}: pose {t_err:.3e} m / {r_err:.3e} rad from the "
                 f"stepwise loop (limits {STEPWISE_T_TOL} / "
                 f"{STEPWISE_R_TOL})")
        return got

    def check(self) -> None:
        share = self.count_mismatches / max(self.n, 1)
        print(f"K3 against the stepwise loop: {self.n} comparisons, "
              f"{self.count_mismatches} with differing iterations, gathers, "
              f"converged flag or n_valid more than {N_VALID_TOL} rows apart "
              f"({100 * share:.2f} %), {self.n_valid_gaps} more with n_valid "
              f"1-{N_VALID_TOL} rows apart, largest pose gap "
              f"{self.t_err:.3e} m / {self.r_err:.3e} rad")
        if share > COUNT_MISMATCH_MAX:
            fail(f"K3: counts differ from the stepwise loop in "
                 f"{100 * share:.2f} % of comparisons")


def offset_pose(pose: torch.Tensor) -> torch.Tensor:
    off = pose.clone()
    off[:3, 3] += torch.tensor(START_OFFSET, device=pose.device)
    return off


def hold_fused(tally: FusedTally, label: str, vm, src, pose) -> dict:
    """K3 against its plain version from the on-pose and the offset start,
    guard off and on. Returns the on-pose run's counts."""
    counts = {}
    for tag, start in (("on-pose", pose), ("offset", offset_pose(pose))):
        for gtag, degen in (("guard off", 0.0), ("guard on", DEGEN)):
            got = tally.compare(f"{label} {tag}, {gtag}", src, vm, start, degen)
            if degen == 0.0:
                counts[tag] = (int(got.iters), int(got.n_gathers))
    return counts


def time_fused(vm, src, pose, card: str, label: str) -> dict:
    """Median ms per call (CUDA events) of K3 and of the stepwise loop, and
    K3's device time per launch (torch.profiler), from three starts: on the
    pose, a small offset (more iterations, no new gather) and the 0.25 m
    offset (a regather). From the three device times and their counts, what
    an iteration costs with a K1 phase and with a K2 phase; and the grid
    barrier's cost alone."""
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    small = pose.clone()
    small[:3, 3] += torch.tensor(SMALL_OFFSET, device=pose.device)
    t, rows, n_iters = {}, [], {}
    for key, tag, start in (("k3", "on-pose", pose),
                            ("k3_small", "small offset", small),
                            ("k3_off", "offset", offset_pose(pose))):
        res = loam.gn_loop(src, vm, start)
        iters, gathers = int(res.iters), int(res.n_gathers)
        t[key] = time_ms(lambda: loam.gn_loop(src, vm, start))
        t[key + "_plain"] = time_ms(
            lambda: loam.gn_loop_stepwise(src, vm, start), 10)
        start_c = start.to(torch.float32).contiguous()
        dev, how = kernel_device_ms_how(
            "gn_loop_kernel", lambda: loam.gn_loop(src, vm, start),
            lambda: lk.gn_loop_fused(src.xyz, src.mask, vm, start_c,
                                     loam.MAX_ITERS, 0.0))
        t[key + "_dev"], t[key + "_dev_how"] = dev, how
        rows.append((gathers, iters - gathers, dev))
        n_iters[key] = iters
        print(f"  K3 from the {tag} start ({iters} iterations, {gathers} K1 "
              f"phases): median {t[key]:.4f} ms per call, device time "
              f"{dev:.4f} ms per launch ({how}), stepwise "
              f"{t[key + '_plain']:.4f} ms ({card}, {label})")
    one = time_ms(lambda: lk.barrier_probe(src.xyz.device, 1))
    many = time_ms(lambda: lk.barrier_probe(src.xyz.device, 257))
    t["barrier"] = (many - one) / 256.0
    # the loop's own floor, which the byte bound does not count: one grid
    # barrier per iteration
    t["barrier_floor_ms"] = {k: n * t["barrier"] for k, n in n_iters.items()}
    print(f"  one grid barrier {1e3 * t['barrier']:.2f} us; the loop's barrier"
          f" floor {1e3 * t['barrier_floor_ms']['k3']:.2f} us on-pose, "
          f"{1e3 * t['barrier_floor_ms']['k3_off']:.2f} us from the offset "
          f"({card})")
    a = np.array([[1.0, g, k] for g, k, _ in rows])
    t["split_ms"] = None
    if abs(np.linalg.det(a)) > 1e-9:
        fixed, k1_it, k2_it = np.linalg.solve(
            a, np.array([d for _, _, d in rows]))
        t["split_ms"] = {"per_launch": fixed, "per_k1_iteration": k1_it,
                         "per_k2_iteration": k2_it}
        print(f"  K3 device time split from those three: {1e3 * fixed:.1f}"
              f" us per launch + {1e3 * k1_it:.1f} us per iteration with "
              f"a K1 phase + {1e3 * k2_it:.1f} us per iteration with a K2 "
              f"phase (each with its barrier, sums and small step) "
              f"({card}, {label})")
    return t


# the K3 edge cases: a query count that is no multiple of a warp, fewer
# valid queries than warps on the grid, none valid
K3_EDGE_QUERIES = 1000
K3_EDGE_VALID = 500


def k3_edge_cases(tally: FusedTally, dev) -> None:
    """K3 against the stepwise loop at the edges of its layout, on every
    target built from phase 3's submap (the sorted table both above and
    within the sampled index's budget of keys), from the scan's pose and
    the offset start, guard off and on."""
    from simpleslam_tpu_torch.ops import pointcloud as pcops
    from simpleslam_tpu_torch.ops import voxel as vox

    ds_sub, center, src, pose = kernel_submap(dev)
    budget = 4096   # tg::kIndexBudget in csrc/target_gather.h
    targets = {
        "merged map": vox.build_merged_dense_voxel_map(ds_sub, 2.0, center,
                                                       DIMS, SLAB),
        "dense map": vox.build_dense_voxel_map(ds_sub, 2.0, center, DIMS,
                                               SLAB),
        f"table of {TABLE_VOXELS} keys": vox.build_voxel_map(
            ds_sub, TABLE_GRID, center, TABLE_VOXELS, TABLE_SLAB),
        f"table of {budget} keys": vox.build_voxel_map(
            ds_sub, TABLE_GRID, center, budget, TABLE_SLAB)}
    few = src.mask & (torch.cumsum(src.mask.to(torch.int32), 0)
                      <= K3_EDGE_VALID)
    cases = {
        f"Q={K3_EDGE_QUERIES}": pcops.PointCloud(
            *(t[:K3_EDGE_QUERIES].contiguous() for t in src)),
        f"{K3_EDGE_VALID} valid": src._replace(mask=few),
        "all masked": src._replace(mask=torch.zeros_like(src.mask))}
    before = tally.n
    for kind, vm in targets.items():
        for case, s in cases.items():
            for tag, start in (("on-pose", pose), ("offset", offset_pose(pose))):
                for degen in (0.0, DEGEN):
                    tally.compare(f"edge {kind}, {case}, {tag}, guard "
                                  f"{'on' if degen else 'off'}", s, vm, start,
                                  degen, verbose=False)
    print(f"  K3 edge cases ({', '.join(cases)}) on {', '.join(targets)}: "
          f"{tally.n - before} comparisons with the stepwise loop")


def kernels(card: str):
    phase("kernels against plain versions")
    dev = torch.device("cuda")
    vm, src, sqrt_r, p_on, p_off, pose = kernel_inputs(dev)
    errs = hold_kernels("offline", vm, src, sqrt_r, p_on, p_off)
    k1_k2_edge_cases(vm, src, sqrt_r, p_off)
    tally = FusedTally()
    hold_fused(tally, "offline", vm, src, pose)
    k3_edge_cases(tally, dev)
    t = time_kernels(vm, src, sqrt_r, p_on, p_off)
    for k in ("k1", "k2"):
        print(f"  {k.upper()} median {t[k]:.4f} ms per wrapper call, device "
              f"{us(t[k + '_dev'])} per call in {t[k + '_launches']} "
              f"launch(es) ({t[k + '_dev_how']}), plain {t[k + '_plain']:.4f}"
              f" ms ({card}, Q={N_QUERIES})")
    time_fused(vm, src, pose, card, f"Q={N_QUERIES}")
    src_file = "simpleslam_tpu_torch/csrc/loam_kernels.cu"
    results = [
        {"name": "fit_and_linearize_merged", "route": "cuda",
         "source": src_file,
         "replaces": "simpleslam_tpu/ops/loam_pallas.py:67",
         "max_abs_err": errs["k1"]},
        {"name": "plane_normal_equations", "route": "cuda",
         "source": src_file,
         "replaces": "simpleslam_tpu/ops/loam_pallas.py:177",
         "max_abs_err": errs["k2"]},
        {"name": "gn_loop_fused", "route": "cuda", "source": src_file,
         "replaces": "simpleslam_tpu/ops/loam_pallas.py:67",
         "max_abs_err": tally.t_err},
    ]
    del vm
    torch.cuda.empty_cache()
    return results, tally


def slice_run(n_scans: int, card: str):
    phase("lo-mode LOAM slice")
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import app
    from simpleslam_tpu_torch.pipeline import simulate as sim

    t0 = time.perf_counter()
    world = sim.make_world(seed=0)
    streams = sim.simulate_sequence(world, n_scans=n_scans, seed=0,
                                    n_az=1800, n_el=16)
    print(f"simulated {n_scans} scans in {time.perf_counter() - t0:.1f} s "
          "(host numpy, not part of the slice)")
    system = app.SlamSystem({"mode": "lo", "backend": {"enable": False},
                             "frontend": {"pcr": "loam"},
                             "torch": {"device": "cuda"}})
    torch.cuda.reset_peak_memory_stats()
    lk.reset_counts()
    with GnRecorder() as rec:
        result = app.run_offline(system, streams)
        torch.cuda.synchronize()
    launches = launch_counts(rec)
    ate = sim.ate_rmse(streams.gt_poses, result.poses)
    per_scan = np.asarray(result.timers.series["odometry"])
    warm = per_scan[5:] if len(per_scan) > 10 else per_scan
    print(f"scans {n_scans}, wall {result.wall_time:.2f} s, "
          f"{n_scans / result.wall_time:.2f} scans/s end to end, "
          f"odometry median {1e3 * float(np.median(warm)):.2f} ms/scan "
          f"after 5 warm-up scans ({card})")
    print(result.timers.report())
    print(f"ATE {ate:.4f} m (0.0047 m before K3), keyframes "
          f"{result.keyframe_count}, converged {result.converged_frac:.3f}, "
          f"{describe_launches(launches)}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    check_path("offline lo", result, n_scans, ate, 0.15, 0.95, launches)
    return launches


# the bench's configs (bench.py:384-394) and batch size (bench.py:59)
BENCH_LO = {"mode": "lo", "backend": {"enable": False},
            "frontend": {"pcr": "loam"}}
BENCH_FULL = {"mode": "lo", "backend": {"enable": True, "lc": {"enable": True}},
              "frontend": {"pcr": "loam"}}
BENCH_SYNC_EVERY = 32
# streamed bounds of tests/test_streamed.py
STREAMED_ATE_MAX = 0.25
STREAMED_CONV_MIN = 0.9


def launch_counts(rec: GnRecorder) -> dict:
    """Kernel launches of the run just made: K3's (and the standalone K1 /
    K2 wrappers', which the main paths no longer call), the plain versions'
    calls on CUDA tensors, and from the recorder the registrations and the
    times K1's and K2's bodies ran as phases of K3."""
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    return {"k3": lk.K3_LAUNCHES, "k4": lk.K4_LAUNCHES,
            "k1_standalone": lk.K1_LAUNCHES,
            "k2_standalone": lk.K2_LAUNCHES,
            "plain": (lk.K1_PLAIN_CUDA_CALLS + lk.K2_PLAIN_CUDA_CALLS
                      + lk.K4_PLAIN_CUDA_CALLS),
            "stepwise": lk.K3_PLAIN_CUDA_CALLS, "registrations": rec.n_reg,
            "k1": rec.k1_phases, "k2": rec.k2_phases}


def describe_launches(c: dict) -> str:
    return (f"K3 launches {c['k3']} for {c['registrations']} registrations "
            f"(K1 phases {c['k1']}, K2 phases {c['k2']} inside them), "
            f"standalone K1 / K2 / K4 launches {c['k1_standalone']} / "
            f"{c['k2_standalone']} / {c['k4']}, plain CUDA calls {c['plain']}, "
            f"stepwise loops on CUDA {c['stepwise']}")


def check_path(name: str, result, n_scans: int, ate: float, ate_max,
               conv_min: float, launches: dict, kind: str = "loam",
               n_reg=None) -> None:
    """Finite poses, ATE under ``ate_max`` (None: no bound), converged share
    over ``conv_min`` (None: no bound), and for LOAM one K3 launch per
    registration: ``n_reg`` of them (every scan but the one that seeds the
    map unless given), no plain version."""
    if result.poses.shape != (n_scans, 4, 4) or not np.isfinite(
            result.poses).all():
        fail(f"{name}: trajectory is not finite ({n_scans}, 4, 4)")
    if ate_max is not None and not ate < ate_max:
        fail(f"{name}: ATE {ate} >= {ate_max} m")
    if conv_min is not None and not result.converged_frac > conv_min:
        fail(f"{name}: converged fraction {result.converged_frac} <= "
             f"{conv_min}")
    if kind != "loam":
        # NDT and VGICP are plain PyTorch: no kernel of the table is on
        # their path, so 0 launches is the expected reading
        print(f"{name}: register {kind} launches no hand kernel: "
              f"{describe_launches(launches)}")
        return
    n_reg = n_scans - 1 if n_reg is None else n_reg
    if not (launches["k3"] == launches["registrations"] == n_reg):
        fail(f"{name}: K3 launches {launches['k3']}, registrations "
             f"{launches['registrations']}, scans {n_scans}")
    if launches["k1"] < launches["registrations"] or launches["k2"] == 0:
        fail(f"{name}: a phase of K3 never ran on this path: {launches}")
    if launches["plain"] != 0 or launches["stepwise"] != 0:
        fail(f"{name}: plain versions ran on CUDA: {launches}")


def report_streamed(name: str, result, n_scans: int, ate: float,
                    launches: dict, card: str, ate_before=None) -> None:
    t = result.timers
    stages = ", ".join(
        f"{k} {1e3 * t.mean(k):.2f} ms x{t.count[k]}"
        for k in ("ekf_replay", "prep", "upload", "dispatch", "fetch",
                  "bookkeep", "map_update", "backend", "lc") if t.count[k])
    n_reg = max(n_scans - 1, 1)
    before = ("" if ate_before is None
              else f"; {ate_before:.4f} m before K3")
    print(f"{name}: {n_scans} scans in {result.wall_time:.2f} s = "
          f"{n_scans / result.wall_time:.2f} scans/s end to end ({card})")
    print(f"{name}: stage means {stages}; dispatch "
          f"{1e3 * t.total['dispatch'] / n_reg:.3f} ms per scan ({card})")
    print(result.timers.report())
    print(f"{name}: ATE {ate:.4f} m (unaligned{before}),"
          f" keyframes {result.keyframe_count}, converged "
          f"{result.converged_frac:.3f}, GN iterations/scan "
          f"{result.extras['gn_iters_mean']}, scan capacity "
          f"{result.extras['scan_capacity']}, {describe_launches(launches)}, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")


def sort_grid(system) -> float:
    """The grid ``run_streamed`` sorts prepped scans at: LOAM's dense-map
    grid, or the NDT / VGICP voxel resolution."""
    reg = system.register
    return float(getattr(reg, "TARGET_GRID", getattr(reg, "RESOLUTION", 0.0)))


def prep_scans(system, streams, idx, cap: int):
    """Scans ``idx`` as the streamed executor preps them (downsampled,
    spatially sorted, int16) at scan capacity ``cap``: (rows, counts)."""
    from simpleslam_tpu_torch import native
    from simpleslam_tpu_torch.pipeline import streamed

    return native.voxel_downsample_sort_quant_batch(
        [np.asarray(streams.scans[i], np.float32) for i in idx],
        float(system.lidar_odometry.grid_size), cap, sort_grid(system),
        streamed.UPLOAD_SCALE)


def batch_probe(name: str, system, streams, result, sync_every: int,
                card: str) -> None:
    """One batch body on the path's own state (its last target, its last
    ``sync_every`` scans, the chain at the scans before them; in lio mode
    those scans' local odometry from the EKF feeder and the ``odom2map``
    that goes with the chain): first with sync debugging set to raise, so
    any host synchronisation before the packed read is an error; then under
    ``torch.profiler`` for the launches per scan and the device's idle
    share."""
    from torch.profiler import ProfilerActivity, profile

    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import streamed
    from simpleslam_tpu_torch.utils.config import Params

    dev = system.register.device
    n = len(streams.scan_stamps)
    k = min(sync_every, n - 2)
    idx = list(range(n - k, n))
    rows, _ = prep_scans(system, streams, idx,
                         int(result.extras["scan_capacity"]))
    rows_d = torch.from_numpy(rows).to(dev)
    prev = torch.tensor(result.poses[n - k - 1].astype(np.float32), device=dev)
    prev2 = torch.tensor(result.poses[n - k - 2].astype(np.float32),
                         device=dev)
    odom2map, local_d = torch.eye(4, device=dev), None
    if system.mode == "lio":
        stamps = np.asarray(streams.scan_stamps)
        local = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        streamed._LocalOdomFeeder(streams, stamps, local).ensure(n - 1)
        odom2map = torch.tensor(
            (result.poses[n - k - 1] @ np.linalg.inv(
                local[n - k - 1].astype(np.float64))).astype(np.float32),
            device=dev)
        local_d = torch.from_numpy(local[n - k:]).to(dev)
    kind = system.register.KIND
    n_k3 = k if kind == "loam" else 0
    args = (rows_d, system.map_manager.get_target(), prev, prev2, odom2map,
            kind,
            bool(Params.get_instance()["frontend"].get("planar_clamp", True)),
            float(system.register.degen_per_row), 0.0, local_d)
    streamed._batch_body(*args)[1].cpu()
    torch.cuda.synchronize()
    before = lk.K3_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, packed = streamed._batch_body(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rows_h = packed.cpu().numpy()
    if lk.K3_LAUNCHES - before != n_k3 or not np.isfinite(rows_h).all():
        fail(f"{name}: batch body under sync debugging: K3 launches "
             f"{lk.K3_LAUNCHES - before} for {k} scans of register {kind}")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        streamed._batch_body(*args)[1].cpu()
    wall = time.perf_counter() - t0
    kern, copies, busy, span = device_activity(prof, f"{name} batch body")
    line = (f"{name}: one batch body of {k} scans ran with sync debugging "
            f"set to raise (no host synchronisation before the packed read);"
            f" converged {int(rows_h[:, 16].sum())} of {k}; ")
    print(line + f"under torch.profiler {kern / k:.1f} kernel launches and "
          f"{copies / k:.2f} copies or fills per scan, device busy "
          f"{1e-3 * busy:.3f} ms of a {1e-3 * span:.3f} ms span: idle share "
          f"{100 * (1 - busy / span):.1f} % (host wall {1e3 * wall:.1f} ms "
          f"with the profiler on) ({card})")


def streamed_run(name: str, cfg: dict, streams, card: str, ate_before=None,
                 prewarm=False, ate_max=STREAMED_ATE_MAX,
                 conv_min=STREAMED_CONV_MIN, sync_every=BENCH_SYNC_EVERY,
                 probe_scans=BENCH_SYNC_EVERY):
    """One config through ``run_streamed`` in batches of ``sync_every`` scans
    (the bench's batch size unless given); returns the kernel counts of
    exactly that run, the system and the result. ``probe_scans`` is the size
    of the batch body that is run alone afterwards (0: none); ``conv_min``
    None sets no bound on the converged share."""
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import app
    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.pipeline.streamed import run_streamed

    phase(name)
    system = app.SlamSystem(dict(cfg, torch={"device": "cuda"}))
    if prewarm:
        t0 = time.perf_counter()
        system.prewarm()
        torch.cuda.synchronize()
        print(f"{name}: prewarm {time.perf_counter() - t0:.2f} s ({card})")
    torch.cuda.reset_peak_memory_stats()
    lk.reset_counts()
    with GnRecorder() as rec:
        result = run_streamed(system, streams, sync_every=sync_every)
        torch.cuda.synchronize()
    launches = launch_counts(rec)
    result.extras["gn_records"] = rec.records
    n = len(streams.scan_stamps)
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    report_streamed(name, result, n, ate, launches, card, ate_before)
    check_path(name, result, n, ate, ate_max, conv_min, launches,
               system.register.KIND)
    if probe_scans:
        batch_probe(name, system, streams, result, probe_scans, card)
    return launches, system, result


def main_path_kernels(system, streams, result, card: str, tally: FusedTally):
    """K1, K2 and K3 against their plain versions on the streamed path's own
    inputs: the target its last batch registered against, and its last scans
    prepped as the executor preps them (downsampled, spatially sorted, int16)
    at the run's latched scan capacity, placed at their recorded poses. The
    last scan gets the full treatment and the timings; K3 is also held
    against the stepwise loop on the N_FUSED_SCANS before it. Returns the
    max abs errors, the times and the bounds for the timed inputs."""
    from simpleslam_tpu_torch.ops import geometry as geo
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.pipeline import streamed

    phase("kernels against plain versions on the streamed full inputs")
    dev = system.register.device
    cap = int(result.extras["scan_capacity"])
    n = len(streams.scan_stamps)
    idx = list(range(max(1, n - 1 - N_FUSED_SCANS), n))
    rows, cnts = prep_scans(system, streams, idx, cap)
    rows_d = torch.from_numpy(rows).to(dev)
    vm = system.map_manager.get_target()

    def pose_of(i):
        return torch.tensor(result.poses[i].astype(np.float32), device=dev)

    i = idx[-1]
    src = streamed.upload_cloud(rows_d[-1])
    pose = pose_of(i)
    off = offset_pose(pose)
    sqrt_r = loam.source_sqrt_range(src)
    p_on = geo.transform_points(pose, src.xyz)
    p_off = geo.transform_points(off, src.xyz)
    n_valid_q = int(cnts[-1])
    print(f"scan {i} at scan capacity {cap} ({n_valid_q} valid, queries "
          f"{src.capacity}), target rows {tuple(vm.rows.shape)} int16")
    if src.capacity != cap:
        fail(f"queries {src.capacity} != scan capacity {cap}")
    errs = hold_kernels("streamed full", vm, src, sqrt_r, p_on, p_off)
    before = tally.t_err
    tally.t_err = 0.0
    counts = hold_fused(tally, "streamed full", vm, src, pose)
    t0 = time.perf_counter()
    for k, j in enumerate(idx[:-1]):
        src_j = streamed.upload_cloud(rows_d[k])
        for tag, start in (("on-pose", pose_of(j)),
                           ("offset", offset_pose(pose_of(j)))):
            for degen in (0.0, DEGEN):
                tally.compare(f"streamed full scan {j} {tag}, guard "
                              f"{'on' if degen else 'off'}", src_j, vm, start,
                              degen, verbose=False)
    print(f"  K3 held against the stepwise loop on scans {idx[0]}-{idx[-2]} "
          f"in {time.perf_counter() - t0:.1f} s")
    errs["k3"] = tally.t_err
    tally.t_err = max(tally.t_err, before)
    t = time_kernels(vm, src, sqrt_r, p_on, p_off)
    for k in ("k1", "k2"):
        print(f"  {k.upper()} median {t[k]:.4f} ms per wrapper call, device "
              f"{us(t[k + '_dev'])} per call in {t[k + '_launches']} "
              f"launch(es) ({t[k + '_dev_how']}), plain {t[k + '_plain']:.4f}"
              f" ms ({card}, Q={cap}, streamed full inputs)")
    t.update(time_fused(vm, src, pose, card, f"Q={cap}, streamed full inputs"))
    iters, gathers = counts["on-pose"]
    bd = bounds(cap, n_valid_q, 8 * vm.slab_pts, gathers, iters)
    iters_o, gathers_o = counts["offset"]
    bd_off = bounds(cap, n_valid_q, 8 * vm.slab_pts, gathers_o, iters_o)
    for k in ("k1", "k2", "k3"):
        print(f"  {k.upper()} bound {1e3 * bd[k][0]:.3f} us by {bd[k][1]} "
              f"({n_valid_q} valid queries of {cap}); measured "
              f"{1e3 * t[k]:.1f} us per wrapper call = "
              f"{100 * bd[k][0] / t[k]:.2f} % of the bound's rate ({card})")
    for k in ("k1", "k2"):
        if t[k + "_dev"] is not None:
            print(f"  {k.upper()} device time of one wrapper call "
                  f"{us(t[k + '_dev'])} = "
                  f"{100 * bd[k][0] / t[k + '_dev']:.2f} % of the bound's "
                  f"rate ({card})")
    print(f"  K3 from the on-pose start ({gathers} K1 phases in {iters} "
          f"iterations): device time {1e3 * t['k3_dev']:.1f} us per "
          f"launch = {100 * bd['k3'][0] / t['k3_dev']:.2f} % of the "
          f"bound's rate, barrier floor "
          f"{1e3 * t['barrier_floor_ms']['k3']:.2f} us; from the offset "
          f"start ({gathers_o} K1 phases in {iters_o} iterations) bound "
          f"{1e3 * bd_off['k3'][0]:.3f} us, barrier floor "
          f"{1e3 * t['barrier_floor_ms']['k3_off']:.2f} us, device "
          f"{1e3 * t['k3_off_dev']:.1f} us ({card})")
    return errs, t, bd


# -- the courtyard loop of tests/test_pipeline_lc.py (copied: no jax here) ---
LC_RADIUS = 8.0
LC_SPEED = 3.0
LC_SCANS = 200
LC_CFG = {
    "mode": "lo",
    "frontend": {"pcr": "loam"},
    "tpu": {"dense_grid_dims": [128, 128, 32], "sync_backend": True},
    "backend": {
        "enable": True,
        "lc": {"enable": True, "historySubmapRange": 2,
               "fitnessThreshold": 0.3},
        "context": {"used": "scancontext",
                    "scancontext": {"numExcludeRecent": 15,
                                    "numCandidatesFromTree": 5,
                                    "scDistThres": 0.4, "buildTreeGap": 5,
                                    "searchRatio": 0.1}},
    },
}


def make_courtyard(sim, radius: float, seed: int = 0):
    """A ring of 10 buildings around a circular loop of ``radius``."""
    rng = np.random.default_rng(seed)
    w = sim.World()
    cx0, cy0 = 0.0, radius
    e = 40.0
    w.rects.append(sim.Rect(2, 0.0, (-e, e, -e, e)))  # ground
    for k in (0, 1):
        for off in (-e, e):
            w.rects.append(sim.Rect(k, off, (-e, e, 0.0, 6.0)))
    for ang in np.linspace(0, 2 * np.pi, 10, endpoint=False):
        rr = radius + 8.0 + rng.uniform(0, 4)
        cx = cx0 + rr * np.cos(ang + rng.uniform(-0.1, 0.1))
        cy = cy0 + rr * np.sin(ang + rng.uniform(-0.1, 0.1))
        sx, sy = rng.uniform(4, 8, size=2)
        h = rng.uniform(4, 10)
        x0, x1 = cx - sx / 2, cx + sx / 2
        y0, y1 = cy - sy / 2, cy + sy / 2
        w.rects.append(sim.Rect(0, x0, (y0, y1, 0.0, h)))
        w.rects.append(sim.Rect(0, x1, (y0, y1, 0.0, h)))
        w.rects.append(sim.Rect(1, y0, (x0, x1, 0.0, h)))
        w.rects.append(sim.Rect(1, y1, (x0, x1, 0.0, h)))
        w.rects.append(sim.Rect(2, h, (x0, x1, y0, y1)))
    return w


def loop_closure_run(card: str):
    from simpleslam_tpu_torch.models.backend import LC_VAR
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import app
    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.pipeline.streamed import run_streamed

    phase("loop closure (courtyard, sync_backend, twice)")
    t0 = time.perf_counter()
    streams = courtyard_streams()
    print(f"simulated {LC_SCANS} scans in {time.perf_counter() - t0:.1f} s "
          "(host numpy, not part of the path)")
    runs = []
    for rep in range(2):
        system = app.SlamSystem(dict(LC_CFG, torch={"device": "cuda"}))
        torch.cuda.reset_peak_memory_stats()
        lk.reset_counts()
        with GnRecorder() as rec:
            result = run_streamed(system, streams)
            torch.cuda.synchronize()
        launches = launch_counts(rec)
        ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
        name = f"loop closure run {rep + 1}"
        report_streamed(name, result, LC_SCANS, ate, launches, card, 0.0145)
        be, lcm = system.backend, system.loop_closure
        print(f"{name}: LC queries {lcm.n_queries}, candidates "
              f"{lcm.n_candidates}, converged verifications "
              f"{lcm.n_verify_converged}, accepted {be.n_lc_edges}; solves "
              f"run {be.n_solves}, skipped {be.n_skipped_noop_solves}")
        check_path(name, result, LC_SCANS, ate, 0.1, 0.9, launches)
        if be.n_lc_edges < 1:
            fail(f"{name}: no loop closure was accepted")
        if be.n_solves < 1:
            fail(f"{name}: no pose-graph solve ran")
        kfs = system.map_manager.kf_obj.keyframes

        def gt_at(stamp):
            return streams.gt_poses[int(np.argmin(np.abs(
                streams.scan_stamps - stamp)))]

        for n in range(len(be.edge_i)):
            if not np.allclose(be.edge_var[n], LC_VAR):
                continue
            i, j = be.edge_i[n], be.edge_j[n]
            err = np.linalg.inv(np.linalg.inv(gt_at(kfs[i].stamp))
                                @ gt_at(kfs[j].stamp)) @ be.edge_T[n]
            t_err = float(np.linalg.norm(err[:3, 3]))
            r_err = float(np.degrees(np.arccos(np.clip(
                (np.trace(err[:3, :3]) - 1) / 2, -1, 1))))
            print(f"{name}: closure {i} -> {j}: {t_err:.4f} m, "
                  f"{r_err:.3f} deg from the truth")
            if t_err >= 0.3 or r_err >= 5.0:
                fail(f"{name}: closure {i} -> {j} is off the truth")
        idx = np.array([int(np.argmin(np.abs(streams.scan_stamps - kf.stamp)))
                        for kf in kfs])
        gt = streams.gt_poses[idx][:, :3, 3]
        post = np.sqrt(np.mean(np.sum(
            (gt - np.stack([kf.pose for kf in kfs])[:, :3, 3]) ** 2, 1)))
        raw = np.sqrt(np.mean(np.sum(
            (gt - result.poses[idx][:, :3, 3]) ** 2, 1)))
        print(f"{name}: keyframe ATE {post:.4f} m after the solves, "
              f"{raw:.4f} m raw")
        if not (post <= raw + 0.02 and post < 0.1):
            fail(f"{name}: post-solve keyframes worse than raw odometry")
        if rep == 0:
            batch_probe(name, system, streams, result, 16, card)
        runs.append((result.poses, launches))
        if rep == 0:  # the mesh path's single-rank reference
            MESH["courtyard"] = (streams, (result.poses,
                                           int(result.keyframe_count),
                                           int(be.n_lc_edges), rec.records))
    same = np.array_equal(runs[0][0], runs[1][0])
    print(f"loop closure: two sync_backend runs bit-identical: {same}")
    if not same:
        fail("the two sync_backend runs differ")
    return runs[0][1]


# the bench's lio config (bench.py:398-401)
BENCH_LIO = {"mode": "lio", "backend": {"enable": True, "lc": {"enable": False}},
             "frontend": {"pcr": "loam"}}
REGISTER_SCANS = 60       # scans of the NDT, VGICP and threaded paths
REGISTER_ATE_MAX = 0.3    # the bound of tests/test_ndt_vgicp.py
# 16-scan batches for NDT and VGICP: four batches in 60 scans, so submap
# rebuilds (a Gaussian target, its precisions) fall inside the run
REGISTER_SYNC_EVERY = 16
REGISTER_PROBE_SCANS = 8  # their lone batch body (thousands of launches a scan)


def head_of(sim, streams, n: int):
    """The first ``n`` scans of ``streams`` (the wheel and IMU streams stay
    whole)."""
    return sim.SensorStreams(
        scan_stamps=streams.scan_stamps[:n], scans=streams.scans[:n],
        gt_poses=streams.gt_poses[:n], wheel_stamps=streams.wheel_stamps,
        wheel_poses=streams.wheel_poses, imu_stamps=streams.imu_stamps,
        imu_quats=streams.imu_quats)


def lio_run(streams, card: str) -> dict:
    """The bench's lio config through ``run_streamed``: K3 once per
    registration, the EKF replay on the host in chunks."""
    launches, _, result = streamed_run(
        "streamed lio (bench lio config)", BENCH_LIO, streams, card,
        prewarm=True)
    t = result.timers
    print(f"streamed lio: ekf_chunks {result.extras['ekf_chunks']}, "
          f"ekf_replay {1e3 * t.total['ekf_replay']:.3f} ms in "
          f"{t.count['ekf_replay']} calls (host, the tape built and fused "
          f"just ahead of each batch) ({card})")
    if result.extras["ekf_chunks"] < 1:
        fail("streamed lio: no EKF chunk was fused")
    return launches


def register_runs(kind: str, streams, card: str) -> dict:
    """NDT or VGICP as the odometry register, streamed lo with the backend
    off, twice: accuracy, the lone batch body once, bit-identical poses."""
    cfg = {"mode": "lo", "backend": {"enable": False},
           "frontend": {"pcr": kind}}
    runs = []
    for rep in range(2):
        launches, _, result = streamed_run(
            f"{kind} odometry, run {rep + 1} (streamed lo, pcr {kind})", cfg,
            streams, card, ate_max=REGISTER_ATE_MAX, conv_min=None,
            sync_every=REGISTER_SYNC_EVERY,
            probe_scans=0 if rep else REGISTER_PROBE_SCANS)
        runs.append((result.poses, launches))
        torch.cuda.empty_cache()
    same = np.array_equal(runs[0][0], runs[1][0])
    print(f"{kind} odometry: two runs bit-identical: {same}")
    if not same:
        fail(f"the two {kind} runs differ")
    return runs[0][1]


def threaded_run(streams, card: str) -> dict:
    """``run_threaded`` in bag mode: LOAM odometry on the LO thread, map
    updates and backend turns on theirs, all on the one CUDA stream."""
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import app
    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.pipeline.threaded import run_threaded

    name = "threaded"
    phase("threaded (bag mode, lo + LOAM + backend)")
    system = app.SlamSystem({"mode": "lo", "backend": {"enable": True},
                             "frontend": {"pcr": "loam"},
                             "torch": {"device": "cuda"}})
    system.prewarm()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lk.reset_counts()
    with GnRecorder() as rec:
        result = run_threaded(system, streams)
        torch.cuda.synchronize()
    launches = launch_counts(rec)
    n = len(streams.scan_stamps)
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    print(f"{name}: {result.extras['n_processed']} of {n} scans processed in "
          f"{result.wall_time:.2f} s = {n / result.wall_time:.2f} scans/s end "
          f"to end ({card})")
    print(result.timers.report())
    print(f"{name}: ATE {ate:.4f} m (unaligned), keyframes "
          f"{result.keyframe_count}, backend edges "
          f"{len(system.backend.edge_i)}, {describe_launches(launches)}, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
          f"({card})")
    if result.extras["n_processed"] != n:
        fail(f"{name}: {result.extras['n_processed']} of {n} scans processed "
             "in bag mode")
    if len(system.backend.edge_i) < result.keyframe_count - 1:
        fail(f"{name}: the backend thread did not consume the keyframe events")
    check_path(name, result, n, ate, STREAMED_ATE_MAX, None, launches)
    return launches


# -- K4 and the other two LOAM targets ----------------------------------------
TABLE_GRID = 1.0          # sorted table: 27 cells of 1 m cover the 1 m search
TABLE_SLAB = 8
TABLE_VOXELS = 65536
# scan2map on a dense or sorted-table target against the merged map's pose
# from the same start. The three hold different candidates (merged rows are
# int16-quantized at about 5.9 mm; the 2 m voxels keep 24 points, the 1 m
# voxels 8), so the poses agree to the registration's own noise, not to
# rounding: 1.15 mm / 2.0e-4 rad measured on an NVIDIA H100 80GB HBM3; the
# limits are a few times that.
TARGET_GAP_T_MAX = 5e-3   # metres
TARGET_GAP_R_MAX = 1e-3   # radians


def last_submap(system):
    """The streamed path's last submap (the keyframe window of its last map
    rebuild, transformed and downsampled as ``_fused_window_target`` does)
    and its centre."""
    from simpleslam_tpu_torch.models.registration import _fused_window_target

    mm = system.map_manager
    dev = system.register.device
    sel, poses, center = mm._last_build
    w = mm.kf_window
    idx = np.zeros(w, np.int64)
    pose_w = np.tile(np.eye(4, dtype=np.float32), (w, 1, 1))
    mask_w = np.zeros(w, bool)
    idx[:len(sel)], pose_w[:len(sel)], mask_w[:len(sel)] = sel, poses, True
    center_t = torch.tensor(center.astype(np.float32), device=dev)
    submap = _fused_window_target(
        mm._kf_store, torch.from_numpy(idx).to(dev),
        torch.from_numpy(pose_w).to(dev), torch.from_numpy(mask_w).to(dev),
        center_t, mm.grid_size, lambda ds, _: ds)
    return submap, center_t


def other_targets(system):
    """The streamed path's last submap as a dense map and as a sorted voxel
    table."""
    from simpleslam_tpu_torch.ops import voxel as vox

    submap, center_t = last_submap(system)
    sel = system.map_manager._last_build[0]
    dense = vox.build_dense_voxel_map(submap, 2.0, center_t, DIMS, SLAB)
    table = vox.build_voxel_map(submap, TABLE_GRID, center_t, TABLE_VOXELS,
                                TABLE_SLAB)
    n_vox = int((table.keys != vox.INVALID_KEY).sum())
    print(f"last submap: {int(submap.mask.sum())} points of {len(sel)} "
          f"keyframes; dense map slab {tuple(dense.slab.shape)} f32, sorted "
          f"table {n_vox} voxels of {TABLE_VOXELS} x {TABLE_SLAB} points")
    if not 0 < n_vox < TABLE_VOXELS:
        fail(f"sorted table holds {n_vox} voxels of {TABLE_VOXELS}")
    return {"dense": dense, "table": table}


K4_EDGE_CANDIDATES = (1, 7, 192, 216, 256)


def k4_bytes(cand_ok: torch.Tensor, mask: torch.Tensor) -> int:
    """Bytes K4 moves from and to device memory on these inputs: the flags
    of every valid query, the coordinate chunks it copies (16-byte chunks
    that hold a set flag where C is a multiple of 4, else 12 bytes per set
    flag), the queries and the plane set."""
    n_q, c = cand_ok.shape
    ok_v = cand_ok[mask]
    if c % 4 == 0:
        k = torch.arange(c * 3 // 4, device=cand_ok.device)
        c0 = (16 * k) // 12
        c1 = torch.clamp((16 * k + 15) // 12, max=c - 1)
        coords = 16 * int((ok_v[:, c0] | ok_v[:, c1]).sum())
    else:
        coords = 12 * int(ok_v.sum())
    return ok_v.shape[0] * c + coords + n_q * (12 + 4 + 1) \
        + n_q * (12 + 12 + 1) + (36 + 6 + 1) * 4


def check_k4(tag: str, got, ref) -> None:
    """K4 against its plain version: n_valid and the plane set bit-identical,
    the sums within the reference's tolerances."""
    jtj, jte, nv, pl = got
    jtj0, jte0, nv0, pl0 = ref
    if int(nv) != int(nv0):
        fail(f"K4 {tag}: n_valid {int(nv)} vs plain {int(nv0)}")
    for field in ("ok", "centroid", "normal"):
        a, b = getattr(pl, field), getattr(pl0, field)
        if not torch.equal(a, b):
            d = (a.float() - b.float()).abs().reshape(a.shape[0], -1)
            fail(f"K4 {tag}: plane {field} differs from the plain version in "
                 f"{int((d != 0).any(-1).sum())} queries (max "
                 f"{float(d.max()):.3e})")
    scale = float(jtj0.abs().max())
    escale = float(jte0.abs().max()) + 1e-9
    if float((jtj - jtj0).abs().max()) > JTJ_RTOL * scale \
            or float((jte - jte0).abs().max()) > JTE_RTOL * escale:
        fail(f"K4 {tag}: normal equations disagree with the plain version")


def k4_edge_cases(card: str) -> None:
    """K4 against its plain version on synthetic candidates at the widths
    and alignments it takes: C in K4_EDGE_CANDIDATES (1-byte, 4-byte and
    16-byte copies), with a masked-out query's flags off (as every gather
    leaves them) and set (which neither side reads), every flag off, and
    every query masked out; candidates near a plane through each query so
    that most planes pass the gates."""
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    n_q = 1000
    for c in K4_EDGE_CANDIDATES:
        q = (torch.rand((n_q, 3), generator=g) * 40.0 - 20.0)
        uv = torch.rand((n_q, c, 2), generator=g) * 1.4 - 0.7
        w = torch.rand((n_q, c, 1), generator=g) * 0.002
        cand = (q[:, None, :] + torch.cat([uv, w], dim=-1)).to(dev)
        mask = (torch.rand((n_q,), generator=g) > 0.1).to(dev)
        set_flags = (torch.rand((n_q, c), generator=g) > 0.3).to(dev)
        flags = set_flags & mask[:, None]
        p_map = q.to(dev)
        sqrt_r = torch.sqrt(torch.clamp(torch.linalg.norm(p_map, dim=1),
                                        min=1e-6))
        cases = (("random flags", flags, mask),
                 ("flags set on masked queries", set_flags, mask),
                 ("every flag off", torch.zeros_like(flags), mask),
                 ("every query masked", torch.zeros_like(flags),
                  torch.zeros_like(mask)))
        n_valid = {}
        for tag, fl, m in cases:
            ref = lk.fit_and_linearize_candidates_plain(cand, fl, p_map,
                                                        sqrt_r, m)
            got = lk.fit_and_linearize_candidates(cand, fl, p_map, sqrt_r, m)
            again = lk.fit_and_linearize_candidates(cand, fl, p_map, sqrt_r,
                                                    m)
            torch.cuda.synchronize()
            check_k4(f"C={c}, {tag}", got, ref)
            if not all(torch.equal(a, b) for a, b in zip(
                    (*got[:3], *got[3]), (*again[:3], *again[3]))):
                fail(f"K4 C={c}, {tag}: two launches differ: not "
                     "deterministic")
            n_valid[tag] = int(ref[2])
        if c >= 32 and n_valid["random flags"] < 100:
            fail(f"K4 C={c}: only {n_valid['random flags']} valid rows: the "
                 "synthetic planes do not exercise the kernel")
        print(f"  K4 at C={c} ({n_q} queries): random flags (n_valid "
              f"{n_valid['random flags']}), flags set on masked queries, every "
              f"flag off, every query masked: plane set and n_valid bit-identical "
              f"to the plain version, sums inside the tolerances, two "
              f"launches bit-identical ({card})")


def hold_k4(label: str, vm, src, sqrt_r, p_on, p_off, card: str):
    """K4 against its plain version on the candidates that ``vm``'s gather
    gives one scan's queries, on-pose and perturbed; its planes feed K2.
    Then its device time beside an empty launch's, the bytes it moves and
    its bound. Returns (max abs error, times, bound, candidates per
    query)."""
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    err = 0.0
    for tag, p_map in (("on-pose", p_on), ("perturbed", p_off)):
        tag = f"{label} {tag}"
        cand, ok = loam.gather_candidates_at(vm, p_map, src.mask)
        got = lk.fit_and_linearize_candidates(cand, ok, p_map, sqrt_r,
                                              src.mask)
        ref = lk.fit_and_linearize_candidates_plain(cand, ok, p_map, sqrt_r,
                                                    src.mask)
        torch.cuda.synchronize()
        err = max(err, compare(f"K4 {tag}", got, ref))
        check_k4(tag, got, ref)
        print(f"  K4 {tag}: {cand.shape[1]} candidates per query, plane ok "
              f"{int(got[3].ok.sum())}; plane set (ok, centroid, normal) and "
              f"n_valid bit-identical to the plain version")
        again = lk.fit_and_linearize_candidates(cand, ok, p_map, sqrt_r,
                                                src.mask)
        if not all(torch.equal(a, b) for a, b in zip(
                (*got[:3], *got[3]), (*again[:3], *again[3]))):
            fail(f"K4 {tag}: two launches differ: not deterministic")
        # K4's planes serve K2 on the following iterations: at the same pose
        # K2 gives K4's sums (per thread there, per lane here, so they may
        # round apart)
        compare(f"K2 on K4's planes, {tag}",
                lk.plane_normal_equations(got[3], p_map, sqrt_r), got)
    # the gather, K4 and K2 of one refresh with sync debugging set to raise:
    # no hidden host read in the gathers or the wrapper
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cand, ok = loam.gather_candidates_at(vm, p_off, src.mask)
        lin = lk.fit_and_linearize_candidates(cand, ok, p_off, sqrt_r,
                                              src.mask)
        lk.plane_normal_equations(lin[3], p_on, sqrt_r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"  K4 {label}: gather + K4 + K2 ran with sync debugging set to "
          "raise (no host synchronisation)")
    cand, ok = loam.gather_candidates_at(vm, p_on, src.mask)
    t = {"k4": time_ms(lambda: lk.fit_and_linearize_candidates(
             cand, ok, p_on, sqrt_r, src.mask)),
         "k4_plain": time_ms(lambda: lk.fit_and_linearize_candidates_plain(
             cand, ok, p_on, sqrt_r, src.mask), 20),
         "gather": time_ms(lambda: loam.gather_candidates_at(vm, p_on,
                                                             src.mask), 20)}
    t["k4_dev"], t["k4_dev_how"] = kernel_device_ms_how(
        "fit_and_linearize_candidates",
        lambda: lk.fit_and_linearize_candidates(cand, ok, p_on, sqrt_r,
                                                src.mask))
    t["empty_dev"], t["empty_dev_how"] = kernel_device_ms_how(
        "empty_kernel", lambda: lk.empty_launch(src.xyz.device))
    n_cand = int(cand.shape[1])
    n_valid, n_ok = int(src.mask.sum()), int(ok.sum())
    if int(ok[~src.mask].sum()):
        fail(f"K4 {label}: a masked-out query has a set candidate flag")
    bd = bounds(src.capacity, n_valid, n_cand, n_cand_ok=n_ok)["k4"]
    t["k4_bytes"] = k4_bytes(ok, src.mask)
    dev = t["k4_dev"]
    print(f"  K4 {label}: an empty launch takes {1e3 * t['empty_dev']:.2f} "
          f"us of device time ({t['empty_dev_how']}) ({card})")
    print(f"  K4 {label}: median {t['k4']:.4f} ms per wrapper call, device "
          f"time of the kernel {1e3 * dev:.2f} us ({t['k4_dev_how']}; the "
          f"earlier one-warp-per-query kernel: 26.2 us corner / 27.6 us "
          f"table, PERF.md) = "
          f"{100 * bd[0] / dev:.1f} % of the bound's rate; it moves "
          f"{t['k4_bytes'] / 1e6:.3f} MB against the bound's "
          f"{bd[0] * HBM_BYTES_PER_S / 1e3 / 1e6:.3f} MB; plain "
          f"{t['k4_plain']:.4f} ms, the torch gather before it "
          f"{t['gather']:.4f} ms; bound {1e3 * bd[0]:.3f} us by {bd[1]} "
          f"({n_valid} valid queries of {src.capacity} x C={n_cand} flags, "
          f"{n_ok} set flags x 12 B of coordinates) ({card})")
    return err, t, bd, n_cand


def target_k3_bound(kind: str, vm, src, pose, gathers: int, iters: int):
    """K3's bound on a dense or table target from one start: what its K1
    phases need per gather at the start pose (dense: the x of every slot of
    the 8 rows, for the padding test, and 8 more bytes per set point; table:
    a key and a count per cell, 12 bytes per set point), the scan once; its
    operations as K1's and K2's."""
    from simpleslam_tpu_torch.ops import geometry as geo
    from simpleslam_tpu_torch.ops import loam

    _, ok = loam.gather_candidates_at(
        vm, geo.transform_points(pose, src.xyz), src.mask)
    n_q, n_cand = ok.shape
    n_valid, n_set = int(src.mask.sum()), int(ok.sum())
    if kind == "dense":
        per_gather = n_valid * n_cand * 4 + n_set * 8
    else:
        per_gather = n_valid * 27 * 8 + n_set * 12
    nbytes = gathers * per_gather + n_q * (12 + 1) + 64 + 80
    ops = gathers * n_valid * (24 * n_cand + 520) \
        + (iters - gathers) * n_q * 120 + iters * 1500
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def scan2map_on_targets(system, streams, result, targets, card: str):
    """``loam.scan2map`` on the dense and the sorted-table target over the
    streamed path's last N_FUSED_SCANS scans, from the recorded pose and from
    the offset start, under sync debugging set to raise: K3 once per
    registration, no K4, K2 or plain launch; the poses beside the merged
    map's from the same start; then K3 against ``gn_loop_stepwise`` on the
    same cases (guard off and on), and K3's device time and bound on the last
    scan. Returns ({path name: launch counts}, {kind: K3 times and bound})."""
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import streamed

    dev = system.register.device
    cap = int(result.extras["scan_capacity"])
    n = len(streams.scan_stamps)
    idx = list(range(max(1, n - N_FUSED_SCANS), n))
    rows, _ = prep_scans(system, streams, idx, cap)
    rows_d = torch.from_numpy(rows).to(dev)
    merged = system.map_manager.get_target()
    cases = []
    for k, j in enumerate(idx):
        src = streamed.upload_cloud(rows_d[k])
        pose = torch.tensor(result.poses[j].astype(np.float32), device=dev)
        for start in (pose, offset_pose(pose)):
            cases.append((src, start, loam.scan2map(src, merged, start)))
    out, k3 = {}, {}
    one = time_ms(lambda: lk.barrier_probe(dev, 1))
    barrier = (time_ms(lambda: lk.barrier_probe(dev, 257)) - one) / 256.0
    # ms per registration of the stepwise loop when it was these targets'
    # production loop (PERF.md section 6)
    before = {"dense": 13.75, "table": 12.53}
    for kind, vm in targets.items():
        name = f"scan2map_{kind}"
        # the first launch of K3 on this kind of target, outside the count
        loam.scan2map(cases[0][0], vm, cases[0][1])
        torch.cuda.synchronize()
        lk.reset_counts()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = [loam.scan2map(src, vm, start) for src, start, _ in cases]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"k3": lk.K3_LAUNCHES, "k4": lk.K4_LAUNCHES,
                    "k2": lk.K2_LAUNCHES, "k1": lk.K1_LAUNCHES,
                    "plain": (lk.K1_PLAIN_CUDA_CALLS + lk.K2_PLAIN_CUDA_CALLS
                              + lk.K3_PLAIN_CUDA_CALLS
                              + lk.K4_PLAIN_CUDA_CALLS)}
        counts = torch.stack([torch.stack([
            r.iters, r.n_gathers, r.converged.to(torch.int32)])
            for r in res]).cpu().numpy()
        gathers = int(counts[:, 1].sum())
        others = int((counts[:, 0] - counts[:, 1]).sum())
        t_gap = r_gap = 0.0
        for r, (_, _, ref) in zip(res, cases):
            p, q = r.pose.cpu().numpy(), ref.pose.cpu().numpy()
            if not np.isfinite(p).all():
                fail(f"{name}: non-finite pose")
            t_gap = max(t_gap, float(np.linalg.norm(
                p[:3, 3].astype(np.float64) - q[:3, 3])))
            r_gap = max(r_gap, _rot_angle(p[:3, :3], q[:3, :3]))
        print(f"{name}: {len(res)} registrations of scans {idx[0]}-{idx[-1]} "
              f"in {wall:.3f} s = {1e3 * wall / len(res):.3f} ms each (the "
              f"stepwise loop as the production loop: {before[kind]} ms), with "
              f"sync debugging set to "
              f"raise; gathers {gathers}, other iterations {others}, "
              f"converged {int(counts[:, 2].sum())}; K3 launches "
              f"{launches['k3']}, K4 / K2 / K1 launches {launches['k4']} / "
              f"{launches['k2']} / {launches['k1']}, plain CUDA calls "
              f"{launches['plain']}; largest gap to the merged map's pose "
              f"{t_gap:.3e} m / {r_gap:.3e} rad (limits {TARGET_GAP_T_MAX} / "
              f"{TARGET_GAP_R_MAX}) ({card})")
        if launches["k3"] != len(res):
            fail(f"{name}: K3 launches {launches['k3']} for {len(res)} "
                 "registrations")
        if launches["k4"] or launches["k2"] or launches["k1"] \
                or launches["plain"]:
            fail(f"{name}: another kernel or a plain version ran: {launches}")
        if counts[:, 2].sum() < 0.9 * len(res):
            fail(f"{name}: only {int(counts[:, 2].sum())} of {len(res)} "
                 "registrations converged")
        if t_gap > TARGET_GAP_T_MAX or r_gap > TARGET_GAP_R_MAX:
            fail(f"{name}: pose {t_gap:.3e} m / {r_gap:.3e} rad from the "
                 "merged map's")
        # K3 against its plain version on the same cases (not counted)
        tally = FusedTally()
        for c, (src, start, _) in enumerate(cases):
            for degen in (0.0, DEGEN):
                tally.compare(f"{name} case {c}, guard "
                              f"{'on' if degen else 'off'}", src, vm, start,
                              degen, verbose=False)
        print(f"{name}: ", end="")
        tally.check()
        # K3's time on this target from the last scan's recorded pose
        src, start, _ = cases[-2]
        r0 = loam.scan2map(src, vm, start)
        iters, g0 = int(r0.iters), int(r0.n_gathers)
        start_c = start.to(torch.float32).contiguous()
        t = {"ms": time_ms(lambda: loam.scan2map(src, vm, start)),
             "plain_ms": time_ms(lambda: loam.gn_loop_stepwise(src, vm, start),
                                 10)}
        t["device_ms"], t["device_ms_how"] = kernel_device_ms_how(
            "gn_loop_kernel", lambda: loam.scan2map(src, vm, start),
            lambda: lk.gn_loop_fused(src.xyz, src.mask, vm, start_c,
                                     loam.MAX_ITERS, 0.0))
        t["bound_ms"], t["bound_by"] = target_k3_bound(kind, vm, src, start,
                                                       g0, iters)
        t["barrier_floor_ms"] = iters * barrier
        t["launches"] = launches["k3"]
        t["max_abs_err"] = tally.t_err
        print(f"{name}: K3 from scan {idx[-1]}'s recorded pose ({iters} "
              f"iterations, {g0} K1 phases): median {t['ms']:.4f} ms per "
              f"call, device {1e3 * t['device_ms']:.2f} us "
              f"({t['device_ms_how']}) = "
              f"{100 * t['bound_ms'] / t['device_ms']:.2f} % of the bound's "
              f"rate (bound {1e3 * t['bound_ms']:.3f} us by {t['bound_by']}, "
              f"barrier floor {1e3 * t['barrier_floor_ms']:.2f} us); "
              f"stepwise {t['plain_ms']:.4f} ms ({card})")
        k3[kind] = t
        out[name] = {"k1": gathers, "k2": others, "k3": launches["k3"],
                     "k4": launches["k4"], "k1_standalone": 0,
                     "k2_standalone": 0, "plain": 0, "stepwise": 0,
                     "registrations": len(res)}
    return out, k3


def k4_phases(system, streams, result, card: str):
    """Phases 12 and 13 on the streamed full path's inputs. Returns (K4's
    kernels-line entry without its launches, {path name: launch counts},
    K3's times and bounds on the two targets)."""
    from simpleslam_tpu_torch.ops import geometry as geo
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.pipeline import streamed

    phase("K4 against its plain version on the streamed full inputs")
    k4_edge_cases(card)
    dev = system.register.device
    cap = int(result.extras["scan_capacity"])
    n = len(streams.scan_stamps)
    # a rebuild that still waited for its swap becomes the target, so the
    # merged map and the two maps built here hold the same submap
    system.map_manager.commit_pending_target()
    targets = other_targets(system)
    rows, cnts = prep_scans(system, streams, [n - 1], cap)
    src = streamed.upload_cloud(torch.from_numpy(rows).to(dev)[0])
    pose = torch.tensor(result.poses[n - 1].astype(np.float32), device=dev)
    sqrt_r = loam.source_sqrt_range(src)
    p_on = geo.transform_points(pose, src.xyz)
    p_off = geo.transform_points(offset_pose(pose), src.xyz)
    print(f"scan {n - 1} at scan capacity {cap} ({int(cnts[0])} valid)")
    held = {kind: hold_k4(f"{kind} target", vm, src, sqrt_r, p_on, p_off, card)
            for kind, vm in targets.items()}
    phase("scan2map on the dense and the sorted-table target (K3)")
    by_path, k3_targets = scan2map_on_targets(system, streams, result,
                                              targets, card)
    err, t, bd, n_cand = held["dense"]
    err_t, t_t, bd_t, n_cand_t = held["table"]
    entry = {
        "name": "fit_and_linearize_candidates", "route": "cuda",
        "source": "simpleslam_tpu_torch/csrc/loam_kernels.cu",
        "replaces": "simpleslam_tpu/ops/loam_pallas.py:208",
        "max_abs_err": max(err, err_t),
        "ms": t["k4"], "plain_ms": t["k4_plain"], "bound_ms": bd[0],
        "bound_by": bd[1],
        # no single PyTorch call does a 5-round selection, a 3x3 eigensolve
        # and a gated 28-term reduction
        "library_ms": None,
        "timed_on": f"corner gather of the dense map, Q={cap}, C={n_cand}",
        "device_ms": t["k4_dev"], "device_ms_how": t["k4_dev_how"],
        "empty_launch_device_ms": t["empty_dev"],
        "bytes_moved": t["k4_bytes"],
        "sorted_table": {"candidates": n_cand_t, "ms": t_t["k4"],
                         "device_ms": t_t["k4_dev"],
                         "device_ms_how": t_t["k4_dev_how"],
                         "bytes_moved": t_t["k4_bytes"],
                         "plain_ms": t_t["k4_plain"], "bound_ms": bd_t[0],
                         "bound_by": bd_t[1]},
        "gather_ms": {"dense": t["gather"], "table": t_t["gather"]},
    }
    return entry, by_path, k3_targets


# -- the recorded-data path ---------------------------------------------------
KITTI_SCANS = 60
LZ4_SCANS = 5
REPLAY_APE_MAX = 0.1      # metres, the loop-closure test's ATE bound
# A replay from a file against the in-memory run of the same config at the
# CLI's batch size: the file carries the same f32 scans, and stamps that
# round-trip through ROS sec/nsec (bag) or six decimals (KITTI), so every
# scan's pose agrees within the bound of tests/test_torch_recorded.py and the
# keyframes are the same scans. ``tum.txt`` rounds to a millimetre per axis,
# so two such files may sit one more step apart on each axis.
REPLAY_POSE_TOL = 1e-3    # metres, per scan
REPLAY_TUM_TOL = REPLAY_POSE_TOL + 3 ** 0.5 * 1e-3   # metres, per keyframe


def replay_cli(name: str, argv, n_scans: int, gt_tum: str, out_dir: str,
               vis_dir: str, card: str):
    """One ``app.main`` replay of recorded data; checks its artifacts, its
    kernel counts and the APE of the keyframe trajectory it wrote. Returns
    the launch counts, the APE and the ``run_streamed`` result that
    ``app.main`` got (observed on its way through, as GnRecorder does)."""
    from simpleslam_tpu_torch.eval import evaluate
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import app, streamed

    seen = []
    orig = streamed.run_streamed

    def observed(*args, **kwargs):
        seen.append(orig(*args, **kwargs))
        return seen[-1]

    torch.cuda.reset_peak_memory_stats()
    lk.reset_counts()
    t0 = time.perf_counter()
    streamed.run_streamed = observed
    try:
        with GnRecorder() as rec:
            rc = app.main(argv)
            torch.cuda.synchronize()
    finally:
        streamed.run_streamed = orig
    wall = time.perf_counter() - t0
    if len(seen) != 1:
        fail(f"{name}: app.main called run_streamed {len(seen)} times")
    launches = launch_counts(rec)
    if rc != 0:
        fail(f"{name}: app.main returned {rc}")
    for f in ("tum.txt", "0.pcd", "fg.g2o"):
        if not os.path.isfile(os.path.join(out_dir, f)):
            fail(f"{name}: {f} was not written to {out_dir}")
    plys = [f for f in os.listdir(vis_dir) if f.endswith(".ply")]
    if not plys:
        fail(f"{name}: the visualizer wrote no PLY file")
    ape, rpe = evaluate(gt_tum, os.path.join(out_dir, "tum.txt"), delta=1,
                        align=False)
    print(f"{name}: app.main (prewarm, replay, shutdown) {wall:.2f} s for "
          f"{n_scans} scans; {len(plys)} PLY files; keyframe APE {ape.row()}; "
          f"RPE(delta=1) rmse {rpe.rmse:.4f} m; {describe_launches(launches)} "
          f"({card})")
    if not (launches["k3"] == launches["registrations"] == n_scans - 1):
        fail(f"{name}: K3 launches {launches['k3']}, registrations "
             f"{launches['registrations']}, scans {n_scans}")
    if launches["plain"] or launches["stepwise"] or launches["k4"]:
        fail(f"{name}: a plain version or K4 ran on this path: {launches}")
    if not ape.rmse < REPLAY_APE_MAX:
        fail(f"{name}: keyframe APE {ape.rmse} >= {REPLAY_APE_MAX} m")
    return launches, ape, seen[0]


def hold_replay(name: str, result, out_dir: str, streams, root: str,
                card: str) -> None:
    """The replay's per-scan poses and the keyframe file it wrote against an
    in-memory run of ``streams`` on the card, same config, same batch size
    (``run_streamed``'s default, which ``app.main`` uses)."""
    from simpleslam_tpu_torch.utils import fileio

    _, _, mem = streamed_run(f"in-memory full run beside the {name}",
                             BENCH_FULL, streams, card, prewarm=True,
                             sync_every=16, probe_scans=0)
    if result.poses.shape != mem.poses.shape:
        fail(f"{name}: {len(result.poses)} poses, in memory {len(mem.poses)}")
    gap = np.linalg.norm(result.poses[:, :3, 3].astype(np.float64)
                         - mem.poses[:, :3, 3], axis=1)
    mem_tum = os.path.join(root, f"in_memory_{name.split()[0]}_tum.txt")
    fileio.write_tum(mem_tum, mem.extras["kf_stamps"], mem.extras["kf_poses"])
    st_a, po_a = fileio.load_tum(os.path.join(out_dir, "tum.txt"))
    st_b, po_b = fileio.load_tum(mem_tum)
    same_kf = len(st_a) == len(st_b) and np.array_equal(st_a, st_b)
    kf_gap = (float(np.linalg.norm(po_a[:, :3, 3] - po_b[:, :3, 3],
                                   axis=1).max()) if same_kf else float("nan"))
    print(f"{name} against the in-memory run of the same config in 16-scan "
          f"batches: largest per-scan pose gap {gap.max():.3e} m over "
          f"{len(gap)} scans (limit {REPLAY_POSE_TOL}); keyframes "
          f"{len(st_a)} vs {len(st_b)}, same stamps {same_kf}, largest gap "
          f"between the two tum.txt files {kf_gap:.3e} m (limit "
          f"{REPLAY_TUM_TOL:.3e}, both rounded to a millimetre) ({card})")
    if not gap.max() <= REPLAY_POSE_TOL:
        fail(f"{name}: a scan's pose is {gap.max()} m from the in-memory run's")
    if not same_kf or result.keyframe_count != mem.keyframe_count:
        fail(f"{name}: keyframes differ from the in-memory run's")
    if not kf_gap <= REPLAY_TUM_TOL:
        fail(f"{name}: a keyframe in tum.txt is {kf_gap} m from the in-memory "
             "run's")


def recorded_data(streams, full_result, card: str) -> dict:
    """Phase 14: the bench sequence as a bag and as a KITTI directory,
    through ``app.main`` in the bench's full config with the visualizer on."""
    from simpleslam_tpu_torch.eval import evaluate
    from simpleslam_tpu_torch.pipeline import bagio
    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.utils import fileio

    phase("recorded data: bag and KITTI replay (bench full config, vis on)")
    topics = ("/lidar_points", "/wheel_odom", "/imu")
    n = len(streams.scan_stamps)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        bag = os.path.join(root, "bench.bag")
        t0 = time.perf_counter()
        bagio.bag_from_streams(streams, bag)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = bagio.streams_from_bag(bag, *topics)
        t_read = time.perf_counter() - t0
        print(f"bag: {n} scans, {len(streams.wheel_stamps)} wheel and "
              f"{len(streams.imu_stamps)} IMU messages, "
              f"{os.path.getsize(bag) / 1e6:.1f} MB with uncompressed chunks; "
              f"written in {t_write:.2f} s, read back in {t_read:.2f} s (host)")
        if len(back.scans) != n or not all(
                np.array_equal(a, np.asarray(b, np.float32))
                for a, b in zip(back.scans, streams.scans)):
            fail("bag: the scans read back differ from those written")
        if np.abs(back.scan_stamps - streams.scan_stamps).max() > 1e-9:
            fail("bag: scan stamps moved by more than a nanosecond")
        head = head_of(sim, streams, LZ4_SCANS)
        lz4 = os.path.join(root, "head_lz4.bag")
        t0 = time.perf_counter()
        bagio.bag_from_streams(head, lz4, compression="lz4")
        t_lz4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        lz4_back = bagio.streams_from_bag(lz4, *topics)
        print(f"bag: {LZ4_SCANS} scans with lz4 chunks (the in-module codec), "
              f"{os.path.getsize(lz4) / 1e6:.2f} MB, written in {t_lz4:.2f} s, "
              f"read back in {time.perf_counter() - t0:.2f} s (host)")
        if not all(np.array_equal(a, np.asarray(b, np.float32))
                   for a, b in zip(lz4_back.scans, head.scans)):
            fail("lz4 bag: the scans read back differ from those written")

        gt_tum = os.path.join(root, "gt_tum.txt")
        fileio.write_tum(gt_tum, np.asarray(streams.scan_stamps),
                         streams.gt_poses)
        mem_tum = os.path.join(root, "in_memory_tum.txt")
        fileio.write_tum(mem_tum, full_result.extras["kf_stamps"],
                         full_result.extras["kf_poses"])
        ape_mem, _ = evaluate(gt_tum, mem_tum, delta=1, align=False)
        print(f"in-memory full run of this call: keyframe APE {ape_mem.row()}")

        def cfg_file(tag):
            vis_dir = os.path.join(root, f"vis_{tag}")
            path = os.path.join(root, f"cfg_{tag}.json")
            with open(path, "w") as f:
                json.dump(dict(BENCH_FULL, torch={"device": "cuda"},
                               vis={"enable": True, "out_dir": vis_dir}), f)
            return path, vis_dir, os.path.join(root, f"map_{tag}")

        cfg, vis_dir, out_dir = cfg_file("bag")
        out["bag_replay"], ape, res = replay_cli(
            "bag replay", ["--bag", bag, "--streamed", "--config", cfg,
                           "--out", out_dir], n, gt_tum, out_dir, vis_dir, card)
        print(f"bag replay: keyframe APE rmse {ape.rmse:.4f} m beside "
              f"{ape_mem.rmse:.4f} m for the bench's in-memory run in "
              f"{BENCH_SYNC_EVERY}-scan batches")
        hold_replay("bag replay", res, out_dir, streams, root, card)

        vdir = os.path.join(root, "kitti", "00", "velodyne")
        os.makedirs(vdir)
        t0 = time.perf_counter()
        for i in range(KITTI_SCANS):
            frame = np.zeros((len(streams.scans[i]), 4), np.float32)
            frame[:, :3] = streams.scans[i]
            frame.tofile(os.path.join(vdir, f"{i:06d}.bin"))
        with open(os.path.join(os.path.dirname(vdir), "times.txt"), "w") as f:
            f.writelines(f"{t:.6f}\n" for t in streams.scan_stamps[:KITTI_SCANS])
        print(f"KITTI directory: {KITTI_SCANS} frames written in "
              f"{time.perf_counter() - t0:.2f} s (host)")
        cfg, vis_dir, out_dir = cfg_file("kitti")
        out["kitti_replay"], _, res = replay_cli(
            "KITTI replay", ["--kitti", vdir, "--scans", str(KITTI_SCANS),
                             "--streamed", "--config", cfg, "--out", out_dir],
            KITTI_SCANS, gt_tum, out_dir, vis_dir, card)
        hold_replay("KITTI replay", res, out_dir,
                    head_of(sim, streams, KITTI_SCANS), root, card)
    return out


def memcheck_run(card: str) -> None:
    """Phase 16: the steady-state check of the streamed executor."""
    from simpleslam_tpu_torch import memcheck

    phase("memcheck (4 segments of 48 scans)")
    out = memcheck.run_memcheck(4, 48)
    print(f"memcheck ({card}): {json.dumps(out)}")
    if not out["ok"] or out["device"].split(":")[0] != "cuda":
        fail("memcheck: a steady-state check failed")


# -- the mesh path: sharded execution over torch.distributed ranks -----------
# Ranks are spawned processes. parallel/mesh.py's rule gives each rank a card
# of its own and NCCL where the machine has a card per rank; otherwise the
# ranks share cuda:0 in a gloo group (NCCL refuses two ranks on one card) and
# time-share it, so no time here is a scaling number. n = 1 runs in this
# process as a one-rank mesh, which sets no hook: it is the unsharded call.
MESH_RANKS = (2, 4)
MESH_POSE_T_TOL = 1e-4    # metres, sharded against the unsharded stepwise loop
MESH_POSE_R_TOL = 1e-6    # radians
MESH_BATCH_T_TOL = 5e-3   # metres, NDT / VGICP sharded batch (tests/test_parallel.py)
MESH_SOLVE_T_TOL = 1e-3   # metres, sharded solve against the one-rank PCG solve
MESH_PIPE_T_TOL = 5e-3    # metres, mesh pipeline against the single-rank run
MESH_BATCH_SCANS = 2      # scans of the NDT / VGICP sharded batches
MESH_RING = {"k": 256, "k_cap": 256, "e_cap": 512, "n_lc": 4,
             "max_iters": 6, "cg_iters": 32}   # posegraph_worker's defaults
MESH = {}                 # what the mesh path takes from earlier phases


def mesh_note(n: int) -> str:
    """What a mesh time of ``n`` ranks is, on this machine."""
    if n == 1:
        return "one rank in this process, no collective"
    if torch.cuda.device_count() >= n:
        return f"{n} ranks on {n} cards, NCCL: no scaling claimed"
    return "ranks time-share one card: these times are no scaling numbers"
_MESH_TMP = None


def _mesh_dir() -> str:
    global _MESH_TMP
    if _MESH_TMP is None:
        _MESH_TMP = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    return _MESH_TMP.name


def to_device(obj, dev):
    """Tensors, named tuples of them and dicts of those, on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: to_device(v, dev) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(f, dev) for f in obj))
    return obj


def mesh_capture(system, streams, result) -> None:
    """What the mesh path takes from the streamed full run, written once for
    the ranks: its last merged map, the same submap as a dense map and a
    sorted table, its last scan prepped at the latched capacity with the
    0.25 m offset of its recorded pose as the start, the two scans before it
    with the submap as NDT and VGICP targets, and its poses and keyframes."""
    import pickle

    from simpleslam_tpu_torch.ops import ndt as ndt_ops
    from simpleslam_tpu_torch.ops import vgicp as vgicp_ops
    from simpleslam_tpu_torch.pipeline import streamed

    mm = system.map_manager
    mm.commit_pending_target()
    dev = system.register.device
    cap = int(result.extras["scan_capacity"])
    n = len(streams.scan_stamps)
    submap, center = last_submap(system)
    targets = {"merged": mm.get_target(), **other_targets(system)}
    rows, _ = prep_scans(system, streams, [n - 1], cap)
    src = streamed.upload_cloud(torch.from_numpy(rows).to(dev)[0])
    pose = torch.tensor(result.poses[n - 1].astype(np.float32), device=dev)
    root = _mesh_dir()
    MESH["scan2map"] = os.path.join(root, "scan2map.pt")
    torch.save(to_device({"src": src, "init": offset_pose(pose),
                          "targets": targets}, "cpu"), MESH["scan2map"])
    k = MESH_BATCH_SCANS
    brows, _ = prep_scans(system, streams, list(range(n - k, n)), cap)
    dims = (192, 192, 32)   # the default tpu.dense_grid_dims

    def pose_at(i):
        return torch.tensor(result.poses[i].astype(np.float32))

    MESH["batch"] = os.path.join(root, "batch.pt")
    torch.save(to_device({
        "rows": torch.from_numpy(brows), "pose_prev": pose_at(n - k - 1),
        "pose_prev2": pose_at(n - k - 2),
        "odom2map": torch.eye(4, dtype=torch.float32),
        "targets": {"ndt": ndt_ops.build_target(submap, 1.0, center, dims),
                    "vgicp": vgicp_ops.build_target(submap, 1.0, center,
                                                    dims)}}, "cpu"),
        MESH["batch"])
    MESH["streams"] = os.path.join(root, "streams.pkl")
    with open(MESH["streams"], "wb") as f:
        pickle.dump(streams, f)
    be = system.backend
    MESH["full"] = (result.poses.copy(), int(result.keyframe_count),
                    int(be.n_lc_edges), result.extras["gn_records"])
    print(f"mesh inputs: scan {n - 1} ({int(src.mask.sum())} valid of {cap}), "
          f"merged map rows {tuple(targets['merged'].rows.shape)} int16, "
          f"{k} scans for the NDT / VGICP batches; written for the ranks")


def courtyard_streams():
    from simpleslam_tpu_torch.pipeline import simulate as sim

    return sim.simulate_sequence(
        make_courtyard(sim, LC_RADIUS, seed=0), n_scans=LC_SCANS, seed=2,
        radius=LC_RADIUS, speed=LC_SPEED, n_az=720, n_el=12, scan_noise=0.03)


def courtyard_reference():
    """The single-rank courtyard run of phase 7 (``tpu.sync_backend``, the
    schedule a mesh of several ranks runs its backend on): (streams,
    (poses, keyframes, closures, registrations)); run here when phase 7
    did not run."""
    if "courtyard" not in MESH:
        from simpleslam_tpu_torch.pipeline import app
        from simpleslam_tpu_torch.pipeline.streamed import run_streamed

        streams = courtyard_streams()
        system = app.SlamSystem(dict(LC_CFG, torch={"device": "cuda"}))
        with GnRecorder() as rec:
            res = run_streamed(system, streams)
        MESH["courtyard"] = (streams, (res.poses, int(res.keyframe_count),
                                       int(system.backend.n_lc_edges),
                                       rec.records))
    return MESH["courtyard"]


def _rank_counts(c: dict) -> dict:
    """A rank's kernel counters in the shape of ``launch_counts``: on the
    sharded path K1, K2 and K4 launch on their own (no K3, so no phases)."""
    return {"k3": c["K3_LAUNCHES"], "k4": c["K4_LAUNCHES"],
            "k1_standalone": c["K1_LAUNCHES"],
            "k2_standalone": c["K2_LAUNCHES"],
            "plain": (c["K1_PLAIN_CUDA_CALLS"] + c["K2_PLAIN_CUDA_CALLS"]
                      + c["K4_PLAIN_CUDA_CALLS"]),
            "stepwise": c["K3_PLAIN_CUDA_CALLS"],
            "sharded_stepwise": c["SHARDED_STEPWISE_CALLS"],
            "registrations": c["SHARDED_STEPWISE_CALLS"], "k1": 0, "k2": 0}


def _add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b[k] for k in b}


def _pose_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (float(np.linalg.norm(a[:3, 3] - b[:3, 3])),
            _rot_angle(a[:3, :3], b[:3, :3]))


def _same_on_ranks(name: str, results, key) -> None:
    first = key(results[0])
    for r, res in enumerate(results[1:], 1):
        if key(res) != first:
            fail(f"{name}: rank {r} differs from rank 0")


def _check_mesh_counts(name: str, c: dict, target: str, n_reg: int) -> None:
    need = "k1_standalone" if target == "merged" else "k4"
    if c[need] < 1 or c["sharded_stepwise"] != n_reg:
        fail(f"{name}: {need} launches {c[need]}, sharded loops "
             f"{c['sharded_stepwise']} for {n_reg} registrations")
    if c["plain"] or c["stepwise"] or c["k3"]:
        fail(f"{name}: plain versions, the unsharded stepwise loop or K3 ran "
             f"on CUDA: {c}")


def mesh_registration_check(n: int, res: dict, ref: dict, ref_k3: dict,
                            card: str, by_path: dict) -> None:
    """One world size's sharded registrations: with one rank bit-identical
    to the unsharded ``gn_loop`` (``ref_k3``, one launch of K3 each), with
    more within the tolerance of the unsharded stepwise loop (``ref``) with
    equal counts; two runs bit-identical; kernel counts."""
    total = {}
    for name, r in res.items():
        runs = r["runs"]
        if runs[0] != runs[1]:
            fail(f"mesh n={n} {name}: two runs differ")
        got, want = runs[0], ref[name]
        dt, dr = _pose_gap(got["pose"], want["pose"])
        k3t, k3r = _pose_gap(got["pose"], ref_k3[name]["pose"])
        counts_eq = ((got["iters"], got["gathers"], got["converged"])
                     == (want["iters"], want["gathers"], want["converged"]))
        print(f"  n={n} {name}: |dt| {dt:.3e} m, |dR| {dr:.3e} rad from the "
              f"unsharded stepwise loop, {k3t:.3e} m, {k3r:.3e} rad from "
              f"the unsharded gn_loop (K3); iterations {got['iters']} / "
              f"{want['iters']}, gathers {got['gathers']} / {want['gathers']}"
              f", n_valid {got['n_valid']} / {want['n_valid']}; "
              f"{r['stats']['collectives']} collectives in "
              f"{1e3 * r['stats']['collective_s']:.2f} ms, host-staged "
              f"{r['stats']['staged_calls']} calls / "
              f"{r['stats']['staged_bytes']} B over {len(runs)} runs "
              f"({card}; {mesh_note(n)})")
        c = _rank_counts(r["counts"])
        if n == 1:
            if got != ref_k3[name]:
                fail(f"mesh n=1 {name}: not bit-identical to the unsharded "
                     "gn_loop")
            c["k1"] = sum(x["gathers"] for x in runs)
            c["k2"] = sum(x["iters"] - x["gathers"] for x in runs)
            c["registrations"] = len(runs)
            if (c["k3"] != len(runs) or c["plain"] or c["stepwise"]
                    or c["sharded_stepwise"] or c["k4"]
                    or c["k1_standalone"] or c["k2_standalone"]):
                fail(f"mesh n=1 {name}: not one K3 launch per call: {c}")
        else:
            if not counts_eq or dt > MESH_POSE_T_TOL or dr > MESH_POSE_R_TOL:
                fail(f"mesh n={n} {name}: off the unsharded stepwise loop")
            _check_mesh_counts(f"mesh n={n} {name}", c, name, len(runs))
        total = _add_counts(total, c)
    if n > 1 and total["k2_standalone"] < 1:
        fail(f"mesh n={n}: K2 never launched: {total}")
    print(f"  n={n}: {describe_launches(total)}, sharded loops "
          f"{total['sharded_stepwise']}")
    by_path[f"mesh_registration_n{n}"] = total


def rank_block(inp: dict):
    """Rank 1's block of the n = 2 shard of the mesh path's scan: (block,
    sqrt_r, its queries at the start pose and at the offset, the merged
    map)."""
    from simpleslam_tpu_torch.ops import geometry as geo
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops.pointcloud import PointCloud

    src = inp["src"]
    q = src.xyz.shape[0]
    b = slice(q // 2, q)
    blk = PointCloud(src.xyz[b].contiguous(), src.intensity[b].contiguous(),
                     src.mask[b].contiguous())
    return (blk, loam.source_sqrt_range(blk),
            geo.transform_points(inp["init"], blk.xyz),
            geo.transform_points(offset_pose(inp["init"]), blk.xyz),
            inp["targets"]["merged"])


def rank_block_calls(inp: dict) -> dict:
    """One K1 and one K2 wrapper call on rank 1's block, as functions."""
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    blk, sqrt_r, p0, p1, merged = rank_block(inp)
    planes = lk.fit_and_linearize_merged(merged, p0, sqrt_r, blk.mask)[3]
    return {"k1": lambda: lk.fit_and_linearize_merged(merged, p0, sqrt_r,
                                                      blk.mask),
            "k2": lambda: lk.plane_normal_equations(planes, p1, sqrt_r)}


def rank_block_device_main(path: str) -> int:
    """``--block-device INPUTS``: ``call_device`` of K1 and K2 on rank 1's
    block of the inputs at ``path``, printed as the last line (JSON)."""
    environment()
    build()
    inp = to_device(torch.load(path, weights_only=False),
                    torch.device("cuda"))
    out = {k: call_device(fn) for k, fn in rank_block_calls(inp).items()}
    print(json.dumps({k: None if c is None else c._asdict()
                      for k, c in out.items()}))
    return 0


def rank_block_device(path: str) -> dict:
    """K1's and K2's ``call_device`` on rank 1's block, measured in a fresh
    process: in a whole run the profiler of this long-lived one comes back
    empty by phase 17."""
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--block-device", path], capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        fail(f"the rank block's device timing failed: {run.stderr[-2000:]}")
    got = json.loads(run.stdout.strip().splitlines()[-1])
    return {k: None if c is None else DeviceCall(**c) for k, c in got.items()}


def mesh_hold_kernels(inp: dict, card: str) -> dict:
    """K1, K4 (dense and table gathers) and K2 against their plain versions
    on rank 1's block of the n = 2 shard, at the start pose; times on it."""
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    blk, sqrt_r, p0, p1, merged = rank_block(inp)
    nq = blk.xyz.shape[0]
    err = {}
    got = lk.fit_and_linearize_merged(merged, p0, sqrt_r, blk.mask)
    err["k1"] = compare("mesh K1, rank 1 block", got,
                        lk.fit_and_linearize_merged_plain(merged, p0, sqrt_r,
                                                          blk.mask))
    err["k2"] = compare("mesh K2, rank 1 block",
                        lk.plane_normal_equations(got[3], p1, sqrt_r),
                        lk.plane_normal_equations_plain(got[3], p1, sqrt_r))
    k2_against_host("mesh K2, rank 1 block", lk.plane_normal_equations(
        got[3], p1, sqrt_r), got[3], p1, sqrt_r)
    calls = rank_block_calls(inp)
    t = {k: time_ms(fn) for k, fn in calls.items()}
    for k, c in rank_block_device(MESH["scan2map"]).items():
        print(f"  mesh {k.upper()}, rank 1's block ({nq} queries): "
              f"{describe_call(c)} ({CALL_HOW_FRESH}); wrapper {t[k]:.4f} ms "
              f"per call ({card})")
        one_launch_per_call(f"mesh {k.upper()}", c)
        t[k + "_dev"], t[k + "_dev_how"] = c.ms, CALL_HOW_FRESH
        t[k + "_launches"] = c.launches
    err["k4"] = 0.0
    for name in ("dense", "table"):
        cand, ok = loam.gather_candidates_at(inp["targets"][name], p0,
                                             blk.mask)
        g4 = lk.fit_and_linearize_candidates(cand, ok, p0, sqrt_r, blk.mask)
        r4 = lk.fit_and_linearize_candidates_plain(cand, ok, p0, sqrt_r,
                                                   blk.mask)
        err["k4"] = max(err["k4"], compare(f"mesh K4 {name}, rank 1 block",
                                           g4, r4))
        check_k4(f"mesh {name}, rank 1 block", g4, r4)
        t[f"k4_{name}"] = time_ms(lambda: lk.fit_and_linearize_candidates(
            cand, ok, p0, sqrt_r, blk.mask))
    print(f"  rank 1's block ({nq} queries): K1 {t['k1']:.4f} ms, K2 "
          f"{t['k2']:.4f} ms, K4 dense {t['k4_dense']:.4f} ms, K4 table "
          f"{t['k4_table']:.4f} ms per wrapper call ({card})")
    return {"max_abs_err": err, "ms": t, "queries": nq}


def mesh_pipeline_check(name: str, runs, ref: tuple, gt, ate_max: float,
                        card: str) -> dict:
    """A mesh pipeline against the single-rank run of the same config
    (``ref``: poses, keyframes, accepted closures and the K3 registrations'
    records). ``runs`` is every rank's results of two runs: a timed one,
    and one where every registration is also run unsharded, by K3 on the
    gathered scan from the same start against the same map
    (``workers._UnshardedBeside``). Checked: every rank and both runs
    bit-identical; every registration within phase 3's bounds of K3 on
    its own inputs (``POSE_T_TOL``, ``POSE_R_TOL``; at most
    ``COUNT_MISMATCH_MAX`` of them with other counts); keyframes, closures,
    ATE and the converged share. The per-scan gap to the single-rank run
    is printed with the registration where the two runs part: a start
    gap of rounding size there flips the plane set, and the chain carries
    the step (ROADMAP section 3, F6), so it is not bounded."""
    from simpleslam_tpu_torch.pipeline import simulate as sim

    ref_poses, ref_kf, ref_closures, (ref_starts, ref_res, ref_iters,
                                      ref_gathers) = ref
    timed, beside = [r[0] for r in runs], [r[1] for r in runs]
    for rs in (timed, beside):
        _same_on_ranks(name, rs, lambda r: (r["poses"], r["kf_poses"]))
        _same_on_ranks(name, rs, lambda r: r["backend"])
    r0 = timed[0]
    if beside[0]["poses"] != r0["poses"]:
        fail(f"{name}: two runs differ")
    poses = np.asarray(r0["poses"])
    err = np.linalg.norm(poses[:, :3, 3] - ref_poses[:, :3, 3], axis=1)
    ate = float(sim.ate_rmse(gt, poses, align=False))
    m = r0["mesh"]
    n_scans = len(poses)
    print(f"  {name}: {n_scans} scans on {m['ranks']} ranks ({m['backend']}) "
          f"in {r0['wall_s']:.2f} s = {r0['scans_per_s']:.2f} scans/s; "
          f"{m['collectives'] / n_scans:.2f} collectives per scan, "
          f"{1e3 * m['collective_s'] / max(m['collectives'], 1):.3f} ms each "
          f"(host staging included), host-staged {m['staged_calls']} calls / "
          f"{m['staged_bytes']} B ({card}; {mesh_note(m['ranks'])})")

    reg = np.asarray(beside[0]["registrations"], np.float64)
    starts = reg[:, :16].reshape(-1, 4, 4)
    got, got_c = reg[:, 16:32].reshape(-1, 4, 4), reg[:, 32:36]
    k3, k3_c = reg[:, 36:52].reshape(-1, 4, 4), reg[:, 52:56]
    same = np.array([_pose_gap(a, b) for a, b in zip(got, k3)])
    other = ((got_c[:, :2] != k3_c[:, :2]).any(1)
             | (got_c[:, 3] != k3_c[:, 3])
             | (np.abs(got_c[:, 2] - k3_c[:, 2]) > N_VALID_TOL))
    share = float(other.mean())
    keep = same[~other]
    flips = ", ".join(f"{g:.3e} m" for g in same[other, 0])
    print(f"  {name}: every registration against K3 on its own inputs: "
          f"{len(reg)} registrations, largest gap {keep[:, 0].max():.3e} m, "
          f"{keep[:, 1].max():.3e} rad; {int(other.sum())} with other "
          f"iterations, gathers, flag or valid rows ({100 * share:.2f} %"
          f"{'; their gaps ' + flips if flips else ''})")
    if (keep[:, 0].max() > POSE_T_TOL or keep[:, 1].max() > POSE_R_TOL
            or share > COUNT_MISMATCH_MAX):
        fail(f"{name}: a sharded registration is off K3 on its own inputs")

    res_gap = np.linalg.norm(got[:, :3, 3] - ref_res[:, :3, 3], axis=1)
    part = np.nonzero(res_gap > 1e-3)[0]
    firsts = {g: (int(np.nonzero(err > g)[0][0]) if (err > g).any()
                  else None) for g in (1e-4, 1e-3, MESH_PIPE_T_TOL)}
    print(f"  {name}: per-scan gap to the single-rank run: max "
          f"{err.max():.3e} m (scan {int(err.argmax())}); first scan past "
          f"1e-4 / 1e-3 / {MESH_PIPE_T_TOL:g} m: {firsts[1e-4]} / "
          f"{firsts[1e-3]} / {firsts[MESH_PIPE_T_TOL]}")
    if len(part):
        i = int(part[0])
        print(f"  {name}: the runs part at registration {i}: starts "
              f"{np.linalg.norm(starts[i, :3, 3] - ref_starts[i, :3, 3]):.3e}"
              f" m apart -> results {res_gap[i]:.3e} m apart (the one before:"
              f" {res_gap[i - 1] if i else 0.0:.3e} m); iterations "
              f"{int(got_c[i, 0])} / {int(ref_iters[i])}, gathers "
              f"{int(got_c[i, 1])} / {int(ref_gathers[i])}; on the mesh "
              f"run's own inputs K3 lies {same[i, 0]:.3e} m from the sharded "
              f"loop (iterations {int(k3_c[i, 0])}, valid rows "
              f"{int(k3_c[i, 2])} / {int(got_c[i, 2])})")
    print(f"  {name}: ATE {ate:.4f} m unaligned; keyframes "
          f"{r0['keyframe_count']} / {ref_kf}; closures {r0['lc_accepted']} "
          f"/ {ref_closures}; backend {r0['backend']}; every rank and both "
          f"runs bit-identical")
    if not np.isfinite(poses).all():
        fail(f"{name}: non-finite poses")
    if r0["keyframe_count"] != ref_kf or r0["lc_accepted"] != ref_closures:
        fail(f"{name}: keyframes or closures differ from the single-rank run")
    if not ate < ate_max or not r0["converged_frac"] > STREAMED_CONV_MIN:
        fail(f"{name}: ATE {ate} m or converged {r0['converged_frac']}")
    if m["backend"] == "nccl" and m["staged_calls"]:
        fail(f"{name}: NCCL ranks staged collectives through the host")
    c = _rank_counts(r0["counts"])
    _check_mesh_counts(name, c, "merged", n_scans - 1)
    if c["k2_standalone"] < 1:
        fail(f"{name}: K2 never launched")
    print(f"  {name}: {describe_launches(c)}")
    return c


def check_rank_devices(n: int, devs: list) -> None:
    """The ranks' backend is the rule's, NCCL ranks hold a card each, and
    the cross-rank sum of the rank ids is right."""
    from simpleslam_tpu_torch.parallel import mesh as pmesh

    want = pmesh.choose_backend(n, "cuda", torch.cuda.device_count())
    print(f"  {n} ranks: backend {[d['backend'] for d in devs]} (the rule: "
          f"{want}), devices {[d['device'] for d in devs]}")
    if any(d["backend"] != want for d in devs):
        fail(f"mesh n={n}: the ranks' backend is not the rule's {want}")
    if want == "nccl" and len({d["device"] for d in devs}) != n:
        fail(f"mesh n={n}: NCCL ranks share a card")
    if any(d["psum"] != n * (n - 1) / 2 for d in devs):
        fail(f"mesh n={n}: the cross-rank sum is wrong")


def mesh_paths(card: str) -> dict:
    """The mesh path (phase 17): sharded registration on n = 1 (here), 2 and
    4 ranks, the kernels on a rank's block, the NDT and VGICP sharded
    batches, the sharded solve in its three modes, and the mesh pipeline
    (bench full config and the courtyard loop) on 2 ranks. Returns
    {path name: launch counts of rank 0}."""
    import pickle

    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.parallel import mesh as pmesh
    from simpleslam_tpu_torch.parallel import multihost
    from simpleslam_tpu_torch.parallel.dist_posegraph import (
        _ring_graph, sharded_solve)
    from simpleslam_tpu_torch.parallel.dist_registration import (
        sharded_scan2map)
    from simpleslam_tpu_torch.parallel.workers import _counts, _loam_row
    from simpleslam_tpu_torch.pipeline import streamed

    phase("mesh: sharded execution over torch.distributed ranks")
    n_cards = torch.cuda.device_count()
    for n in MESH_RANKS:
        print(f"mesh: rule of parallel/mesh.py with {n_cards} card(s): {n} "
              f"ranks -> {pmesh.choose_backend(n, 'cuda', n_cards)} "
              f"({mesh_note(n)}; {card})")
    dev = torch.device("cuda")
    by_path = {}
    inp = to_device(torch.load(MESH["scan2map"], weights_only=False), dev)
    held = mesh_hold_kernels(inp, card)
    ref = {name: _loam_row(loam.gn_loop_stepwise(inp["src"], t,
                                                     inp["init"]))
           for name, t in inp["targets"].items()}
    ref_k3 = {name: _loam_row(loam.gn_loop(inp["src"], t, inp["init"]))
              for name, t in inp["targets"].items()}
    # n = 1: the one-rank mesh in this process; it sets no hook
    m1 = pmesh.make_mesh(1, ("dp",), device=dev)
    res1 = {}
    for name, t in inp["targets"].items():
        lk.reset_counts()
        pmesh.reset_stats()
        runs = [_loam_row(sharded_scan2map(m1)(inp["src"], t,
                                                   inp["init"]))
                for _ in range(2)]
        torch.cuda.synchronize()
        res1[name] = {"runs": runs, "counts": _counts(),
                      "stats": dict(pmesh.STATS)}
    mesh_registration_check(1, res1, ref, ref_k3, card, by_path)

    cy_streams, cy_ref = courtyard_reference()
    cy_path = os.path.join(_mesh_dir(), "courtyard.pkl")
    with open(cy_path, "wb") as f:
        pickle.dump(cy_streams, f)
    solve_modes = [{}, {"shard_cg": True}, {"shard_lin": True}]
    tasks2 = [
        {"fn": "devices_worker"},
        {"fn": "scan2map_worker", "payload": {"inputs": MESH["scan2map"],
                                              "reps": 2}},
        {"fn": "batch_worker", "payload": {"inputs": MESH["batch"]}},
        {"fn": "posegraph_worker", "payload": dict(
            MESH_RING, reps=1, return_poses=MESH_RING["k"],
            modes=solve_modes)},
    ]
    pipes = [{"config": dict(BENCH_FULL, torch={"device": "cuda"},
                             tpu={"mesh_devices": 2}),
              "streams": MESH["streams"], "sync_every": BENCH_SYNC_EVERY},
             {"config": dict(LC_CFG, torch={"device": "cuda"},
                             tpu=dict(LC_CFG["tpu"], mesh_devices=2)),
              "streams": cy_path, "sync_every": 16}]
    # each pipeline twice: timed, then with K3 beside every registration
    tasks2 += [{"fn": "pipeline_worker",
                "payload": dict(p, unsharded_beside=beside)}
               for p in pipes for beside in (False, True)]
    del inp
    torch.cuda.empty_cache()
    spawned = {}
    for n, tasks in ((2, tasks2), (4, tasks2[:2])):
        t0 = time.perf_counter()
        res = multihost.run_hosts(
            n, "simpleslam_tpu_torch.parallel.workers:tasks_worker",
            {"tasks": tasks}, timeout=600.0, device="cuda")
        print(f"mesh: {n} ranks ran {len(tasks)} task(s) in "
              f"{time.perf_counter() - t0:.1f} s (start-up included)")
        for line in multihost.LAST_LOGS[0][0].splitlines():
            if "torch.distributed backend" in line:
                print(f"  {line}")
        spawned[n] = [[t["result"] for t in r["tasks"]] for r in res]
        check_rank_devices(n, [r[0] for r in spawned[n]])

    phase("mesh: sharded registration on the streamed full inputs")
    for n in MESH_RANKS:
        per_rank = [r[1] for r in spawned[n]]
        _same_on_ranks(f"mesh n={n} registration", per_rank,
                       lambda r: {k: v["runs"] for k, v in
                                  r["targets"].items()})
        print(f"  n={n}: rank block {per_rank[0]['block']} queries, backend "
              f"{per_rank[0]['backend']}")
        if per_rank[0]["backend"] == "nccl" and any(
                v["stats"]["staged_calls"]
                for v in per_rank[0]["targets"].values()):
            fail(f"mesh n={n}: NCCL ranks staged collectives through the "
                 "host")
        mesh_registration_check(n, per_rank[0]["targets"], ref, ref_k3, card,
                                by_path)

    ranks = spawned[2]
    note2 = mesh_note(2)
    phase("mesh: NDT and VGICP sharded batches (2 ranks)")
    binp = to_device(torch.load(MESH["batch"], weights_only=False), dev)
    for kind, tgt in binp["targets"].items():
        _same_on_ranks(f"mesh {kind} batch", [r[2] for r in ranks],
                       lambda r: r[kind]["runs"])
        (_, _, _), packed = streamed._batch_body(
            binp["rows"], tgt, binp["pose_prev"], binp["pose_prev2"],
            binp["odom2map"], kind, True, 0.0)
        single = packed.cpu().numpy()
        meshed = np.asarray(ranks[0][2][kind]["runs"][0]["packed"])
        gap = float(np.abs(meshed[:, :16] - single[:, :16]).max())
        st = ranks[0][2][kind]["stats"]
        print(f"  {kind}: {MESH_BATCH_SCANS} scans, pose rows within "
              f"{gap:.3e} of the one-rank batch; {st['collectives']} "
              f"collectives in {1e3 * st['collective_s']:.2f} ms, "
              f"{ranks[0][2][kind]['seconds']:.2f} s on the ranks "
              f"({card}; {note2})")
        if not np.isfinite(meshed).all() or gap > MESH_BATCH_T_TOL:
            fail(f"mesh {kind} batch: {gap} off the one-rank batch")

    phase("mesh: sharded pose-graph solve, three modes (2 ranks)")
    g = _ring_graph(k=MESH_RING["k"], k_cap=MESH_RING["k_cap"],
                    e_cap=MESH_RING["e_cap"], n_lc=MESH_RING["n_lc"],
                    device=dev)
    one = sharded_solve(pmesh.make_mesh(1, ("kf",), device=dev),
                        max_iters=MESH_RING["max_iters"],
                        cg_iters=MESH_RING["cg_iters"])(g)
    one_t = one.poses[:, :3, 3].cpu().numpy()
    _same_on_ranks("mesh solve", [r[3] for r in ranks],
                   lambda r: [(m["poses"], m["cost"], m["cost0"])
                              for m in r["modes"]])
    for kw, r in zip(solve_modes, ranks[0][3]["modes"]):
        tag = ",".join(kw) or "replicated CG"
        gap = float(np.abs(np.asarray(r["poses"])[:, :3, 3] - one_t).max())
        print(f"  {tag}: cost {r['cost0']:.4f} -> {r['cost']:.6f}; "
              f"translations within {gap:.3e} m of the one-rank PCG solve; "
              f"{r['times_s'][0] * 1e3:.2f} ms per solve, "
              f"{r['collectives_per_solve']:.0f} collectives per solve in "
              f"{1e3 * r['collective_s_per_solve']:.2f} ms ({card}; "
              f"{note2})")
        if not r["cost"] < r["cost0"] or gap > MESH_SOLVE_T_TOL:
            fail(f"mesh solve {tag}: cost or poses off")

    phase("mesh: streamed pipeline on 2 ranks (bench full, courtyard)")
    with open(MESH["streams"], "rb") as f:
        ref_streams = pickle.load(f)
    by_path["mesh_full"] = mesh_pipeline_check(
        "mesh full", [r[4:6] for r in ranks], MESH["full"],
        ref_streams.gt_poses, STREAMED_ATE_MAX, card)
    by_path["mesh_courtyard"] = mesh_pipeline_check(
        "mesh courtyard", [r[6:8] for r in ranks], cy_ref,
        cy_streams.gt_poses, 0.1, card)
    if ranks[0][6]["lc_accepted"] < 1:
        fail("mesh courtyard: no closure accepted")
    staged = [r[k]["mesh"] for r in ranks[:1] for k in (4, 6)]
    print(f"mesh: host staging of the 2-rank pipelines' collectives (rank "
          f"0): {sum(s['staged_calls'] for s in staged)} calls, "
          f"{sum(s['staged_bytes'] for s in staged)} B ({card}; {note2})")
    MESH["held"] = held
    return by_path


# -- localization, hard worlds, large pose graphs, sustained closure ----------
LOC_ATE_MAX = 0.15        # tests/test_pipeline_full.py, tests/test_streamed_loc.py
LOC_RELOC_AT = 75         # the scan a relocalized run starts from
LOC_CAP_QUANTUM = 4096    # tpu.submap_capacity is the PCD's size rounded up


def subseq(sim, streams, lo: int, hi=None):
    """Scans ``lo:hi`` with the wheel and IMU messages of their span (the
    bench's ``_subseq``, bench.py:35-47)."""
    sl = slice(lo, hi)
    lo_t = streams.scan_stamps[lo] - 0.15
    hi_t = streams.scan_stamps[hi - 1] + 0.15 if hi is not None else np.inf
    w = (streams.wheel_stamps >= lo_t) & (streams.wheel_stamps < hi_t)
    i = (streams.imu_stamps >= lo_t) & (streams.imu_stamps < hi_t)
    return sim.SensorStreams(
        streams.scan_stamps[sl], streams.scans[sl], streams.gt_poses[sl],
        streams.wheel_stamps[w], streams.wheel_poses[w],
        streams.imu_stamps[i], streams.imu_quats[i])


def global_pcd(streams, root: str, card: str):
    """A mapping run of the bench's full config on the card that saves its
    keyframes (``tum.txt``, ``{i}.pcd``, ``fg.g2o``), and the global PCD of
    those keyframes at their saved poses (the reference's loc.cpp prep):
    (path, point count)."""
    from simpleslam_tpu_torch.pipeline import app
    from simpleslam_tpu_torch.pipeline.streamed import run_streamed
    from simpleslam_tpu_torch.utils import fileio

    map_dir = os.path.join(root, "map")
    os.makedirs(map_dir)
    system = app.SlamSystem(dict(BENCH_FULL, saveMapDir=map_dir,
                                 torch={"device": "cuda"}))
    t0 = time.perf_counter()
    res = run_streamed(system, streams, sync_every=BENCH_SYNC_EVERY)
    system.shutdown()
    stamps, poses = fileio.load_tum(map_dir)
    if len(stamps) != res.keyframe_count or not len(stamps):
        fail(f"localization: the mapping run saved {len(stamps)} keyframes "
             f"of {res.keyframe_count}")
    clouds = []
    for i in range(len(stamps)):
        xyz, _ = fileio.load_pcd(os.path.join(map_dir, f"{i}.pcd"))
        R, t = poses[i][:3, :3], poses[i][:3, 3]
        clouds.append(xyz @ R.T.astype(np.float32) + t.astype(np.float32))
    pts = np.concatenate(clouds)
    pcd = os.path.join(root, "global.pcd")
    fileio.save_pcd(pcd, pts)
    print(f"localization: mapping run (bench full config, {len(res.poses)} "
          f"scans) and save in {time.perf_counter() - t0:.2f} s; "
          f"{len(stamps)} keyframes make a global PCD of {len(pts)} points "
          f"({card})")
    return pcd, len(pts)


def loc_run(name: str, cfg: dict, pcd: str, streams, card: str,
            how: str, start: int = 0) -> dict:
    """One localization run against the global PCD: ``run_streamed`` in
    32-scan batches or ``run_offline``, from scan ``start`` (after a reloc
    to its true pose when ``start`` > 0). Every scan is registered (the
    static map needs no seed scan), by one K3 launch each; no keyframe."""
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import app
    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.pipeline.streamed import run_streamed

    phase(name)
    system = app.SlamSystem(cfg, pcd_file=pcd)
    mm = system.map_manager
    if mm.is_mapping or mm.is_submap_empty():
        fail(f"{name}: the global map did not load as a static target")
    sub = subseq(sim, streams, start)
    if start:
        if not np.linalg.norm(sub.gt_poses[0][:3, 3]) > 3.0:
            fail(f"{name}: scan {start} is too near the identity start")
        system.lidar_odometry.set_reloc_flag(sub.gt_poses[0].copy())
    torch.cuda.reset_peak_memory_stats()
    lk.reset_counts()
    with GnRecorder() as rec:
        if how == "streamed":
            result = run_streamed(system, sub, sync_every=BENCH_SYNC_EVERY)
        else:
            result = app.run_offline(system, sub)
        torch.cuda.synchronize()
    launches = launch_counts(rec)
    n = len(sub.scan_stamps)
    ate = sim.ate_rmse(sub.gt_poses, result.poses, align=False)
    if how == "streamed":
        report_streamed(name, result, n, ate, launches, card)
    else:
        print(f"{name}: {n} scans in {result.wall_time:.2f} s = "
              f"{n / result.wall_time:.2f} scans/s end to end; ATE "
              f"{ate:.6f} m, keyframes {result.keyframe_count}, converged "
              f"{result.converged_frac:.3f}, {describe_launches(launches)} "
              f"({card})")
    check_path(name, result, n, ate, LOC_ATE_MAX, STREAMED_CONV_MIN,
               launches, n_reg=n)
    if result.keyframe_count != 0:
        fail(f"{name}: localization made {result.keyframe_count} keyframes")
    if how == "streamed":
        batch_probe(name, system, sub, result, BENCH_SYNC_EVERY, card)
    return launches


def loc_paths(streams, card: str) -> dict:
    """Localization mode (``SlamSystem(pcd_file=...)``) at full width."""
    phase("localization: global PCD from a mapping run")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loc_") as root:
        pcd, n_pts = global_pcd(streams, root, card)
        cap = -(-n_pts // LOC_CAP_QUANTUM) * LOC_CAP_QUANTUM
        print(f"localization: tpu.submap_capacity {cap} holds the global "
              f"PCD's {n_pts} points (a larger cloud is cut at load)")
        cfg = {"mode": "lo", "saveMapDir": "", "backend": {"enable": False},
               "frontend": {"pcr": "loam"}, "tpu": {"submap_capacity": cap},
               "torch": {"device": "cuda"}}
        out["loc_streamed"] = loc_run("localization, streamed", cfg, pcd,
                                      streams, card, "streamed")
        out["loc_offline"] = loc_run("localization, offline", cfg, pcd,
                                     streams, card, "offline")
        out["loc_reloc"] = loc_run(
            f"relocalization at scan {LOC_RELOC_AT}, streamed", cfg, pcd,
            streams, card, "streamed", start=LOC_RELOC_AT)
    return out


# the bench's hard-geometry configs (bench.py:332-353, 406-444)
HARD_SCANS = 100
HARD_WARMUP = 15
HARD_GUARD = {"pcr": "loam", "degeneracy_guard": True}
HARD_WORLDS = (
    ("adversarial", lambda sim: sim.make_adversarial_world(seed=5),
     {"mode": "lo", "backend": {"enable": False}, "frontend": HARD_GUARD}, {}),
    ("corridor", lambda sim: sim.make_corridor_world(),
     {"mode": "lio", "backend": {"enable": False}, "frontend": HARD_GUARD},
     {"loop": False}),
    ("forest_dynamic", lambda sim: sim.make_forest_world(seed=3),
     {"mode": "lo", "backend": {"enable": False}, "frontend": HARD_GUARD},
     {"n_dynamic": 6}),
)
CORRIDOR_SIDE_MAX = 0.1   # metres, lateral and vertical (tests/test_adversarial.py)
CORRIDOR_YAW_MAX = 0.03   # radians
CORRIDOR_CPU_GAP = 1e-3   # metres per scan, card against the port on the CPU


def _yaw(poses: np.ndarray) -> np.ndarray:
    return np.arctan2(poses[:, 1, 0], poses[:, 0, 0])


def hard_world_run(name: str, make, cfg: dict, seq_kw: dict, card: str):
    """``run_hard_world`` of bench.py: 100 scans (``simulate_sequence``
    defaults, seed 2), 15 of warm-up through ``run_streamed``, then the rest
    on the same system, scored on those. Returns (launch counts of both
    calls, streams, the scored result)."""
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import app
    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.pipeline.streamed import run_streamed

    phase(f"hard world: {name} (bench config, {HARD_SCANS} scans)")
    t0 = time.perf_counter()
    streams = sim.simulate_sequence(make(sim), n_scans=HARD_SCANS, seed=2,
                                    **seq_kw)
    print(f"{name}: simulated {HARD_SCANS} scans in "
          f"{time.perf_counter() - t0:.1f} s (host numpy, not part of the "
          "path)")
    system = app.SlamSystem(dict(cfg, torch={"device": "cuda"}))
    torch.cuda.reset_peak_memory_stats()
    lk.reset_counts()
    with GnRecorder() as rec:
        run_streamed(system, subseq(sim, streams, 0, HARD_WARMUP))
        t0 = time.perf_counter()
        result = run_streamed(system, subseq(sim, streams, HARD_WARMUP))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = launch_counts(rec)
    scored = subseq(sim, streams, HARD_WARMUP)
    n = len(scored.scan_stamps)
    ate = sim.ate_rmse(scored.gt_poses, result.poses, align=False)
    err = np.abs(result.poses[:, :3, 3] - scored.gt_poses[:, :3, 3]).max(0)
    print(f"{name}: {n} scored scans in {dt:.2f} s = {n / dt:.2f} scans/s; "
          f"ATE {ate:.4f} m (unaligned), converged "
          f"{result.converged_frac:.3f}; worst |error| x / y / z "
          f"{err[0]:.4f} / {err[1]:.4f} / {err[2]:.4f} m; "
          f"{describe_launches(launches)} ({card})")
    # the warm-up seeds the map with its first scan; every other scan of
    # the two calls is one registration
    # the corridor's along-track error rides the wheel odometry, which the
    # streamed ATE limit does not describe: corridor_against_cpu holds it
    check_path(name, result, n, ate,
               None if name == "corridor" else STREAMED_ATE_MAX,
               STREAMED_CONV_MIN, launches, n_reg=HARD_SCANS - 1)
    batch_probe(name, system, scored, result, BENCH_SYNC_EVERY, card)
    return launches, streams, result


def corridor_against_cpu(streams, result, cfg: dict, card: str) -> None:
    """The corridor's bounds: lateral, vertical and yaw as
    tests/test_adversarial.py sets them; along the corridor, where the
    guard zeroes the step and x rides the wheel odometry, every scan within
    ``CORRIDOR_CPU_GAP`` of the port's own CPU run of the same streams (the
    plain loop, torch's eigensolve) in this call."""
    from simpleslam_tpu_torch.pipeline import app
    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.pipeline.streamed import run_streamed

    gt = streams.gt_poses[HARD_WARMUP:]
    err = result.poses[:, :3, 3] - gt[:, :3, 3]
    yaw = np.abs(_yaw(result.poses) - _yaw(gt)).max()
    t0 = time.perf_counter()
    cpu = app.SlamSystem(dict(cfg, torch={"device": "cpu"}))
    run_streamed(cpu, subseq(sim, streams, 0, HARD_WARMUP))
    ref = run_streamed(cpu, subseq(sim, streams, HARD_WARMUP))
    gap = np.linalg.norm(result.poses[:, :3, 3] - ref.poses[:, :3, 3], axis=1)
    ate_cpu = sim.ate_rmse(gt, ref.poses, align=False)
    print(f"corridor: worst lateral {np.abs(err[:, 1]).max():.4f} m, "
          f"vertical {np.abs(err[:, 2]).max():.4f} m, yaw {yaw:.5f} rad, "
          f"along the corridor {np.abs(err[:, 0]).max():.4f} m; the port on "
          f"the CPU (run in {time.perf_counter() - t0:.1f} s): ATE "
          f"{ate_cpu:.4f} m, worst along the corridor "
          f"{np.abs(ref.poses[:, 0, 3] - gt[:, 0, 3]).max():.4f} m; card "
          f"against CPU at most {gap.max():.3e} m per scan (scan "
          f"{HARD_WARMUP + int(gap.argmax())}) ({card})")
    if not (np.abs(err[:, 1]).max() < CORRIDOR_SIDE_MAX
            and np.abs(err[:, 2]).max() < CORRIDOR_SIDE_MAX
            and yaw < CORRIDOR_YAW_MAX):
        fail("corridor: the guard let a constrained direction drift")
    if not gap.max() < CORRIDOR_CPU_GAP:
        fail(f"corridor: a scan lies {gap.max()} m from the CPU run's")


def corridor_fixture(sim, rng):
    """tests/test_adversarial.py's corridor registration fixture, built on
    the card: a dense map (grid 2, dims (48, 48, 12), 24 points a voxel) of
    three scans at x = 5, 7 and 9 m, and a scan at x = 8 m from a start
    0.5 / 0.15 / 0.08 m off. Returns (map, scan, truth, start)."""
    from simpleslam_tpu_torch.ops import pointcloud as pcops
    from simpleslam_tpu_torch.ops import voxel as vox

    world = sim.make_corridor_world()
    base = np.eye(4)
    base[0, 3] = 5.0
    clouds = []
    for dx in (0.0, 2.0, 4.0):
        p = base.copy()
        p[0, 3] += dx
        scan = sim.simulate_scan(world, sim.sensor_from_body(p), rng=rng)
        clouds.append((scan @ p[:3, :3].T + p[:3, 3]).astype(np.float32))
    merged = pcops.from_numpy(np.concatenate(clouds), 98304, "cuda")
    ds = pcops.compact(vox.voxel_downsample(merged, 0.5), 32768)
    center = torch.tensor(base[:3, 3].astype(np.float32), device="cuda")
    vm = vox.build_dense_voxel_map(ds, 2.0, center, dims=(48, 48, 12),
                                   slab_size=24)
    T_b = base.copy()
    T_b[0, 3] = 8.0
    scan = sim.simulate_scan(world, sim.sensor_from_body(T_b), rng=rng)
    src = pcops.compact(vox.voxel_downsample(
        pcops.from_numpy(scan, 32768, "cuda"), 0.5), 8192)
    guess = T_b.copy()
    guess[:3, 3] += [0.5, 0.15, 0.08]
    return vm, src, T_b, guess


def _zeroed(w: np.ndarray, V: np.ndarray, floor: float) -> str:
    """The eigen-directions under the guard's floor, each by its largest
    component (tx, ty, tz, rx, ry, rz)."""
    names = ("tx", "ty", "tz", "rx", "ry", "rz")
    out = []
    for k in np.nonzero(w <= floor)[0]:
        v = V[:, k] / np.linalg.norm(V[:, k])
        j = int(np.argmax(np.abs(v)))
        out.append(f"{names[j]} {abs(v[j]):.4f} (eigenvalue {w[k]:.2f})")
    return "; ".join(out) or "none"


def corridor_guard_check(card: str) -> None:
    """K3 with the guard against ``gn_loop_stepwise`` on the corridor
    fixture: both meet the fixture's bounds, K3 lies within ``POSE_T_TOL``
    / ``POSE_R_TOL`` of the stepwise loop, the unguarded K3 wanders
    further along the corridor, and the directions each eigensolve (K3's
    Jacobi, torch's ``eigh``) zeroes at the start are printed."""
    from simpleslam_tpu_torch import native
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.ops import pointcloud as pcops
    from simpleslam_tpu_torch.pipeline import simulate as sim

    phase("hard world: the corridor registration fixture, K3 against the "
          "stepwise loop")
    vm, src, T_b, guess = corridor_fixture(sim, np.random.default_rng(0))
    start = torch.tensor(guess.astype(np.float32), device="cuda")
    before = (lk.K3_LAUNCHES, lk.K3_PLAIN_CUDA_CALLS)
    k3 = loam.gn_loop(src, vm, start, degen_per_row=DEGEN)
    k3_off = loam.gn_loop(src, vm, start, degen_per_row=0.0)
    step = loam.gn_loop_stepwise(src, vm, start, degen_per_row=DEGEN)
    if (lk.K3_LAUNCHES - before[0], lk.K3_PLAIN_CUDA_CALLS - before[1]) != \
            (2, 1):
        fail("corridor fixture: K3 and the stepwise loop did not each run")
    ests = {}
    for tag, res in (("K3, guard on", k3), ("stepwise, guard on", step),
                     ("K3, guard off", k3_off)):
        est = res.pose.cpu().numpy().astype(np.float64)
        ests[tag] = est
        print(f"corridor fixture, {tag}: x {est[0, 3] - guess[0, 3]:+.4f} m "
              f"from the prediction, y {est[1, 3] - T_b[1, 3]:+.4f} m, z "
              f"{est[2, 3] - T_b[2, 3]:+.4f} m from the truth; iterations "
              f"{int(res.iters)}, n_valid {int(res.n_valid)}")
    for tag in ("K3, guard on", "stepwise, guard on"):
        est = ests[tag]
        if not (abs(est[1, 3] - T_b[1, 3]) < 0.05
                and abs(est[2, 3] - T_b[2, 3]) < 0.05
                and abs(est[0, 3] - guess[0, 3]) < 0.2
                and np.linalg.norm(est[:3, 3] - T_b[:3, 3]) < 1.0):
            fail(f"corridor fixture, {tag}: outside the fixture's bounds")
    if not (abs(ests["K3, guard off"][0, 3] - guess[0, 3])
            > abs(ests["K3, guard on"][0, 3] - guess[0, 3])):
        fail("corridor fixture: the unguarded K3 did not wander further")
    gap = float(np.linalg.norm(ests["K3, guard on"][:3, 3]
                               - ests["stepwise, guard on"][:3, 3]))
    gap_r = _rot_angle(ests["K3, guard on"][:3, :3],
                       ests["stepwise, guard on"][:3, :3])
    # the first iteration's system (the planes fit at the start), and the
    # directions each guard's eigensolve puts under the floor
    cpu = pcops.PointCloud(*(t.cpu() for t in src))
    vm_cpu = type(vm)(*(t.cpu() if isinstance(t, torch.Tensor) else t
                        for t in vm))
    JtJ, _, n_valid = loam.build_normal_equations(cpu, vm_cpu, start.cpu())
    floor = DEGEN * float(n_valid)
    w_j, V_j = native.jacobi_eig6(JtJ.numpy())
    w_t, V_t = torch.linalg.eigh(JtJ.double().to("cuda"))
    print(f"corridor fixture: K3 against the stepwise loop, guard on: "
          f"{gap:.3e} m, {gap_r:.3e} rad; at the start (n_valid "
          f"{int(n_valid)}, floor {floor:.2f}) K3's Jacobi eigensolve zeroes "
          f"{_zeroed(w_j, V_j, floor)}; the stepwise loop's torch eigh "
          f"zeroes {_zeroed(w_t.cpu().numpy(), V_t.cpu().numpy(), floor)} "
          f"({card})")
    if gap > POSE_T_TOL or gap_r > POSE_R_TOL:
        fail(f"corridor fixture: K3 with the guard lies {gap} m / {gap_r} "
             f"rad from the stepwise loop (limits {POSE_T_TOL} / "
             f"{POSE_R_TOL})")


def hard_paths(card: str) -> dict:
    out = {}
    for name, make, cfg, seq_kw in HARD_WORLDS:
        launches, streams, result = hard_world_run(name, make, cfg, seq_kw,
                                                   card)
        if name == "corridor":
            corridor_against_cpu(streams, result, cfg, card)
        out[f"hard_{name}"] = launches
        torch.cuda.empty_cache()
    corridor_guard_check(card)
    return out


# the large pose graph of tests/test_posegraph_scale.py
GRAPH_K = 1536
GRAPH_ARGS = {"k": GRAPH_K, "k_cap": GRAPH_K, "e_cap": 6144, "n_lc": 512,
              "drift": 0.03, "seed": 3}
GRAPH_ITERS = (40, 256)   # LM iterations, CG iterations (the test's budget)
GRAPH_MID = {"k": 600, "k_cap": 600, "e_cap": 2400, "n_lc": 200,
             "drift": 0.03, "seed": 3}
GRAPH_MID_ITERS = (10, 64)
GRAPH_MID_CPU_TOL = 1e-3  # metres, the card's solve against the CPU's


def _solve_launches(g, cg_iters: int) -> int:
    """Kernel launches of one LM iteration of ``cg_iters`` CG iterations,
    from torch.profiler (the topology read left out)."""
    from torch.profiler import ProfilerActivity, profile

    from simpleslam_tpu_torch.ops import posegraph as pgo

    pgo.solve(g, max_iters=1, cg_iters=cg_iters).cost.cpu()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pgo.solve(g, max_iters=1, cg_iters=cg_iters).cost.cpu()
        torch.cuda.synchronize()
    act = device_activity(prof, f"graph: one LM iteration of {cg_iters} CG "
                          "iterations")
    return act[0] + act[1]


def graph_paths(card: str) -> dict:
    """The pose graph above the dense cut on the card: the 1536-node ring
    at the reference test's budget, and a 600-node ring against the port's
    own CPU solve."""
    from torch.profiler import ProfilerActivity, profile

    from simpleslam_tpu_torch.ops import posegraph as pgo
    from simpleslam_tpu_torch.parallel.dist_posegraph import _ring_graph

    phase(f"pose graph above the dense cut (K = {GRAPH_K}, PCG)")
    g, gt = _ring_graph(return_gt=True, device=torch.device("cuda"),
                        **GRAPH_ARGS)
    k = GRAPH_K
    if not k > pgo.DENSE_SOLVE_MAX_K:
        fail("graph: the ring is not above the dense cut")
    lm, cg = GRAPH_ITERS
    pgo.solve(g, max_iters=1, cg_iters=cg).cost.cpu()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pgo.solve(g, max_iters=lm, cg_iters=cg)
    cost, cost0 = float(res.cost), float(res.cost0)
    ms = 1e3 * (time.perf_counter() - t0)
    opt = res.poses[:k].cpu().numpy().astype(np.float64)
    err = np.linalg.norm(opt[:, :3, 3] - gt[:, :3, 3], axis=1)
    R = opt[:, :3, :3]
    ortho = float(np.abs(np.einsum("kij,kil->kjl", R, R)
                         - np.eye(3)).max())
    n_a = _solve_launches(g, 16)
    n_b = _solve_launches(g, 48)
    per_cg = (n_b - n_a) / 32
    print(f"graph: K = {k}, E = {GRAPH_ARGS['e_cap']} ({GRAPH_ARGS['n_lc']} "
          f"closures), {lm} LM x {cg} CG iterations in {ms:.1f} ms per solve;"
          f" cost {cost0:.2f} -> {cost:.5f} ({cost / cost0:.3e} of the "
          f"start); worst error against the truth {1e3 * err.max():.3f} mm "
          f"(mean {1e3 * err.mean():.3f}); R^T R - I at most {ortho:.2e}; "
          f"{per_cg} device launches per CG iteration (torch.profiler) "
          f"({card})")
    if not (np.isfinite(cost) and cost < 1e-3 * cost0):
        fail(f"graph: cost {cost} is not under 1e-3 of {cost0}")
    if not err.max() < 0.05:
        fail(f"graph: a pose lies {err.max()} m from the truth")
    if not ortho < 5e-4:
        fail(f"graph: rotations are off orthonormal by {ortho}")
    # one LM iteration after the topology read, with sync debugging set to
    # raise, and its device idle share
    tab = pgo._tables(g)
    orig = pgo._tables
    pgo._tables = lambda _g: tab
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            one = pgo.solve(g, max_iters=1, cg_iters=cg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pgo.solve(g, max_iters=1, cg_iters=cg).cost.cpu()
        wall = time.perf_counter() - t0
    finally:
        pgo._tables = orig
    if not np.isfinite(float(one.cost)):
        fail("graph: the LM iteration under sync debugging is not finite")
    kern, copies, busy, span = device_activity(prof, "graph: one LM "
                                               "iteration")
    print(f"graph: one LM iteration of {cg} CG iterations ran with sync "
          f"debugging set to raise (no host synchronisation after the "
          f"topology read); under torch.profiler {kern} kernel launches "
          f"and {copies} copies or fills, device busy {1e-3 * busy:.3f} "
          f"ms of a {1e-3 * span:.3f} ms span: idle share "
          f"{100 * (1 - busy / span):.1f} % (host wall {1e3 * wall:.1f} "
          f"ms with the profiler on) ({card})")

    phase(f"pose graph: K = {GRAPH_MID['k']} on the card against the CPU")
    lm, cg = GRAPH_MID_ITERS
    g_cpu = _ring_graph(**GRAPH_MID)
    g_dev = pgo.PoseGraph(*(t.to("cuda") for t in g_cpu))
    pgo.solve(g_dev, max_iters=1, cg_iters=cg).cost.cpu()
    t0 = time.perf_counter()
    on_card = pgo.solve(g_dev, max_iters=lm, cg_iters=cg)
    c_card = float(on_card.cost)
    ms_card = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    on_cpu = pgo.solve(g_cpu, max_iters=lm, cg_iters=cg)
    ms_cpu = 1e3 * (time.perf_counter() - t0)
    k = GRAPH_MID["k"]
    gap = float(np.abs(on_card.poses[:k].cpu().numpy()
                       - on_cpu.poses[:k].numpy()).max())
    print(f"graph: K = {k}, {lm} LM x {cg} CG iterations: card {ms_card:.1f}"
          f" ms, CPU {ms_cpu:.1f} ms; cost {float(on_card.cost0):.2f} -> "
          f"{c_card:.5f} on the card, {float(on_cpu.cost):.5f} on the CPU; "
          f"poses at most {gap:.3e} apart ({card})")
    if not gap < GRAPH_MID_CPU_TOL:
        fail(f"graph: the card's K = {k} solve is {gap} from the CPU's")
    # the pose graph is plain PyTorch in both packages: no hand kernel
    return {"graph": {key: 0 for key in (
        "k3", "k4", "k1_standalone", "k2_standalone", "plain", "stepwise",
        "registrations", "k1", "k2")}}


# the multi-lap spiral of tests/test_pipeline_lc_multi.py (copied: no jax)
SPIRAL_SCANS = 400        # its config is the courtyard's, LC_CFG


def spiral_streams(sim, world, n_scans: int, r0: float = 7.0,
                   lap_gap: float = 1.8, step: float = 0.33, seed: int = 2):
    """An outward spiral around the courtyard's center: every lap passes
    the same structures ``lap_gap`` to the side, so keyframes keep being
    admitted and closures keep coming."""
    rng = np.random.default_rng(seed)
    c = lap_gap / (2 * np.pi)
    th_fine = np.linspace(0, 7.2 * np.pi, 20000)
    r_fine = r0 + c * th_fine
    s_fine = np.concatenate([[0.0], np.cumsum(
        np.sqrt(r_fine[:-1] ** 2 + c ** 2) * np.diff(th_fine))])
    th = np.interp(np.arange(n_scans) * step, s_fine, th_fine)
    r = r0 + c * th
    x = r * np.sin(th)
    y = r0 - r * np.cos(th)
    yaw = np.unwrap(np.arctan2(np.gradient(y), np.gradient(x)))
    poses = np.tile(np.eye(4), (n_scans, 1, 1))
    poses[:, 0, 0] = np.cos(yaw)
    poses[:, 0, 1] = -np.sin(yaw)
    poses[:, 1, 0] = np.sin(yaw)
    poses[:, 1, 1] = np.cos(yaw)
    poses[:, 0, 3] = x
    poses[:, 1, 3] = y
    scans = [sim.simulate_scan(world, sim.sensor_from_body(poses[i]),
                               n_az=720, n_el=12, noise=0.03, rng=rng)
             for i in range(n_scans)]
    return sim.SensorStreams(np.arange(n_scans) * 0.1, scans, poses,
                             np.zeros(0), np.zeros((0, 4, 4)), np.zeros(0),
                             np.zeros((0, 4)))


def multilap_run(card: str) -> dict:
    """The 400-scan spiral with ``tpu.sync_backend`` in 32-scan batches:
    the bounds of tests/test_pipeline_lc_multi.py."""
    from simpleslam_tpu_torch.models.backend import LC_VAR
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import app
    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.pipeline.streamed import run_streamed

    name = "multi-lap"
    phase(f"multi-lap loop closure ({SPIRAL_SCANS}-scan spiral, "
          "sync_backend)")
    t0 = time.perf_counter()
    streams = spiral_streams(sim, make_courtyard(sim, LC_RADIUS, seed=0),
                             SPIRAL_SCANS)
    print(f"{name}: simulated {SPIRAL_SCANS} scans in "
          f"{time.perf_counter() - t0:.1f} s (host numpy, not part of the "
          "path)")
    system = app.SlamSystem(dict(LC_CFG, torch={"device": "cuda"}))
    torch.cuda.reset_peak_memory_stats()
    lk.reset_counts()
    with GnRecorder() as rec:
        result = run_streamed(system, streams, sync_every=BENCH_SYNC_EVERY)
        torch.cuda.synchronize()
    launches = launch_counts(rec)
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    report_streamed(name, result, SPIRAL_SCANS, ate, launches, card)
    be, lcm = system.backend, system.loop_closure
    t = result.timers
    print(f"{name}: LC queries {lcm.n_queries}, candidates "
          f"{lcm.n_candidates}, accepted {be.n_lc_edges}, dropped "
          f"{lcm.dropped_closures}; solves run {be.n_solves}, skipped "
          f"{be.n_skipped_noop_solves}; lc {1e3 * t.mean('lc'):.2f} ms x "
          f"{t.count['lc']} events, backend {1e3 * t.mean('backend'):.2f} ms "
          f"x {t.count['backend']} events ({card})")
    check_path(name, result, SPIRAL_SCANS, ate, None, STREAMED_CONV_MIN,
               launches)
    if be.n_lc_edges < 3 or lcm.dropped_closures != 0:
        fail(f"{name}: {be.n_lc_edges} closures accepted, "
             f"{lcm.dropped_closures} dropped")
    kfs = system.map_manager.kf_obj.keyframes

    def gt_at(stamp):
        return streams.gt_poses[int(np.argmin(np.abs(
            streams.scan_stamps - stamp)))]

    worst = 0.0
    for n in range(len(be.edge_i)):
        if not np.allclose(be.edge_var[n], LC_VAR):
            continue
        i, j = be.edge_i[n], be.edge_j[n]
        err = np.linalg.inv(np.linalg.inv(gt_at(kfs[i].stamp))
                            @ gt_at(kfs[j].stamp)) @ be.edge_T[n]
        worst = max(worst, float(np.linalg.norm(err[:3, 3])))
    idx = np.array([int(np.argmin(np.abs(streams.scan_stamps - kf.stamp)))
                    for kf in kfs])
    gt = streams.gt_poses[idx][:, :3, 3]
    post = float(np.sqrt(np.mean(np.sum(
        (gt - np.stack([kf.pose for kf in kfs])[:, :3, 3]) ** 2, 1))))
    raw = float(np.sqrt(np.mean(np.sum(
        (gt - result.poses[idx][:, :3, 3]) ** 2, 1))))
    print(f"{name}: closures at most {worst:.4f} m from the truth; keyframe "
          f"ATE {post:.4f} m after the solves, {raw:.4f} m raw, over "
          f"{len(kfs)} keyframes ({card})")
    if not worst < 0.3:
        fail(f"{name}: a closure lies {worst} m from the truth")
    if not (post <= raw + 0.02 and post < 0.3):
        fail(f"{name}: post-solve keyframes worse than raw odometry")
    batch_probe(name, system, streams, result, BENCH_SYNC_EVERY, card)
    return {"multilap": launches}


# the entry hook's pose on the card against the port's CPU run of the same
# hook: tests/test_torch_entry.py's bound against the JAX hook
ENTRY_T_TOL = 1e-4        # metres
ENTRY_R_TOL = 1e-5        # radians
ENTRY = {}                # K3's times on the entry hook's paths


def entry_hook_run(card: str) -> dict:
    """The single-device entry hook (``simpleslam_tpu_torch.entry``) on the
    card, on the sorted table and on the dense map: each ``fn`` call one K3
    launch and no plain or stepwise call; the pose within the stepwise
    loop's bounds of ``gn_loop_stepwise`` on the same fixture (equal counts)
    and within ``ENTRY_T_TOL`` / ``ENTRY_R_TOL`` of the hook's CPU run; the
    wrapper time per call (CUDA events), K3's device time per launch
    (torch.profiler) and its bound. Returns {path name: launch counts},
    and keeps K3's times there in ``ENTRY``."""
    from simpleslam_tpu_torch import entry as te
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    phase("entry hook (K3 on the tiny fixture)")
    out = {}
    for name, dense in (("entry_table", False), ("entry_dense", True)):
        kind = "dense" if dense else "table"
        fn, args = te.entry(device="cuda", dense=dense)
        src, vm, init = args
        if not (src.xyz.is_cuda and init.is_cuda):
            fail(f"{name}: entry() did not put its tensors on the card")
        torch.cuda.synchronize()
        lk.reset_counts()
        with GnRecorder() as rec:
            pose = fn(*args)
            torch.cuda.synchronize()
        c = launch_counts(rec)
        print(f"{name}: one fn call: {describe_launches(c)}")
        if (c["k3"], c["registrations"]) != (1, 1) or c["plain"] \
                or c["stepwise"] or c["k4"] or c["k1_standalone"] \
                or c["k2_standalone"]:
            fail(f"{name}: an fn call must be exactly one K3 launch: {c}")
        out[name] = c
        tally = FusedTally()
        got = tally.compare(f"{name}", src, vm, init, 0.0)
        if tally.count_mismatches or not torch.equal(got.pose, pose):
            fail(f"{name}: K3's counts differ from the stepwise loop's, or "
                 "the hook's pose is not K3's")
        p = pose.cpu().numpy()
        cfn, cargs = te.entry(device="cpu", dense=dense)
        q = cfn(*cargs).numpy()
        t_err = float(np.linalg.norm(p[:3, 3].astype(np.float64) - q[:3, 3]))
        r_err = _rot_angle(p[:3, :3], q[:3, :3])
        print(f"{name}: pose {t_err:.3e} m, {r_err:.3e} rad from the hook's "
              f"CPU run (limits {ENTRY_T_TOL} / {ENTRY_R_TOL})")
        if t_err > ENTRY_T_TOL or r_err > ENTRY_R_TOL:
            fail(f"{name}: the card's pose is {t_err:.3e} m / {r_err:.3e} rad "
                 "from the CPU's")
        ms = time_ms(lambda: fn(*args))
        plain_ms = time_ms(lambda: loam.gn_loop_stepwise(*args), 10)
        t = call_device(lambda: fn(*args))
        hits = [v for k, v in (t.by_kernel.items() if t else ())
                if "gn_loop_kernel" in k]
        if t is None or len(hits) != 1 or t.launches != 1 or hits[0][0] != 1:
            fail(f"{name}: the profiler must see one K3 launch per fn call: "
                 f"{describe_call(t)}")
        dev = hits[0][1]
        iters, gathers = int(got.iters), int(got.n_gathers)
        bound, bound_by = target_k3_bound(kind, vm, src, init, gathers, iters)
        ENTRY[name] = {"ms": ms, "plain_ms": plain_ms, "device_ms": dev,
                       "bound_ms": bound, "bound_by": bound_by,
                       "iters": iters, "gathers": gathers,
                       "max_abs_err": max(tally.t_err, t_err)}
        print(f"{name}: K3 {iters} iterations, {gathers} K1 phases, "
              f"{int(got.n_valid)} valid rows of {src.xyz.shape[0]} queries; "
              f"fn median {ms:.4f} ms per call (CUDA events), K3 "
              f"{1e3 * dev:.2f} us of device time per launch (torch.profiler),"
              f" bound {1e3 * bound:.3f} us ({bound_by}), stepwise "
              f"{plain_ms:.4f} ms ({card})")
    return out


NEW_PATHS = ("entry", "lio", "ndt", "vgicp", "threaded", "k4", "recorded",
             "memcheck", "loc", "hard", "graph", "multilap", "mesh")


def new_paths(which, streams, card: str, full=None):
    """Phases 8-16 and 18-21, those named in ``which``: ({path name: launch counts},
    K4's kernels-line entry or None, K3's times and bounds on the dense and
    table targets or None). ``full`` is the streamed full run's
    (system, result), made here when a phase needs it and none is given."""
    from simpleslam_tpu_torch.pipeline import simulate as sim

    head = head_of(sim, streams, REGISTER_SCANS)
    out, k4_entry, k3_targets = {}, None, None
    if "entry" in which:
        out.update(entry_hook_run(card))
    if full is None and {"k4", "recorded", "mesh"} & set(which):
        _, full_sys, full_res = streamed_run(
            "streamed full (bench full config)", BENCH_FULL, streams, card,
            prewarm=True, probe_scans=0)
        full = (full_sys, full_res)
    if "k4" in which:
        k4_entry, paths, k3_targets = k4_phases(full[0], streams, full[1],
                                                card)
        out.update(paths)
    if "mesh" in which:  # its inputs; the path itself runs last (main)
        mesh_capture(full[0], streams, full[1])
    if "recorded" in which:
        full_res = full[1]
        full = None            # the system's device memory goes before a replay
        torch.cuda.empty_cache()
        out.update(recorded_data(streams, full_res, card))
    full = None
    torch.cuda.empty_cache()
    if "memcheck" in which:
        memcheck_run(card)
    if "lio" in which:
        out["streamed_lio"] = lio_run(streams, card)
    for kind in ("ndt", "vgicp"):
        if kind in which:
            out[f"streamed_{kind}"] = register_runs(kind, head, card)
    if "threaded" in which:
        out["threaded"] = threaded_run(head, card)
    if "loc" in which:
        out.update(loc_paths(streams, card))
    if "hard" in which:
        out.update(hard_paths(card))
    if "graph" in which:
        out.update(graph_paths(card))
    if "multilap" in which:
        out.update(multilap_run(card))
        torch.cuda.empty_cache()
    return out, k4_entry, k3_targets


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=100)
    ap.add_argument("--stream-scans", type=int, default=150)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (build, kernels against their "
                         "plain versions); prints no result line")
    ap.add_argument("--only", default="", metavar="PATHS",
                    help="comma-separated subset of " + ",".join(NEW_PATHS)
                    + ": drive just those paths after the build; prints no "
                    "result line")
    ap.add_argument("--block-device", metavar="INPUTS", default="",
                    help=argparse.SUPPRESS)   # phase 17's child process
    args = ap.parse_args()
    if args.block_device:
        return rank_block_device_main(args.block_device)
    card = environment()
    build()
    if args.only:
        from simpleslam_tpu_torch.pipeline import simulate as sim

        which = args.only.split(",")
        if set(which) - set(NEW_PATHS):
            fail(f"--only takes {NEW_PATHS}, got {which}")
        streams = sim.simulate_sequence(sim.make_world(seed=0),
                                        n_scans=args.stream_scans, seed=0,
                                        n_az=1800, n_el=16)
        new_paths(which, streams, card)
        if "mesh" in which:
            mesh_paths(card)
        print(f"--only {args.only}: passed, no result line")
        return 0
    kern, tally = kernels(card)
    if args.kernels_only:
        tally.check()
        print("kernels-only run: phases 1-3 passed, no path was driven")
        return 0
    # first of the paths: its K3 device time comes from a young process's
    # profiler (ROADMAP §3, F9)
    by_path = entry_hook_run(card)
    by_path["offline_lo"] = slice_run(args.scans, card)

    from simpleslam_tpu_torch.pipeline import simulate as sim

    t0 = time.perf_counter()
    streams = sim.simulate_sequence(sim.make_world(seed=0),
                                    n_scans=args.stream_scans, seed=0,
                                    n_az=1800, n_el=16)
    print(f"simulated {args.stream_scans} scans in "
          f"{time.perf_counter() - t0:.1f} s (host numpy, not part of a path)")
    by_path["streamed_lo"] = streamed_run("streamed lo (bench lo config)",
                                          BENCH_LO, streams, card, 0.0078)[0]
    by_path["streamed_full"], full_sys, full_res = streamed_run(
        "streamed full (bench full config)", BENCH_FULL, streams, card,
        0.0078, prewarm=True)
    be = full_sys.backend
    print(f"streamed full: LC queries {full_sys.loop_closure.n_queries}, "
          f"accepted {be.n_lc_edges}; solves run {be.n_solves}, skipped "
          f"{be.n_skipped_noop_solves}")
    main_errs, main_t, main_bd = main_path_kernels(full_sys, streams, full_res,
                                                   card, tally)
    tally.check()
    new, k4_entry, k3_targets = new_paths(set(NEW_PATHS) - {"entry"},
                                          streams, card, (full_sys, full_res))
    del full_sys, be, full_res
    torch.cuda.empty_cache()
    by_path["loop_closure"] = loop_closure_run(card)
    by_path.update(new)
    by_path.update(mesh_paths(card))

    # launches, errors, times and bounds of the main path (streamed full);
    # the offline inputs' errors count as well. K3 is the kernel the paths
    # launch; K1's and K2's bodies run inside it as its phases, so their
    # "launches" are those phase counts and their standalone wrappers'
    # launches on the path are reported beside them (0).
    for k, key in zip(kern, ("k1", "k2", "k3")):
        k["max_abs_err"] = max(k["max_abs_err"], main_errs[key])
        k["ms"], k["plain_ms"] = main_t[key], main_t[key + "_plain"]
        if key != "k3":
            # the device time of one wrapper call over all its launches, and
            # those launches (one: no second pass sums the block partials)
            k["device_ms"] = main_t[key + "_dev"]
            k["device_ms_how"] = main_t[key + "_dev_how"]
            k["call_device_ms"] = main_t[key + "_dev"]
            k["launches_per_call"] = main_t[key + "_launches"]
        k["bound_ms"], k["bound_by"] = main_bd[key]
        # no single PyTorch call computes a gather, a 5-round selection, a
        # 3x3 eigensolve and a gated 28-term reduction (or a loop of them)
        k["library_ms"] = None
        k["launches"] = by_path["streamed_full"][key]
        k["launches_by_path"] = {p: c[key] for p, c in by_path.items()}
        if key != "k3":
            k["launches_are"] = "runs of this kernel's body as a phase of gn_loop_fused"
            k["standalone_launches_by_path"] = {
                p: c[key + "_standalone"] for p, c in by_path.items()}
    # on the scan2map paths K3's K1 phase reads its candidates from the
    # dense map's corner block or the table's 27 cells, not a merged row
    # the mesh path (phase 17) launches K1, K2 and K4 on their own, per
    # rank's block of the scan; each is held against its plain version on
    # rank 1's block of the 2-rank shard
    held = MESH["held"]
    for k, key in zip(kern, ("k1", "k2")):
        k["max_abs_err"] = max(k["max_abs_err"], held["max_abs_err"][key])
        k["mesh_block"] = {"queries": held["queries"],
                           "ms": held["ms"][key],
                           "device_ms": held["ms"][key + "_dev"],
                           "device_ms_how": held["ms"][key + "_dev_how"],
                           "launches_per_call": held["ms"][key + "_launches"],
                           "max_abs_err": held["max_abs_err"][key]}
    kern[0]["phase_source_by_path"] = {
        p: {"scan2map_dense": "dense map corner block",
            "scan2map_table": "sorted table, 27 cells",
            "entry_dense": "dense map corner block",
            "entry_table": "sorted table, 27 cells"}.get(p, "merged row")
        for p, c in by_path.items() if c["k1"]}
    kern[2]["device_ms"] = main_t["k3_dev"]
    kern[2]["device_ms_how"] = main_t["k3_dev_how"]
    kern[2]["device_ms_from_offset_start"] = main_t["k3_off_dev"]
    kern[2]["device_ms_from_offset_start_how"] = main_t["k3_off_dev_how"]
    kern[2]["grid_barrier_ms"] = main_t["barrier"]
    # K3's device time split into a launch's fixed part and the cost of an
    # iteration with a K1 and with a K2 phase (three starts, phase 6), and
    # the loop's barrier floor (iterations x one grid barrier) beside its
    # byte bound
    kern[2]["device_split_ms"] = main_t["split_ms"]
    kern[2]["barrier_floor_ms"] = main_t["barrier_floor_ms"]["k3"]
    kern[2]["barrier_floor_ms_from_offset_start"] = \
        main_t["barrier_floor_ms"]["k3_off"]
    kern[2]["max_abs_err_is"] = "pose translation against gn_loop_stepwise, metres"
    # K3 on the other two targets (phase 13): its launches there, its time,
    # device time and bound from the last scan's recorded pose
    kern[2]["on_targets"] = k3_targets
    # K3 on the entry hook's tiny fixture (phase 22): one launch per fn call
    kern[2]["on_entry_hook"] = ENTRY
    # K4 runs on the mesh path's registrations on a dense map or a sorted
    # table (the single-rank paths run K3 there instead): its launches are
    # those of the mesh path, this kernel's main path
    k4_entry["launches"] = sum(c["k4"] for p, c in by_path.items()
                               if p.startswith("mesh_"))
    k4_entry["launches_by_path"] = {p: c["k4"] for p, c in by_path.items()}
    k4_entry["launches_are"] = ("launches of this kernel on the mesh path "
                                "(phase 17): the sharded registrations on a "
                                "dense or table target; the single-rank "
                                "paths run K3 there")
    k4_entry["max_abs_err"] = max(k4_entry["max_abs_err"],
                                  held["max_abs_err"]["k4"])
    k4_entry["mesh_block"] = {"queries": held["queries"],
                              "ms_dense": held["ms"]["k4_dense"],
                              "ms_table": held["ms"]["k4_table"],
                              "max_abs_err": held["max_abs_err"]["k4"]}
    kern.append(k4_entry)
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
