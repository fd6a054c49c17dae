"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py [--scans N] [--kernels-only] [--only PATHS]

Drives ``simpleslam_tpu_torch`` (never jax) through seventeen phases and
fails with a nonzero exit on the first problem:

1. environment: card name and power limit (nvidia-smi), torch / CUDA
   versions, TF32 flags; no CUDA device is a failure;
2. build: the CUDA kernels of ``simpleslam_tpu_torch/csrc`` with nvcc;
3. kernels against their plain PyTorch versions at main-path shapes (a
   merged map at dims (96, 96, 16) x 24 points, 8192 queries): K1
   ``fit_and_linearize_merged`` and K2 ``plane_normal_equations`` within the
   reference's tolerances, K1 bit-identical across two calls; K3
   ``gn_loop_fused`` (the whole GN loop in one launch) against its plain
   version ``gn_loop_stepwise`` from the on-pose start and from a 0.25 m
   offset start, degeneracy guard off and on: pose within 1e-4 m and
   1e-5 rad, the same iterations / gathers / converged and n_valid within
   4 rows, bit-identical across two calls; median times from CUDA events, K3's
   device time from ``torch.profiler``, and the grid barrier's cost;
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
15. ``run_streamed(device_probe=True)`` on the ``lo`` config: ``device_exec``,
   ``fetch_wait`` and ``fetch_xfer`` per batch and ``roofline.utilization``
   of the batch against the card's peaks (no share above 1);
16. ``memcheck`` on the card, 4 segments of 48 scans: its JSON, ``ok``
   required;
17. the result: a JSON line of the kernels K1-K4 (with the launches of each
   path: K3's launches, for K1 and K2 the times their bodies ran as phases
   of K3, from the recorded gathers and iterations, the K1 phases of the
   ``scan2map`` paths of 13 reading the dense map's or the table's
   candidates; for K4 its own launches, 0 on every path: it serves K3's
   plain version; K3's times and bounds on those targets), the nvidia-smi
   line, and last a JSON line ``{"ok": true, "device": ...}``.

``--only lio,ndt,vgicp,threaded,k4,recorded,probe,memcheck`` (any subset)
drives just the named paths of 8-16 after the build (a quick check while
working on one of them; ``k4`` and ``recorded`` run the streamed full config
first, for its inputs) and prints no result line.
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
# n_valid may differ by a few rows where the two loops' poses differ by 1e-5 m
# after a step: with the guard on, torch's f32 eigh and the kernel's Jacobi
# eigensolve disagree by that much on these ill-conditioned systems (the CPU
# tests hold both against float64), and such a gap moves the 5-NN choice of
# about one query in 5000
N_VALID_TOL = 4
START_OFFSET = (0.25, -0.15, 0.05)   # the perturbed start, metres
SMALL_OFFSET = (0.03, -0.02, 0.01)   # a start that needs no new gather
DEGEN = 0.02              # loam.DEGEN_EIGEN_PER_ROW (the guard's floor)
N_FUSED_SCANS = 48        # scans of the streamed path K3 is held on
# roofline of the card (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


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


def kernel_device_ms(kernel_name: str, fn, launches: int = 20):
    """Median device milliseconds of the CUDA kernel whose name contains
    ``kernel_name`` over ``launches`` calls of ``fn``, from torch.profiler;
    None when three windows in a row recorded no such device event."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        durs = [e.time_range.end - e.time_range.start for e in prof.events()
                if kernel_name in e.name
                and e.device_type == torch.autograd.DeviceType.CUDA]
        if durs:
            return 1e-3 * statistics.median(durs)
    return None


EVENTS_HOW = "CUDA events around 50 back-to-back launches"


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
    bare = bare or fn
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    bare()
    torch.cuda.synchronize()
    a.record()
    for _ in range(50):
        bare()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 50.0, EVENTS_HOW


def device_activity(prof):
    """(kernels, copies and fills, busy us, span us) of the device events a
    ``torch.profiler`` run recorded; None when it saw no device event."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        return None
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
    iteration and gather counts on the device and reads them once at the
    end. ``k1_phases`` / ``k2_phases`` are the times K1's and K2's bodies
    ran inside K3."""

    def __enter__(self):
        from simpleslam_tpu_torch.ops import loam

        self._loam, self._orig, self._rows = loam, loam.gn_loop, []

        def recording(*args, **kwargs):
            res = self._orig(*args, **kwargs)
            self._rows.append(torch.stack([res.iters, res.n_gathers]))
            return res

        loam.gn_loop = recording
        return self

    def __exit__(self, *exc):
        self._loam.gn_loop = self._orig
        counts = (torch.stack(self._rows).cpu().numpy() if self._rows
                  else np.zeros((0, 2), np.int64))
        self.n_reg = len(counts)
        self.k1_phases = int(counts[:, 1].sum())
        self.k2_phases = int((counts[:, 0] - counts[:, 1]).sum())
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


def kernel_inputs(dev):
    """A real merged map from a simulated submap, and one scan's queries."""
    from simpleslam_tpu_torch.ops import geometry as geo
    from simpleslam_tpu_torch.ops import loam
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
    vm = vox.build_merged_dense_voxel_map(ds_sub, 2.0, center, DIMS, SLAB)
    scan = sim.simulate_scan(world, sim.sensor_from_body(poses[16]),
                             n_az=1800, n_el=16, rng=rng)
    src = pcops.compact(vox.voxel_downsample(
        pcops.from_numpy(scan, 32768, dev), 0.5), N_QUERIES)
    pose = torch.tensor(poses[16].astype(np.float32), device=dev)
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
    return errs


def time_kernels(vm, src, sqrt_r, p_on, p_off) -> dict:
    """Median ms of each kernel's wrapper and of its plain version."""
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    planes = lk.fit_and_linearize_merged(vm, p_on, sqrt_r, src.mask)[3]
    return {
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
        if t_err > POSE_T_TOL or r_err > POSE_R_TOL:
            fail(f"K3 {tag}: pose {t_err:.3e} m / {r_err:.3e} rad from the "
                 f"stepwise loop (limits {POSE_T_TOL} / {POSE_R_TOL})")
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
    t, rows = {}, []
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
        print(f"  K3 from the {tag} start ({iters} iterations, {gathers} K1 "
              f"phases): median {t[key]:.4f} ms per call, device time "
              f"{dev:.4f} ms per launch ({how}), stepwise "
              f"{t[key + '_plain']:.4f} ms ({card}, {label})")
    one = time_ms(lambda: lk.barrier_probe(src.xyz.device, 1))
    many = time_ms(lambda: lk.barrier_probe(src.xyz.device, 257))
    t["barrier"] = (many - one) / 256.0
    print(f"  one grid barrier {1e3 * t['barrier']:.2f} us ({card})")
    a = np.array([[1.0, g, k] for g, k, _ in rows])
    if abs(np.linalg.det(a)) > 1e-9:
        fixed, k1_it, k2_it = np.linalg.solve(
            a, np.array([d for _, _, d in rows]))
        print(f"  K3 device time split from those three: {1e3 * fixed:.1f}"
              f" us per launch + {1e3 * k1_it:.1f} us per iteration with "
              f"a K1 phase + {1e3 * k2_it:.1f} us per iteration with a K2 "
              f"phase (each with its barrier, sums and small step) "
              f"({card}, {label})")
    return t


def kernels(card: str):
    phase("kernels against plain versions")
    dev = torch.device("cuda")
    vm, src, sqrt_r, p_on, p_off, pose = kernel_inputs(dev)
    errs = hold_kernels("offline", vm, src, sqrt_r, p_on, p_off)
    tally = FusedTally()
    hold_fused(tally, "offline", vm, src, pose)
    t = time_kernels(vm, src, sqrt_r, p_on, p_off)
    for k in ("k1", "k2"):
        print(f"  {k.upper()} median {t[k]:.4f} ms, plain {t[k + '_plain']:.4f}"
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


def check_path(name: str, result, n_scans: int, ate: float, ate_max: float,
               conv_min: float, launches: dict, kind: str = "loam") -> None:
    if result.poses.shape != (n_scans, 4, 4) or not np.isfinite(
            result.poses).all():
        fail(f"{name}: trajectory is not finite ({n_scans}, 4, 4)")
    if not ate < ate_max:
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
    # every scan but the one that seeds the map is registered, each by one
    # launch of K3
    if not (launches["k3"] == launches["registrations"] == n_scans - 1):
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
    act = device_activity(prof)
    line = (f"{name}: one batch body of {k} scans ran with sync debugging "
            f"set to raise (no host synchronisation before the packed read);"
            f" converged {int(rows_h[:, 16].sum())} of {k}; ")
    if act is None:
        print(line + "torch.profiler saw no device event: launches per scan "
              f"and idle share not measured ({card})")
        return
    kern, copies, busy, span = act
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
        print(f"  {k.upper()} median {t[k]:.4f} ms, plain {t[k + '_plain']:.4f}"
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
    print(f"  K3 from the on-pose start ({gathers} K1 phases in {iters} "
          f"iterations): device time {1e3 * t['k3_dev']:.1f} us per "
          f"launch = {100 * bd['k3'][0] / t['k3_dev']:.2f} % of the "
          f"bound's rate; from the offset start ({gathers_o} K1 phases in "
          f"{iters_o} iterations) bound {1e3 * bd_off['k3'][0]:.3f} us, "
          f"device {1e3 * t['k3_off_dev']:.1f} us ({card})")
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
    streams = sim.simulate_sequence(
        make_courtyard(sim, LC_RADIUS, seed=0), n_scans=LC_SCANS, seed=2,
        radius=LC_RADIUS, speed=LC_SPEED, n_az=720, n_el=12, scan_noise=0.03)
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


def other_targets(system):
    """The streamed path's last submap (the keyframe window of its last map
    rebuild, transformed and downsampled as ``_fused_window_target`` does)
    as a dense map and as a sorted voxel table."""
    from simpleslam_tpu_torch.models.registration import _fused_window_target
    from simpleslam_tpu_torch.ops import voxel as vox

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
        t["launches"] = launches["k3"]
        t["max_abs_err"] = tally.t_err
        print(f"{name}: K3 from scan {idx[-1]}'s recorded pose ({iters} "
              f"iterations, {g0} K1 phases): median {t['ms']:.4f} ms per "
              f"call, device {1e3 * t['device_ms']:.2f} us "
              f"({t['device_ms_how']}) = "
              f"{100 * t['bound_ms'] / t['device_ms']:.2f} % of the bound's "
              f"rate (bound {1e3 * t['bound_ms']:.3f} us by {t['bound_by']}); "
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


def device_probe_run(streams, card: str) -> None:
    """Phase 15: the lo config with ``device_probe=True`` and the batch's
    roofline shares."""
    from simpleslam_tpu_torch.ops import roofline
    from simpleslam_tpu_torch.pipeline import app
    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.pipeline.streamed import run_streamed

    phase("device_probe (bench lo config) and roofline")
    system = app.SlamSystem(dict(BENCH_LO, torch={"device": "cuda"}))
    result = run_streamed(system, streams, sync_every=BENCH_SYNC_EVERY,
                          device_probe=True)
    t = result.timers
    nb = result.extras["n_batches"]
    for key in ("device_exec", "fetch_wait", "fetch_xfer"):
        if t.count[key] != nb or not t.total[key] > 0:
            fail(f"device_probe: timer {key} booked {t.count[key]} times for "
                 f"{nb} batches")
    if t.count["fetch"]:
        fail("device_probe: the fused fetch was booked too")
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    n = len(streams.scan_stamps)
    print(f"device_probe: {n} scans in {result.wall_time:.2f} s = "
          f"{n / result.wall_time:.2f} scans/s with the probe's blocking; "
          f"per batch of {BENCH_SYNC_EVERY}: device_exec "
          f"{1e3 * t.mean('device_exec'):.3f} ms (series "
          f"{[round(1e3 * v, 2) for v in t.series['device_exec']]}), "
          f"fetch_wait {1e3 * t.mean('fetch_wait'):.4f} ms, fetch_xfer "
          f"{1e3 * t.mean('fetch_xfer'):.4f} ms; ATE {ate:.4f} m ({card})")
    if not ate < STREAMED_ATE_MAX:
        fail(f"device_probe: ATE {ate}")
    slab = int(system.register.tpu_cfg.get("loam_slab_size", 24))
    cost = roofline.loam_batch_cost(
        n_queries=result.extras["scan_capacity"], slab_rows=1,
        lane_width=8 * slab * 3, slab_pts=slab, n_scans=BENCH_SYNC_EVERY,
        mean_iters=result.extras["gn_iters_mean"],
        mean_gathers=result.extras["gn_gathers_mean"])
    # full batches only: the last one holds fewer scans
    full = t.series["device_exec"][: (n - 1) // BENCH_SYNC_EVERY] or \
        t.series["device_exec"]
    util = roofline.utilization(cost, statistics.median(full))
    print(f"roofline of one {BENCH_SYNC_EVERY}-scan batch: "
          f"{cost['flops'] / 1e9:.3f} GFLOP, {cost['hbm_bytes'] / 1e6:.2f} MB "
          f"of row reads, against device_exec median "
          f"{1e3 * statistics.median(full):.3f} ms: share of the f32 peak "
          f"{util['mfu']}, of the HBM bandwidth {util['hbm_util']}, of the "
          f"speed of light {util['sol_frac']} ({card}; peaks "
          f"{roofline.H100_SXM_F32_NON_TENSOR_FLOPS / 1e12:.0f} TFLOP/s f32, "
          f"{roofline.H100_SXM_HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    if not all(0 < util[k] <= 1 for k in ("mfu", "hbm_util", "sol_frac")):
        fail(f"roofline: a share outside (0, 1]: {util}")


def memcheck_run(card: str) -> None:
    """Phase 16: the steady-state check of the streamed executor."""
    from simpleslam_tpu_torch import memcheck

    phase("memcheck (4 segments of 48 scans)")
    out = memcheck.run_memcheck(4, 48)
    print(f"memcheck ({card}): {json.dumps(out)}")
    if not out["ok"] or out["device"].split(":")[0] != "cuda":
        fail("memcheck: a steady-state check failed")


NEW_PATHS = ("lio", "ndt", "vgicp", "threaded", "k4", "recorded", "probe",
             "memcheck")


def new_paths(which, streams, card: str, full=None):
    """Phases 8-16, those named in ``which``: ({path name: launch counts},
    K4's kernels-line entry or None, K3's times and bounds on the dense and
    table targets or None). ``full`` is the streamed full run's
    (system, result), made here when a phase needs it and none is given."""
    from simpleslam_tpu_torch.pipeline import simulate as sim

    head = head_of(sim, streams, REGISTER_SCANS)
    out, k4_entry, k3_targets = {}, None, None
    if full is None and {"k4", "recorded"} & set(which):
        _, full_sys, full_res = streamed_run(
            "streamed full (bench full config)", BENCH_FULL, streams, card,
            prewarm=True, probe_scans=0)
        full = (full_sys, full_res)
    if "k4" in which:
        k4_entry, paths, k3_targets = k4_phases(full[0], streams, full[1],
                                                card)
        out.update(paths)
    if "recorded" in which:
        full_res = full[1]
        full = None            # the system's device memory goes before a replay
        torch.cuda.empty_cache()
        out.update(recorded_data(streams, full_res, card))
    full = None
    torch.cuda.empty_cache()
    if "probe" in which:
        device_probe_run(streams, card)
    if "memcheck" in which:
        memcheck_run(card)
    if "lio" in which:
        out["streamed_lio"] = lio_run(streams, card)
    for kind in ("ndt", "vgicp"):
        if kind in which:
            out[f"streamed_{kind}"] = register_runs(kind, head, card)
    if "threaded" in which:
        out["threaded"] = threaded_run(head, card)
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
    args = ap.parse_args()
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
        print(f"--only {args.only}: passed, no result line")
        return 0
    kern, tally = kernels(card)
    if args.kernels_only:
        tally.check()
        print("kernels-only run: phases 1-3 passed, no path was driven")
        return 0
    by_path = {"offline_lo": slice_run(args.scans, card)}

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
    new, k4_entry, k3_targets = new_paths(NEW_PATHS, streams, card,
                                          (full_sys, full_res))
    del full_sys, be, full_res
    torch.cuda.empty_cache()
    by_path["loop_closure"] = loop_closure_run(card)
    by_path.update(new)

    # launches, errors, times and bounds of the main path (streamed full);
    # the offline inputs' errors count as well. K3 is the kernel the paths
    # launch; K1's and K2's bodies run inside it as its phases, so their
    # "launches" are those phase counts and their standalone wrappers'
    # launches on the path are reported beside them (0).
    for k, key in zip(kern, ("k1", "k2", "k3")):
        k["max_abs_err"] = max(k["max_abs_err"], main_errs[key])
        k["ms"], k["plain_ms"] = main_t[key], main_t[key + "_plain"]
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
    kern[0]["phase_source_by_path"] = {
        p: {"scan2map_dense": "dense map corner block",
            "scan2map_table": "sorted table, 27 cells"}.get(p, "merged row")
        for p, c in by_path.items() if c["k1"]}
    kern[2]["device_ms"] = main_t["k3_dev"]
    kern[2]["device_ms_how"] = main_t["k3_dev_how"]
    kern[2]["device_ms_from_offset_start"] = main_t["k3_off_dev"]
    kern[2]["device_ms_from_offset_start_how"] = main_t["k3_off_dev_how"]
    kern[2]["grid_barrier_ms"] = main_t["barrier"]
    kern[2]["max_abs_err_is"] = "pose translation against gn_loop_stepwise, metres"
    # K3 on the other two targets (phase 13): its launches there, its time,
    # device time and bound from the last scan's recorded pose
    kern[2]["on_targets"] = k3_targets
    # K4 serves K3's plain version (the stepwise loop's gather + K4 on a
    # dense or table target) and the sharded path to come; every path runs
    # K3 instead, so K4's own launches there are 0 (phase 12 holds it)
    k4_entry["launches"] = by_path["streamed_full"]["k4"]
    k4_entry["launches_by_path"] = {p: c["k4"] for p, c in by_path.items()}
    k4_entry["launches_are"] = ("launches of this kernel; no path runs it: "
                                "it serves gn_loop_stepwise, K3's plain "
                                "version, on a dense or table target")
    kern.append(k4_entry)
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
