"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py [--scans N]

Drives ``simpleslam_tpu_torch`` (never jax) through eight phases and fails
with a nonzero exit on the first problem:

1. environment: card name and power limit (nvidia-smi), torch / CUDA
   versions, TF32 flags; no CUDA device is a failure;
2. build: the CUDA kernels of ``simpleslam_tpu_torch/csrc`` with nvcc;
3. kernels against their plain PyTorch versions at main-path shapes (a
   merged map at dims (96, 96, 16) x 24 points, 8192 queries): K1
   ``fit_and_linearize_merged`` and K2 ``plane_normal_equations`` within the
   reference's tolerances, K1 bit-identical across two calls, and median
   times from CUDA events;
4. the lo-mode LOAM slice: ``SlamSystem`` + ``run_offline`` on the bench's
   ``lo`` config and sequence, checked for accuracy and for having run
   through both kernels (and never through a plain version);
5. streamed lo: the bench's ``lo`` config through ``run_streamed`` (batches
   of 32 scans) on the bench's 150-scan sequence at full width;
6. streamed full: the bench's headline ``full`` config (pose-graph backend
   on its worker thread, ScanContext + VGICP loop closure) on the same
   sequence, after ``SlamSystem.prewarm``; then K1 and K2 against their plain
   versions (as in 3) on this path's own inputs: its last target and its
   last scan prepped as the executor preps it, at the latched scan
   capacity, with the times that the kernels JSON line reports;
7. loop closure: the courtyard loop of tests/test_pipeline_lc.py (world and
   config copied here) with ``tpu.sync_backend``, run twice: at least one
   accepted closure and one solve that ran, closures within 0.3 m / 5 deg of
   the truth, the four bounds of that test, and bit-identical poses;
   phases 4-7 each check accuracy and finite poses, and that K1 and K2 ran
   on that path and no plain version did; 5-7 print scans/s, the streamed
   stage timers and peak device memory;
8. the result: a JSON line of the kernels (with the launches of each path),
   the nvidia-smi line, and last a JSON line ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
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
    off = pose.clone()
    off[:3, 3] += torch.tensor([0.25, -0.15, 0.05], device=dev)
    print(f"map rows {tuple(vm.rows.shape)} int16 "
          f"({vm.rows.numel() * 2 / 1e6:.1f} MB), queries {src.capacity} "
          f"({int(src.mask.sum())} valid)")
    sqrt_r = loam.source_sqrt_range(src)
    p_on = geo.transform_points(pose, src.xyz)
    p_off = geo.transform_points(off, src.xyz)
    return vm, src, sqrt_r, p_on, p_off


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


def kernels(card: str):
    phase("kernels against plain versions")
    dev = torch.device("cuda")
    vm, src, sqrt_r, p_on, p_off = kernel_inputs(dev)
    errs = hold_kernels("offline", vm, src, sqrt_r, p_on, p_off)
    t = time_kernels(vm, src, sqrt_r, p_on, p_off)
    for k in ("k1", "k2"):
        print(f"  {k.upper()} median {t[k]:.4f} ms, plain {t[k + '_plain']:.4f}"
              f" ms ({card}, Q={N_QUERIES})")
    results = [
        {"name": "fit_and_linearize_merged", "route": "cuda",
         "source": "simpleslam_tpu_torch/csrc/loam_kernels.cu",
         "replaces": "simpleslam_tpu/ops/loam_pallas.py:67",
         "max_abs_err": errs["k1"], "ms": t["k1"], "plain_ms": t["k1_plain"]},
        {"name": "plane_normal_equations", "route": "cuda",
         "source": "simpleslam_tpu_torch/csrc/loam_kernels.cu",
         "replaces": "simpleslam_tpu/ops/loam_pallas.py:177",
         "max_abs_err": errs["k2"], "ms": t["k2"], "plain_ms": t["k2_plain"]},
    ]
    del vm
    torch.cuda.empty_cache()
    return results


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
    result = app.run_offline(system, streams)
    torch.cuda.synchronize()
    launches = {"k1": lk.K1_LAUNCHES, "k2": lk.K2_LAUNCHES}
    plain = lk.K1_PLAIN_CUDA_CALLS + lk.K2_PLAIN_CUDA_CALLS
    ate = sim.ate_rmse(streams.gt_poses, result.poses)
    per_scan = np.asarray(result.timers.series["odometry"])
    warm = per_scan[5:] if len(per_scan) > 10 else per_scan
    print(f"scans {n_scans}, wall {result.wall_time:.2f} s, "
          f"{n_scans / result.wall_time:.2f} scans/s end to end, "
          f"odometry median {1e3 * float(np.median(warm)):.2f} ms/scan "
          f"after 5 warm-up scans ({card})")
    print(result.timers.report())
    print(f"ATE {ate:.4f} m, keyframes {result.keyframe_count}, converged "
          f"{result.converged_frac:.3f}, K1 launches {launches['k1']}, "
          f"K2 launches {launches['k2']}, plain CUDA calls {plain}, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if not np.isfinite(result.poses).all() or result.poses.shape != (
            n_scans, 4, 4):
        fail("trajectory is not finite (n_scans, 4, 4)")
    if not ate < 0.15:
        fail(f"ATE {ate} >= 0.15 m")
    if not result.converged_frac > 0.95:
        fail(f"converged fraction {result.converged_frac} <= 0.95")
    if launches["k1"] == 0 or launches["k2"] == 0:
        fail(f"a kernel never ran on the main path: {launches}")
    if plain != 0:
        fail(f"plain versions ran {plain} times on CUDA in the main path")
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


def launch_counts():
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    return {"k1": lk.K1_LAUNCHES, "k2": lk.K2_LAUNCHES,
            "plain": lk.K1_PLAIN_CUDA_CALLS + lk.K2_PLAIN_CUDA_CALLS}


def check_path(name: str, result, n_scans: int, ate: float, ate_max: float,
               conv_min: float, launches: dict) -> None:
    if result.poses.shape != (n_scans, 4, 4) or not np.isfinite(
            result.poses).all():
        fail(f"{name}: trajectory is not finite ({n_scans}, 4, 4)")
    if not ate < ate_max:
        fail(f"{name}: ATE {ate} >= {ate_max} m")
    if not result.converged_frac > conv_min:
        fail(f"{name}: converged fraction {result.converged_frac} <= "
             f"{conv_min}")
    if launches["k1"] == 0 or launches["k2"] == 0:
        fail(f"{name}: a kernel never ran on this path: {launches}")
    if launches["plain"] != 0:
        fail(f"{name}: plain versions ran {launches['plain']} times on CUDA")


def report_streamed(name: str, result, n_scans: int, ate: float,
                    launches: dict, card: str) -> None:
    t = result.timers
    stages = ", ".join(
        f"{k} {1e3 * t.mean(k):.2f} ms x{t.count[k]}"
        for k in ("prep", "upload", "dispatch", "fetch", "bookkeep",
                  "map_update", "backend", "lc") if t.count[k])
    print(f"{name}: {n_scans} scans in {result.wall_time:.2f} s = "
          f"{n_scans / result.wall_time:.2f} scans/s end to end ({card})")
    print(f"{name}: stage means {stages} ({card})")
    print(result.timers.report())
    print(f"{name}: ATE {ate:.4f} m (unaligned), keyframes "
          f"{result.keyframe_count}, converged {result.converged_frac:.3f}, "
          f"GN iterations/scan {result.extras['gn_iters_mean']}, scan "
          f"capacity {result.extras['scan_capacity']}, K1 launches "
          f"{launches['k1']}, K2 launches {launches['k2']}, plain CUDA calls "
          f"{launches['plain']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")


def streamed_run(name: str, cfg: dict, streams, card: str, prewarm=False):
    """One bench config through ``run_streamed``; returns the kernel counts
    of exactly that run, the system and the result."""
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
    result = run_streamed(system, streams, sync_every=BENCH_SYNC_EVERY)
    torch.cuda.synchronize()
    launches = launch_counts()
    n = len(streams.scan_stamps)
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    report_streamed(name, result, n, ate, launches, card)
    check_path(name, result, n, ate, STREAMED_ATE_MAX, STREAMED_CONV_MIN,
               launches)
    return launches, system, result


def main_path_kernels(system, streams, result, card: str):
    """K1/K2 against their plain versions on the streamed path's own inputs:
    the target its last batch registered against, and the last scan prepped
    as the executor preps it (downsampled, spatially sorted, int16) at the
    run's latched scan capacity, placed at its recorded pose. Returns the
    max abs errors and the times."""
    from simpleslam_tpu_torch import native
    from simpleslam_tpu_torch.ops import geometry as geo
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.pipeline import streamed

    phase("kernels against plain versions on the streamed full inputs")
    dev = system.register.device
    cap = int(result.extras["scan_capacity"])
    i = len(streams.scan_stamps) - 1
    rows, cnts = native.voxel_downsample_sort_quant_batch(
        [np.asarray(streams.scans[i], np.float32)],
        float(system.lidar_odometry.grid_size), cap,
        float(system.register.TARGET_GRID), streamed.UPLOAD_SCALE)
    src = streamed.upload_cloud(torch.from_numpy(rows[0]).to(dev))
    vm = system.map_manager.get_target()
    pose = torch.tensor(result.poses[i].astype(np.float32), device=dev)
    off = pose.clone()
    off[:3, 3] += torch.tensor([0.25, -0.15, 0.05], device=dev)
    sqrt_r = loam.source_sqrt_range(src)
    p_on = geo.transform_points(pose, src.xyz)
    p_off = geo.transform_points(off, src.xyz)
    print(f"scan {i} at scan capacity {cap} ({int(cnts[0])} valid, queries "
          f"{src.capacity}), target rows {tuple(vm.rows.shape)} int16")
    if src.capacity != cap:
        fail(f"queries {src.capacity} != scan capacity {cap}")
    errs = hold_kernels("streamed full", vm, src, sqrt_r, p_on, p_off)
    t = time_kernels(vm, src, sqrt_r, p_on, p_off)
    for k in ("k1", "k2"):
        print(f"  {k.upper()} median {t[k]:.4f} ms, plain {t[k + '_plain']:.4f}"
              f" ms ({card}, Q={cap}, streamed full inputs)")
    return errs, t


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
        result = run_streamed(system, streams)
        torch.cuda.synchronize()
        launches = launch_counts()
        ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
        name = f"loop closure run {rep + 1}"
        report_streamed(name, result, LC_SCANS, ate, launches, card)
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
        runs.append((result.poses, launches))
    same = np.array_equal(runs[0][0], runs[1][0])
    print(f"loop closure: two sync_backend runs bit-identical: {same}")
    if not same:
        fail("the two sync_backend runs differ")
    return runs[0][1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=100)
    ap.add_argument("--stream-scans", type=int, default=150)
    args = ap.parse_args()
    card = environment()
    build()
    kern = kernels(card)
    by_path = {"offline_lo": slice_run(args.scans, card)}

    from simpleslam_tpu_torch.pipeline import simulate as sim

    t0 = time.perf_counter()
    streams = sim.simulate_sequence(sim.make_world(seed=0),
                                    n_scans=args.stream_scans, seed=0,
                                    n_az=1800, n_el=16)
    print(f"simulated {args.stream_scans} scans in "
          f"{time.perf_counter() - t0:.1f} s (host numpy, not part of a path)")
    by_path["streamed_lo"] = streamed_run("streamed lo (bench lo config)",
                                          BENCH_LO, streams, card)[0]
    by_path["streamed_full"], full_sys, full_res = streamed_run(
        "streamed full (bench full config)", BENCH_FULL, streams, card,
        prewarm=True)
    be = full_sys.backend
    print(f"streamed full: LC queries {full_sys.loop_closure.n_queries}, "
          f"accepted {be.n_lc_edges}; solves run {be.n_solves}, skipped "
          f"{be.n_skipped_noop_solves}")
    main_errs, main_t = main_path_kernels(full_sys, streams, full_res, card)
    del full_sys, be, full_res
    torch.cuda.empty_cache()
    by_path["loop_closure"] = loop_closure_run(card)

    # launches, errors and times of the main path (streamed full); the
    # offline inputs' errors count as well
    for k, key in ((kern[0], "k1"), (kern[1], "k2")):
        k["max_abs_err"] = max(k["max_abs_err"], main_errs[key])
        k["ms"], k["plain_ms"] = main_t[key], main_t[key + "_plain"]
        k["launches"] = by_path["streamed_full"][key]
        k["launches_by_path"] = {p: c[key] for p, c in by_path.items()}
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
