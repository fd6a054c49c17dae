"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py [--scans N]

Drives ``simpleslam_tpu_torch`` (never jax) through five phases and fails
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
5. the result: a JSON line of the kernels, the nvidia-smi line, and last a
   JSON line ``{"ok": true, "device": {...}}``.
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


def kernels(card: str):
    phase("kernels against plain versions")
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    dev = torch.device("cuda")
    vm, src, sqrt_r, p_on, p_off = kernel_inputs(dev)
    errs = {"k1": 0.0, "k2": 0.0}
    for tag, p_map in (("on-pose", p_on), ("perturbed", p_off)):
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
    errs["k2"] = compare("K2 frozen planes", got, ref)
    again = lk.plane_normal_equations(planes, p_off, sqrt_r)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("K2 is not deterministic")

    t = {
        "k1": time_ms(lambda: lk.fit_and_linearize_merged(
            vm, p_on, sqrt_r, src.mask)),
        "k1_plain": time_ms(lambda: lk.fit_and_linearize_merged_plain(
            vm, p_on, sqrt_r, src.mask)),
        "k2": time_ms(lambda: lk.plane_normal_equations(planes, p_off, sqrt_r)),
        "k2_plain": time_ms(lambda: lk.plane_normal_equations_plain(
            planes, p_off, sqrt_r)),
    }
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=100)
    args = ap.parse_args()
    card = environment()
    build()
    kern = kernels(card)
    launches = slice_run(args.scans, card)
    kern[0]["launches"] = launches["k1"]
    kern[1]["launches"] = launches["k2"]
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
