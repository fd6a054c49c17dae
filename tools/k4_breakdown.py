"""K4 (``fit_and_linearize_candidates``) at each grid size, and where it
spends its time, on one CUDA GPU.

    python3 tools/k4_breakdown.py [--qpw 1,2,4,8]

For each grid size (queries a warp walks; the kernel's own is
``kK4QueriesPerWarp`` in ``simpleslam_tpu_torch/csrc/loam_kernels.cu``)
builds the kernel library twice, all builds at once: with
``-DLOAM_K4_QPW=n``, and with that and ``-DLOAM_K4_CLOCKS`` (lane 0 of every
warp adds SM clock cycles per segment of its work and notes its SM and its
start and end on the global timer). It runs K4 through its wrapper on the
candidates of ``chip_smoke.py``'s simulated submap (as a dense map, corner
gather, C = 192, and as a sorted table, 27-cell gather, C = 216) and one
scan's 8192 queries, holds each build against the plain version, and
prints per grid: the first build's device time (torch.profiler), and from
the clock build the mean cycles per warp in each segment, the warps
resident on an SM at once and the launch's span on the global timer. The
probes cost time of their own: read the shares, not the sum, against the
first build's device time.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGMENTS = ("prologue", "wait", "stage", "select", "record+tail",
            "last tail", "finish")
SLOTS = 10   # kK4ClockSlots in csrc/loam_kernels.cu
WARPS = 4    # kK4Warps


def build_libraries(variants):
    """One library per list of extra nvcc flags, nvcc started for all at
    once; returns them loaded and bound, in order."""
    from simpleslam_tpu_torch.ops import _build

    src = os.path.join(_build.CSRC, "loam_kernels.cu")
    h = hashlib.sha256()
    for name in sorted(os.listdir(_build.CSRC)):
        if name.endswith((".cu", ".h")):
            with open(os.path.join(_build.CSRC, name), "rb") as f:
                h.update(f.read())
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    jobs = []
    for extra in variants:
        flags = [*_build.NVCC_FLAGS, *extra]
        hv = h.copy()
        hv.update(" ".join(flags).encode())
        out = os.path.join(_build.BUILD_DIR,
                           f"libk4variant_{hv.hexdigest()[:16]}.so")
        proc = None
        if not os.path.isfile(out):
            proc = subprocess.Popen([_build._nvcc(), *flags, "-o", out, src],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        jobs.append((out, proc, extra))
    libs = []
    for out, proc, extra in jobs:
        if proc is not None:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise SystemExit(f"nvcc {' '.join(extra)} failed:\n{log}")
        lib = ctypes.CDLL(out)
        _build._bind(lib)
        if "-DLOAM_K4_CLOCKS" in extra:
            lib.loam_k4_set_clocks.argtypes = [ctypes.c_void_p]
            lib.loam_k4_set_clocks.restype = ctypes.c_int
        libs.append(lib)
    return libs


def inputs(dev):
    """The simulated submap of chip_smoke.kernel_inputs as a dense map and a
    sorted table, and one scan's queries at its pose."""
    import torch

    import chip_smoke as cs
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
                           cs.SUBMAP_CAP, dev)
    center = torch.tensor(poses[15][:3, 3].astype(np.float32), device=dev)
    ds_sub = pcops.compact(vox.voxel_downsample(sub, 0.5, center),
                           cs.SUBMAP_CAP)
    targets = {
        "dense": vox.build_dense_voxel_map(ds_sub, 2.0, center, cs.DIMS,
                                           cs.SLAB),
        "table": vox.build_voxel_map(ds_sub, cs.TABLE_GRID, center,
                                     cs.TABLE_VOXELS, cs.TABLE_SLAB)}
    scan = sim.simulate_scan(world, sim.sensor_from_body(poses[16]),
                             n_az=1800, n_el=16, rng=rng)
    src = pcops.compact(vox.voxel_downsample(
        pcops.from_numpy(scan, 32768, dev), 0.5), cs.N_QUERIES)
    pose = torch.tensor(poses[16].astype(np.float32), device=dev)
    return targets, src, geo.transform_points(pose, src.xyz), \
        loam.source_sqrt_range(src)


def most_resident(sm, t0, t1) -> int:
    """The most warps alive on one SM at once: the most overlapping
    [start, end) intervals among one SM's warps."""
    most = 0
    for s in np.unique(sm):
        ev = sorted([(a, 1) for a in t0[sm == s]]
                    + [(b, -1) for b in t1[sm == s]])
        run = 0
        for _, d in ev:
            run += d
            most = max(most, run)
    return most


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qpw", default="1,2,4,8",
                    help="queries per warp to build and run (comma-separated)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from simpleslam_tpu_torch.ops import _build
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    card = cs.environment()
    dev = torch.device("cuda")
    grids = [int(q) for q in args.qpw.split(",")]
    libs = build_libraries([
        flags for q in grids
        for flags in ([f"-DLOAM_K4_QPW={q}"],
                      [f"-DLOAM_K4_QPW={q}", "-DLOAM_K4_CLOCKS"])])
    targets, src, p_map, sqrt_r = inputs(dev)
    n_valid = int(src.mask.sum())
    for kind, vm in targets.items():
        cand, ok = loam.gather_candidates_at(vm, p_map, src.mask)
        ref = lk.fit_and_linearize_candidates_plain(cand, ok, p_map, sqrt_r,
                                                    src.mask)

        def k4():
            return lk.fit_and_linearize_candidates(cand, ok, p_map, sqrt_r,
                                                   src.mask)

        for i, q in enumerate(grids):
            timing, clock = libs[2 * i], libs[2 * i + 1]
            _build._lib = timing   # the wrapper launches this build now
            cs.check_k4(f"{kind} target, {q} queries a warp", k4(), ref)
            dev_ms, how = cs.kernel_device_ms_how(
                "fit_and_linearize_candidates", k4)
            _build._lib = clock
            n_blocks = clock.loam_k4_blocks(src.capacity)
            clocks = torch.zeros((n_blocks * WARPS, SLOTS), dtype=torch.int64,
                                 device=dev)
            if clock.loam_k4_set_clocks(clocks.data_ptr()) != 0:
                raise SystemExit("could not set the clock buffer")
            for _ in range(3):
                k4()
            clocks.zero_()
            torch.cuda.synchronize()
            k4()
            torch.cuda.synchronize()
            c = clocks.cpu().numpy()
            seg = c[:, :7].astype(np.float64)
            sm, t0, t1 = c[:, 7], c[:, 8], c[:, 9]
            busy = seg.sum(axis=1)
            mean = seg.mean(axis=0)
            per_warp_us = (t1 - t0) / 1e3
            print(f"K4 on the {kind} target, C={cand.shape[1]}, Q="
                  f"{src.capacity} ({n_valid} valid), {q} queries a warp: "
                  f"{n_blocks} blocks, device time {1e3 * dev_ms:.2f} us "
                  f"({how}), plane set and n_valid bit-identical to the "
                  f"plain version; with the probes: launch span "
                  f"{(t1.max() - t0.min()) / 1e3:.2f} us on the global "
                  f"timer, a warp's life {per_warp_us.mean():.2f} us mean, "
                  f"{per_warp_us.max():.2f} us max; up to "
                  f"{most_resident(sm, t0, t1)} warps on one SM at once; mean "
                  f"cycles per warp: "
                  + ", ".join(f"{n} {m:.0f} ({100 * m / busy.mean():.1f} %)"
                              for n, m in zip(SEGMENTS, mean))
                  + f" ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
