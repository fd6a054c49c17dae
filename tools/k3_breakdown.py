"""K3 (``gn_loop_fused``) device time, and where its warps spend their
cycles, on one CUDA GPU.

    python3 tools/k3_breakdown.py [--csrc DIR] [--label NAME] [--skip-streamed]

Builds the kernel library twice from the sources in DIR (the package's own
``simpleslam_tpu_torch/csrc`` by default; another tree's to measure it, the
same probes in its K3), both builds at once: as it is, and with
``-DLOAM_K3_CLOCKS`` (every K3 warp adds SM clock cycles per segment of its
work; lane 0 writes them with the queries it selected, its SM and its start
and end on the global timer). It runs K3 through its wrapper on every LOAM
target (the merged map, the dense map, the sorted table) on two sets of
inputs: those of ``chip_smoke.py``'s phase 3 (a simulated submap, one
scan's 8192 queries) and the streamed full path's last target and last scan
prepped at its latched capacity (phases 6 and 12), each from the scan's pose
and from the 0.25 m offset start. Per case it prints the first build's
device time (torch.profiler), the iterations and K1 phases, the loop's
barrier floor (iterations x one grid barrier), the byte bound of
``chip_smoke.py``, and from the clock build the mean cycles per warp in each
segment with its share, the queries a warp selected (mean and most) and the
launch's span on the global timer. The probes cost time of their own: read
the shares, not the sum, against the first build's device time.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
SEGMENTS = ("prologue", "K1 wait", "K1 search", "K1 stage", "K1 select",
            "K1 tail", "K1 row", "K2 work", "block sums", "barrier wait",
            "partials", "small step", "epilogue")
SLOTS = 18   # kK3ClockSlots in csrc/loam_kernels.cu
WARPS = 16   # kK3Warps
QUERIES, SM, T0, T1, ITERS = 13, 14, 15, 16, 17


def phase3_targets(dev):
    """The simulated submap of chip_smoke.kernel_inputs as all three
    targets, and one scan's queries with its pose."""
    import torch

    import chip_smoke as cs
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
        "merged": vox.build_merged_dense_voxel_map(ds_sub, 2.0, center,
                                                   cs.DIMS, cs.SLAB),
        "dense": vox.build_dense_voxel_map(ds_sub, 2.0, center, cs.DIMS,
                                           cs.SLAB),
        "table": vox.build_voxel_map(ds_sub, cs.TABLE_GRID, center,
                                     cs.TABLE_VOXELS, cs.TABLE_SLAB)}
    scan = sim.simulate_scan(world, sim.sensor_from_body(poses[16]),
                             n_az=1800, n_el=16, rng=rng)
    src = pcops.compact(vox.voxel_downsample(
        pcops.from_numpy(scan, 32768, dev), 0.5), cs.N_QUERIES)
    return targets, src, torch.tensor(poses[16].astype(np.float32),
                                      device=dev)


def streamed_targets(dev, card):
    """The streamed full path's last target as all three kinds, and its last
    scan prepped at the latched capacity with its recorded pose."""
    import torch

    import chip_smoke as cs
    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.pipeline import streamed

    streams = sim.simulate_sequence(sim.make_world(seed=0), n_scans=150,
                                    seed=0, n_az=1800, n_el=16)
    _, system, result = cs.streamed_run(
        "streamed full (bench full config)", cs.BENCH_FULL, streams, card,
        prewarm=True, probe_scans=0)
    cap = int(result.extras["scan_capacity"])
    n = len(streams.scan_stamps)
    scans, _ = cs.prep_scans(system, streams, [n - 1], cap)
    src = streamed.upload_cloud(torch.from_numpy(scans).to(dev)[0])
    merged = system.map_manager.get_target()
    system.map_manager.commit_pending_target()
    targets = {"merged": merged, **cs.other_targets(system)}
    return targets, src, torch.tensor(result.poses[n - 1].astype(np.float32),
                                      device=dev)


def k3_bound(kind, vm, src, pose, gathers, iters):
    """chip_smoke.py's byte bound of K3 on this target from this start."""
    import chip_smoke as cs

    if kind == "merged":
        n_valid = int(src.mask.sum())
        return cs.bounds(src.capacity, n_valid, 8 * vm.slab_pts, gathers,
                         iters)["k3"][0]
    return cs.target_k3_bound(kind, vm, src, pose, gathers, iters)[0]


def ptxas_lines(logs):
    """nvcc's -Xptxas -v lines of K3's instantiations (registers, spills)."""
    out = []
    for log in logs:
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "gn_loop_kernel" in line and "Compiling entry" in line:
                name = re.search(r"gn_loop_kernel\w*?(Merged|Dense|Table)",
                                 line)
                for nxt in lines[i + 1:i + 4]:
                    if "registers" in nxt or "spill" in nxt:
                        out.append(f"{name.group(1) if name else '?'}: "
                                   f"{nxt.strip()}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=None,
                    help="kernel sources to build (default: the package's)")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--skip-streamed", action="store_true",
                    help="phase 3's inputs only (no streamed full run)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from k4_breakdown import build_libraries, most_resident
    from simpleslam_tpu_torch.ops import _build
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    card = cs.environment()
    dev = torch.device("cuda")
    logs = []
    timing, clock = build_libraries([[], ["-DLOAM_K3_CLOCKS"]], args.csrc,
                                    logs)
    for line in ptxas_lines(logs[:1]):
        print(f"ptxas ({args.label}), K3 on {line}")
    _build._lib = timing
    one = cs.time_ms(lambda: lk.barrier_probe(dev, 1))
    many = cs.time_ms(lambda: lk.barrier_probe(dev, 257))
    barrier_us = 1e3 * (many - one) / 256.0
    print(f"one grid barrier {barrier_us:.3f} us ({card})")
    sets = [("phase 3", *phase3_targets(dev))]
    if not args.skip_streamed:
        sets.append(("streamed full", *streamed_targets(dev, card)))
    grid = timing.loam_gn_loop_grid()
    for set_name, targets, src, pose in sets:
        n_valid = int(src.mask.sum())
        for kind, vm in targets.items():
            for tag, start in (("on-pose", pose),
                               ("offset", cs.offset_pose(pose))):
                start = start.to(torch.float32).contiguous()

                def k3():
                    return lk.gn_loop_fused(src.xyz, src.mask, vm, start,
                                            loam.MAX_ITERS, 0.0)

                _build._lib = timing
                row = k3().cpu().numpy()
                iters, gathers = int(row[lk.GN_ITERS]), int(row[lk.GN_GATHERS])
                dev_ms, how = cs.kernel_device_ms_how("gn_loop_kernel", k3)
                bound_us = 1e3 * k3_bound(kind, vm, src, start, gathers, iters)
                _build._lib = clock
                clocks = torch.zeros((grid * WARPS, SLOTS), dtype=torch.int64,
                                     device=dev)
                if clock.loam_k3_set_clocks(clocks.data_ptr()) != 0:
                    raise SystemExit("could not set the clock buffer")
                for _ in range(3):
                    k3()
                clocks.zero_()
                torch.cuda.synchronize()
                again = k3().cpu().numpy()
                same = np.array_equal(again, row)
                c = clocks.cpu().numpy()
                seg = c[:, :len(SEGMENTS)].astype(np.float64)
                busy = seg.sum(axis=1)
                mean = seg.mean(axis=0)
                q = c[:, QUERIES]
                t0, t1 = c[:, T0], c[:, T1]
                print(f"K3 ({args.label}) on the {set_name} {kind} target, "
                      f"Q={src.capacity} ({n_valid} valid), {tag} start: "
                      f"{iters} iterations, {gathers} K1 phases; device time "
                      f"{1e3 * dev_ms:.2f} us ({how}), bound "
                      f"{bound_us:.3f} us ({100 * bound_us / (1e3 * dev_ms):.2f}"
                      f" % of its rate), barrier floor "
                      f"{iters * barrier_us:.2f} us; with the probes (result "
                      f"row {'bit-identical' if same else 'DIFFERENT'}): launch "
                      f"span {(t1.max() - t0.min()) / 1e3:.2f} us, "
                      f"{most_resident(c[:, SM], t0, t1)} warps on one SM at "
                      f"once, queries selected per warp {q.mean():.2f} mean, "
                      f"{q.max()} most; mean cycles per warp: "
                      + ", ".join(f"{n} {m:.0f} ({100 * m / busy.mean():.1f} %)"
                                  for n, m in zip(SEGMENTS, mean))
                      + f" ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
