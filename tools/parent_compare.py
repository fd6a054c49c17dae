"""Hold one tree's PyTorch port against another's on one CUDA GPU.

    python3 tools/parent_compare.py measure TREE OUT.npz
    python3 tools/parent_compare.py compare A.npz B.npz [C.npz ...]

``measure`` imports ``simpleslam_tpu_torch`` and ``chip_smoke`` from TREE (a
checkout of the repository, e.g. a parent commit unpacked with ``git
archive``), builds its kernels there, and records on the inputs of
``chip_smoke.py``:
- K1's outputs and K3's result rows on the merged map of phase 3 (the
  simulated submap and scan), from the on-pose, a small-offset and the
  0.25 m offset start, degeneracy guard off and on;
- K3's result rows on the streamed full path's last 48 scans (phase 6:
  its last target, the scans prepped at the latched capacity), from the
  recorded and the offset pose, guard off and on;
- K4's device time (torch.profiler) on the last scan's candidates from
  that path's last submap as a dense map and as a sorted table (phase 12).
Run each measurement in its own process (two trees cannot share one), in
turns: parent, change, change, parent. ``compare`` says whether the
results of the first file repeat bit for bit in each other one, and lists
the K4 device times beside each other with the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def measure(tree: str, out: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from simpleslam_tpu_torch.ops import geometry as geo
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.pipeline import streamed

    if not cs.__file__.startswith(tree) or not lk.__file__.startswith(tree):
        raise SystemExit(f"measure: did not import from {tree}")
    card = cs.environment()
    cs.build()
    dev = torch.device("cuda")

    def k3_rows(src, vm, pose):
        small = pose.clone()
        small[:3, 3] += torch.tensor(cs.SMALL_OFFSET, device=dev)
        rows = []
        for start in (pose, small, cs.offset_pose(pose)):
            start = start.to(torch.float32).contiguous()
            for degen in (0.0, cs.DEGEN):
                rows.append(lk.gn_loop_fused(src.xyz, src.mask, vm, start,
                                             loam.MAX_ITERS, degen))
        return torch.stack(rows)

    # phase 3's inputs
    vm, src, sqrt_r, p_on, p_off, pose = cs.kernel_inputs(dev)
    k1 = []
    for p_map in (p_on, p_off):
        jtj, jte, nv, pl = lk.fit_and_linearize_merged(vm, p_map, sqrt_r,
                                                       src.mask)
        k1.append(torch.cat([jtj.flatten(), jte, nv.float()[None],
                             pl.centroid.flatten(), pl.normal.flatten(),
                             pl.ok.float()]))
    rows3 = k3_rows(src, vm, pose)
    del vm

    # phase 6's inputs: the streamed full path's last target and scans
    streams = sim.simulate_sequence(sim.make_world(seed=0), n_scans=150,
                                    seed=0, n_az=1800, n_el=16)
    _, system, result = cs.streamed_run(
        "streamed full (bench full config)", cs.BENCH_FULL, streams, card,
        prewarm=True, probe_scans=0)
    cap = int(result.extras["scan_capacity"])
    n = len(streams.scan_stamps)
    idx = list(range(max(1, n - 1 - cs.N_FUSED_SCANS), n))
    scans, _ = cs.prep_scans(system, streams, idx, cap)
    scans_d = torch.from_numpy(scans).to(dev)
    target = system.map_manager.get_target()
    rows6 = []
    for k, j in enumerate(idx):
        src_j = streamed.upload_cloud(scans_d[k])
        pose_j = torch.tensor(result.poses[j].astype(np.float32), device=dev)
        rows6.append(k3_rows(src_j, target, pose_j))
    rows6 = torch.cat(rows6)

    # phase 12's inputs: K4's device time on the last scan's candidates
    system.map_manager.commit_pending_target()
    targets = cs.other_targets(system)
    src = streamed.upload_cloud(scans_d[-1])
    p_map = geo.transform_points(
        torch.tensor(result.poses[n - 1].astype(np.float32), device=dev),
        src.xyz)
    sqrt_r = loam.source_sqrt_range(src)
    k4_dev = {}
    for kind, tvm in targets.items():
        cand, ok = loam.gather_candidates_at(tvm, p_map, src.mask)
        k4_dev[kind] = cs.kernel_device_ms(
            "fit_and_linearize_candidates",
            lambda: lk.fit_and_linearize_candidates(cand, ok, p_map, sqrt_r,
                                                    src.mask))
        print(f"K4 on the {kind} target ({tree}): device "
              f"{k4_dev[kind]} ms ({card})")
    np.savez(out, k1=torch.stack(k1).cpu().numpy(),
             rows3=rows3.cpu().numpy(), rows6=rows6.cpu().numpy(),
             k4_dense=np.float64(k4_dev["dense"] or np.nan),
             k4_table=np.float64(k4_dev["table"] or np.nan),
             tree=tree, card=card)
    print(f"measured {tree}: K1 x {len(k1)}, K3 rows {tuple(rows3.shape)} "
          f"(phase 3) and {tuple(rows6.shape)} (phase 6) -> {out}")


def compare(paths) -> int:
    runs = [dict(np.load(p)) for p in paths]
    ref = runs[0]
    bad = 0
    for p, r in zip(paths, runs):
        same = {k: bool(np.array_equal(ref[k], r[k]))
                for k in ("k1", "rows3", "rows6")}
        print(f"{p} ({r['tree']}): K4 device dense "
              f"{1e3 * float(r['k4_dense']):.2f} us, table "
              f"{1e3 * float(r['k4_table']):.2f} us; bit-identical to "
              f"{paths[0]}: K1 {same['k1']}, K3 phase 3 {same['rows3']}, "
              f"K3 phase 6 {same['rows6']} ({r['card']})")
        bad += not all(same.values())
    return 1 if bad else 0


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "measure":
        measure(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) >= 4 and sys.argv[1] == "compare":
        return compare(sys.argv[2:])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
