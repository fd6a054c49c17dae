"""Hold one tree's PyTorch port against another's on one CUDA GPU.

    python3 tools/parent_compare.py measure TREE OUT.npz INPUTS.pt
    python3 tools/parent_compare.py compare A.npz B.npz [C.npz ...]

``measure`` imports ``simpleslam_tpu_torch`` and ``chip_smoke`` from TREE (a
checkout of the repository, e.g. a parent commit unpacked with ``git
archive``), builds its kernels there, and records on the inputs of
``chip_smoke.py``:
- K1's outputs on the merged map of phase 3 (the simulated submap and scan)
  at the on-pose and the 0.25 m offset placement;
- K3's result rows on phase 3's submap as a merged map, a dense map and a
  sorted table (``tools/k3_breakdown.py`` builds them), from the on-pose, a
  small-offset and the 0.25 m offset start, degeneracy guard off and on;
- K3's result rows on the streamed full path's last 48 scans (phase 6: its
  last target, the scans prepped at the latched capacity), on that target
  and on its last submap as a dense map and a sorted table, from the
  recorded and the offset pose, guard off and on. The streamed path runs
  K3 itself, so two trees whose K3 rounds differently end it on different
  maps and poses: the first ``measure`` runs it and writes those inputs
  (scans, poses, targets) to INPUTS.pt, and every later one reads them from
  there, so all trees are held on the same inputs;
- K3's device time (torch.profiler) on each of those three targets, on
  phase 3's scan and on the path's last scan, from the scan's pose and from
  the 0.25 m offset;
- K4's outputs (sums, count and plane set) and device time on the last
  scan's candidates from the path's last submap as a dense map and as a
  sorted table (phase 12).
Run each measurement in its own process (two trees cannot share one), in
turns: parent, change, change, parent. ``compare`` lists the device times
of every file side by side with the card's name and power limit; says
whether K1's and K4's outputs of every file repeat those of the first bit
for bit, and whether files of the same tree repeat each other's K3 rows;
and prints the largest per-registration gap between each file's K3 rows and
the first file's (pose, and whether the counts agree). It fails where K1 or
K4 differ, where a tree does not repeat itself, or where a gap passes
1e-4 m / 1e-5 rad.
"""

from __future__ import annotations

import os
import sys

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
POSE_T_TOL = 1e-4   # metres: K3 against the stepwise loop (chip_smoke.py)
POSE_R_TOL = 1e-5   # radians
KINDS = ("merged", "dense", "table")


def phase6_inputs(path: str, cs, card: str, dev):
    """The streamed full path's last 48 scans (uploaded), their recorded
    poses and its three targets: from ``path`` where it exists, else from a
    run of the path on this tree, then written to ``path``."""
    import importlib

    import torch

    from simpleslam_tpu_torch.pipeline import simulate as sim

    if os.path.exists(path):
        saved = torch.load(path, map_location=dev, weights_only=False)
        targets = {
            kind: getattr(importlib.import_module(mod), cls)(**fields)
            for kind, (mod, cls, fields) in saved["targets"].items()}
        print(f"phase 6 inputs read from {path}")
        return saved["scans"], saved["poses"], targets
    streams = sim.simulate_sequence(sim.make_world(seed=0), n_scans=150,
                                    seed=0, n_az=1800, n_el=16)
    _, system, result = cs.streamed_run(
        "streamed full (bench full config)", cs.BENCH_FULL, streams, card,
        prewarm=True, probe_scans=0)
    cap = int(result.extras["scan_capacity"])
    n = len(streams.scan_stamps)
    idx = list(range(max(1, n - 1 - cs.N_FUSED_SCANS), n))
    scans, _ = cs.prep_scans(system, streams, idx, cap)
    scans = torch.from_numpy(scans).to(dev)
    poses = torch.tensor(np.stack([result.poses[j] for j in idx])
                         .astype(np.float32), device=dev)
    targets = {"merged": system.map_manager.get_target()}
    system.map_manager.commit_pending_target()
    targets.update(cs.other_targets(system))
    torch.save({"scans": scans, "poses": poses,
                "targets": {kind: (type(vm).__module__, type(vm).__name__,
                                   vm._asdict())
                            for kind, vm in targets.items()}}, path)
    print(f"phase 6 inputs of scans {idx[0]}-{idx[-1]} written to {path}")
    return scans, poses, targets


def measure(tree: str, out: str, inputs: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, TOOLS)
    import torch

    import chip_smoke as cs
    from k3_breakdown import phase3_targets
    from simpleslam_tpu_torch.ops import geometry as geo
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import streamed

    if not cs.__file__.startswith(tree) or not lk.__file__.startswith(tree):
        raise SystemExit(f"measure: did not import from {tree}")
    card = cs.environment()
    cs.build()
    dev = torch.device("cuda")

    def k3_rows(src, vm, pose, starts=("pose", "small", "offset")):
        small = pose.clone()
        small[:3, 3] += torch.tensor(cs.SMALL_OFFSET, device=dev)
        at = {"pose": pose, "small": small, "offset": cs.offset_pose(pose)}
        rows = []
        for name in starts:
            start = at[name].to(torch.float32).contiguous()
            for degen in (0.0, cs.DEGEN):
                rows.append(lk.gn_loop_fused(src.xyz, src.mask, vm, start,
                                             loam.MAX_ITERS, degen))
        return torch.stack(rows)

    k3_dev = {}

    def k3_time(tag, src, vm, pose):
        for start_tag, start in (("pose", pose),
                                 ("offset", cs.offset_pose(pose))):
            start = start.to(torch.float32).contiguous()
            ms = cs.kernel_device_ms(
                "gn_loop_kernel", lambda: lk.gn_loop_fused(
                    src.xyz, src.mask, vm, start, loam.MAX_ITERS, 0.0))
            k3_dev[f"{tag} {start_tag}"] = np.nan if ms is None else ms

    # phase 3's inputs
    vm, src, sqrt_r, p_on, p_off, pose = cs.kernel_inputs(dev)
    k1 = []
    for p_map in (p_on, p_off):
        jtj, jte, nv, pl = lk.fit_and_linearize_merged(vm, p_map, sqrt_r,
                                                       src.mask)
        k1.append(torch.cat([jtj.flatten(), jte, nv.float()[None],
                             pl.centroid.flatten(), pl.normal.flatten(),
                             pl.ok.float()]))
    del vm
    targets3, src3, pose3 = phase3_targets(dev)
    rows3 = {}
    for kind in KINDS:
        rows3[kind] = k3_rows(src3, targets3[kind], pose3)
        k3_time(f"phase 3 {kind}", src3, targets3[kind], pose3)
    del targets3

    # phase 6's inputs: the streamed full path's last target and scans
    scans_d, poses6, targets6 = phase6_inputs(inputs, cs, card, dev)
    rows6 = {kind: [] for kind in KINDS}
    for k in range(len(scans_d)):
        src_j = streamed.upload_cloud(scans_d[k])
        for kind in KINDS:
            rows6[kind].append(k3_rows(src_j, targets6[kind], poses6[k],
                                       ("pose", "offset")))
    rows6 = {kind: torch.cat(r) for kind, r in rows6.items()}
    src = streamed.upload_cloud(scans_d[-1])
    pose_n = poses6[-1]
    for kind in KINDS:
        k3_time(f"streamed full {kind}", src, targets6[kind], pose_n)

    # phase 12's inputs: K4 on the last scan's candidates
    p_map = geo.transform_points(pose_n, src.xyz)
    sqrt_r = loam.source_sqrt_range(src)
    k4_dev, k4_out = {}, {}
    for kind in ("dense", "table"):
        cand, ok = loam.gather_candidates_at(targets6[kind], p_map, src.mask)

        def k4():
            return lk.fit_and_linearize_candidates(cand, ok, p_map, sqrt_r,
                                                   src.mask)

        jtj, jte, nv, pl = k4()
        k4_out[kind] = torch.cat([jtj.flatten(), jte, nv.float()[None],
                                  pl.centroid.flatten(), pl.normal.flatten(),
                                  pl.ok.float()]).cpu().numpy()
        k4_dev[kind] = cs.kernel_device_ms("fit_and_linearize_candidates", k4)
        print(f"K4 on the {kind} target ({tree}): device "
              f"{k4_dev[kind]} ms ({card})")
    for key, ms in k3_dev.items():
        print(f"K3 on the {key} ({tree}): device {ms} ms ({card})")
    np.savez(out, k1=torch.stack(k1).cpu().numpy(),
             **{f"rows3_{k}": r.cpu().numpy() for k, r in rows3.items()},
             **{f"rows6_{k}": r.cpu().numpy() for k, r in rows6.items()},
             **{f"k4_{k}": v for k, v in k4_out.items()},
             k4_dev_keys=np.array(list(k4_dev)),
             k4_dev=np.array([np.nan if v is None else v
                              for v in k4_dev.values()]),
             k3_dev_keys=np.array(list(k3_dev)),
             k3_dev=np.array(list(k3_dev.values())),
             tree=tree, card=card)
    print(f"measured {tree}: K1 x {len(k1)}, K3 rows "
          + ", ".join(f"{k} {tuple(r.shape)}" for k, r in rows3.items())
          + " (phase 3), "
          + ", ".join(f"{k} {tuple(r.shape)}" for k, r in rows6.items())
          + f" (phase 6) -> {out}")


def _rot_angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    dR = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    return 0.5 * float(np.linalg.norm([dR[2, 1] - dR[1, 2],
                                       dR[0, 2] - dR[2, 0],
                                       dR[1, 0] - dR[0, 1]]))


def row_gap(a: np.ndarray, b: np.ndarray):
    """Largest pose gap (m, rad) between two stacks of K3 result rows
    (pose 4x4 in the first 16 floats, then converged, iterations, gathers,
    n_valid), over the registrations whose counts agree, and how many do
    not agree."""
    t = r = 0.0
    differ = 0
    for x, y in zip(a, b):
        if not np.array_equal(x[16:19], y[16:19]) or abs(x[19] - y[19]) > 4:
            differ += 1
            continue
        px, py = x[:16].reshape(4, 4), y[:16].reshape(4, 4)
        t = max(t, float(np.linalg.norm(px[:3, 3].astype(np.float64)
                                        - py[:3, 3])))
        r = max(r, _rot_angle(px[:3, :3], py[:3, :3]))
    return t, r, differ


def compare(paths) -> int:
    runs = [dict(np.load(p)) for p in paths]
    ref = runs[0]
    names = [str(r["tree"]) for r in runs]
    print("device time per launch, us, in the order of the files "
          f"({', '.join(paths)}):")
    for key_name, val_name, what in (("k3_dev_keys", "k3_dev", "K3"),
                                     ("k4_dev_keys", "k4_dev", "K4")):
        for i, key in enumerate(ref[key_name]):
            vals = "  ".join(f"{1e3 * float(r[val_name][i]):8.2f}"
                             for r in runs)
            print(f"  {what} {key:<28} {vals}")
    bad = 0
    rows = [k for k in ref if k.startswith("rows")]
    k4 = [k for k in ref if k.startswith("k4_") and "dev" not in k]
    for p, name, r in zip(paths, names, runs):
        same = {k: bool(np.array_equal(ref[k], r[k])) for k in ["k1", *k4]}
        gaps = {k: row_gap(r[k], ref[k]) for k in rows}
        twin = next((i for i, n in enumerate(names) if n == name), None)
        repeats = all(np.array_equal(runs[twin][k], r[k]) for k in rows)
        worst_t = max(g[0] for g in gaps.values())
        worst_r = max(g[1] for g in gaps.values())
        differ = sum(g[2] for g in gaps.values())
        n_reg = sum(len(r[k]) for k in rows)
        print(f"{p} ({name}): bit-identical to {paths[0]}: "
              + ", ".join(f"{k} {v}" for k, v in same.items())
              + f"; K3 rows repeat the first file of this tree: {repeats}; "
              f"largest per-registration gap to {paths[0]}: {worst_t:.3e} m /"
              f" {worst_r:.3e} rad over {n_reg} registrations ("
              + ", ".join(f"{k} {g[0]:.3e} m" for k, g in gaps.items())
              + f"), counts differ in {differ} ({r['card']})")
        bad += not all(same.values()) or not repeats \
            or worst_t > POSE_T_TOL or worst_r > POSE_R_TOL \
            or differ > 0.01 * n_reg
    return 1 if bad else 0


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "measure":
        measure(sys.argv[2], sys.argv[3], sys.argv[4])
        return 0
    if len(sys.argv) >= 4 and sys.argv[1] == "compare":
        return compare(sys.argv[2:])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
