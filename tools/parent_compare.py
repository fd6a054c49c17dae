"""Hold one tree's PyTorch port against another's on one CUDA GPU.

    python3 tools/parent_compare.py measure TREE OUT.npz INPUTS.pt
    python3 tools/parent_compare.py compare A.npz B.npz [C.npz ...]

``measure`` imports ``simpleslam_tpu_torch`` and ``chip_smoke`` from TREE (a
checkout of the repository, e.g. a parent commit unpacked with ``git
archive``), builds its kernels there, and records on the inputs of
``chip_smoke.py``:
- K1's outputs on the merged map of phase 3 (the simulated submap and scan)
  at the on-pose and the 0.25 m offset placement, and K2's on the on-pose
  planes at the offset;
- the device time of one K1 and one K2 wrapper call over all its launches,
  its launches and the wrapper's CUDA-event median, on phase 3's scan and on
  the streamed full path's last scan (``call_device`` of this repository's
  ``chip_smoke.py``);
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
whether K1's plane set (centroid, normal, ok) and K4's outputs of every
file repeat those of the first bit for bit, whether K1's and K2's sums lie
within the op tolerances of the first file's (J^T J within 2e-5 max|J^T J|,
J^T e within 5e-4 max|J^T e|, n_valid equal: the order of the sums may
differ between trees), whether every file's K3 rows repeat the first
file's bit for bit and those of the same tree each other's; and prints the
largest per-registration gap between each file's K3 rows and the first
file's (pose, and whether the counts agree). It fails where any of those
does not hold.
"""

from __future__ import annotations

import os
import sys

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
POSE_T_TOL = 1e-4   # metres: K3 against the stepwise loop (chip_smoke.py)
POSE_R_TOL = 1e-5   # radians
JTJ_RTOL, JTE_RTOL = 2e-5, 5e-4   # chip_smoke.py's op tolerances
KINDS = ("merged", "dense", "table")
N_SUMS = 43         # J^T J (36), J^T e (6), n_valid: then the plane set


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
    from k1_breakdown import this_smoke
    from k3_breakdown import phase3_targets
    from simpleslam_tpu_torch.ops import geometry as geo
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk
    from simpleslam_tpu_torch.pipeline import streamed

    if not cs.__file__.startswith(tree) or not lk.__file__.startswith(tree):
        raise SystemExit(f"measure: did not import from {tree}")
    card = cs.environment()
    cs.build()
    call_device = this_smoke().call_device
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

    calls = {}

    def k1_k2_calls(tag, vm, src, sqrt_r, p_on, p_off):
        """K1's and K2's device time per wrapper call, launches, PyTorch's
        own device time per call and the wrapper's median."""
        planes = lk.fit_and_linearize_merged(vm, p_on, sqrt_r, src.mask)[3]
        for name, fn in (
                ("K1", lambda: lk.fit_and_linearize_merged(vm, p_on, sqrt_r,
                                                           src.mask)),
                ("K2", lambda: lk.plane_normal_equations(planes, p_off,
                                                         sqrt_r))):
            c = call_device(fn)
            calls[f"{name} {tag}"] = (
                [np.nan] * 3 if c is None else [c[0], c[1], c[3]]) + [
                    cs.time_ms(fn)]
            print(f"{name} on the {tag} ({tree}): {calls[f'{name} {tag}']} "
                  f"(device ms, launches, PyTorch's ms, wrapper ms; {card})")

    # phase 3's inputs
    vm, src, sqrt_r, p_on, p_off, pose = cs.kernel_inputs(dev)
    k1 = []
    for p_map in (p_on, p_off):
        jtj, jte, nv, pl = lk.fit_and_linearize_merged(vm, p_map, sqrt_r,
                                                       src.mask)
        k1.append(torch.cat([jtj.flatten(), jte, nv.float()[None],
                             pl.centroid.flatten(), pl.normal.flatten(),
                             pl.ok.float()]))
        if p_map is p_on:
            planes = pl
    jtj, jte, nv = lk.plane_normal_equations(planes, p_off, sqrt_r)
    k2 = torch.cat([jtj.flatten(), jte, nv.float()[None]])
    k1_k2_calls("phase 3 scan", vm, src, sqrt_r, p_on, p_off)
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
    k1_k2_calls("streamed full last scan", targets6["merged"], src, sqrt_r,
                p_map, geo.transform_points(cs.offset_pose(pose_n), src.xyz))
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
    np.savez(out, k1=torch.stack(k1).cpu().numpy(), k2=k2.cpu().numpy(),
             call_keys=np.array(list(calls)),
             calls=np.array(list(calls.values()), dtype=np.float64),
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
    print("K1 and K2 per wrapper call, in the order of the files: device us "
          "over all hand-kernel launches / launches / PyTorch's own device us "
          "(fills of new tensors) / wrapper ms (CUDA events):")
    for i, key in enumerate(ref["call_keys"]):
        vals = "  ".join(f"{1e3 * c[0]:.2f} / {c[1]:g} / {1e3 * c[2]:.2f} / "
                         f"{c[3]:.4f}" for c in (r["calls"][i] for r in runs))
        print(f"  {key:<32} {vals}")
    bad = 0
    rows = [k for k in ref if k.startswith("rows")]
    k4 = [k for k in ref if k.startswith("k4_") and "dev" not in k]
    for p, name, r in zip(paths, names, runs):
        same = {k: bool(np.array_equal(ref[k], r[k])) for k in k4}
        same["k1 plane set"] = bool(np.array_equal(ref["k1"][:, N_SUMS:],
                                                   r["k1"][:, N_SUMS:]))
        sums = {"k1": all(sums_close(a[:N_SUMS], b[:N_SUMS])
                          for a, b in zip(r["k1"], ref["k1"])),
                "k2": sums_close(r["k2"], ref["k2"])}
        gaps = {k: row_gap(r[k], ref[k]) for k in rows}
        twin = next((i for i, n in enumerate(names) if n == name), None)
        repeats = all(np.array_equal(runs[twin][k], r[k]) for k in rows)
        rows_same = all(np.array_equal(ref[k], r[k]) for k in rows)
        worst_t = max(g[0] for g in gaps.values())
        worst_r = max(g[1] for g in gaps.values())
        differ = sum(g[2] for g in gaps.values())
        n_reg = sum(len(r[k]) for k in rows)
        print(f"{p} ({name}): bit-identical to {paths[0]}: "
              + ", ".join(f"{k} {v}" for k, v in same.items())
              + ", K3 rows " + str(rows_same)
              + "; sums within the op tolerances of the first file's: "
              + ", ".join(f"{k} {v}" for k, v in sums.items())
              + f"; K3 rows repeat the first file of this tree: {repeats}; "
              f"largest per-registration gap to {paths[0]}: {worst_t:.3e} m /"
              f" {worst_r:.3e} rad over {n_reg} registrations ("
              + ", ".join(f"{k} {g[0]:.3e} m" for k, g in gaps.items())
              + f"), counts differ in {differ} ({r['card']})")
        bad += not all(same.values()) or not all(sums.values()) \
            or not repeats or not rows_same \
            or worst_t > POSE_T_TOL or worst_r > POSE_R_TOL \
            or differ > 0.01 * n_reg
    return 1 if bad else 0


def sums_close(a: np.ndarray, b: np.ndarray) -> bool:
    """J^T J (36), J^T e (6) and n_valid of ``a`` within the op tolerances
    of ``b``'s, n_valid equal."""
    return bool(a[42] == b[42]
                and np.abs(a[:36] - b[:36]).max()
                <= JTJ_RTOL * np.abs(b[:36]).max()
                and np.abs(a[36:42] - b[36:42]).max()
                <= JTE_RTOL * np.abs(b[36:42]).max())


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
