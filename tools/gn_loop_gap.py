"""Where the mesh pipeline parts from the single-rank pipeline, scan by scan.

    python3 tools/gn_loop_gap.py [--configs full,courtyard] [--ranks 2]
                                 [--out FILE] [--device cuda] [--scans 150]
    python3 tools/gn_loop_gap.py --guard N

The single-rank pipeline registers every scan with one launch of K3
(``loam.gn_loop``); a mesh of several ranks registers through the stepwise
loop (K1 or K4 on a refresh, K2 otherwise, one cross-rank sum per
iteration), which sums in another order and solves the 6x6 step with
``torch.linalg.solve`` instead of K3's own factorization. This script runs
each of ``chip_smoke.py``'s two mesh pipeline configs (the bench's ``full``
config on the 150-scan bench sequence, 32-scan batches; the courtyard loop,
200 scans, 16-scan batches) on the card in these variants:

- ``k3``: the single-rank run (the reference of the mesh path's check);
- ``stepwise``: the same, with every registration through the stepwise loop
  on one rank (no collective);
- ``k3_pcg`` / ``stepwise_pcg`` (courtyard, whose backend solves): the two
  above with the pose graph solved by PCG, as a mesh's edge-sharded solve
  does, instead of the dense LM of a single device;
- ``mesh``: the pipeline on ``--ranks`` ranks (``tpu.mesh_devices``).

In the single-rank variants every registration is recorded with its start
pose, its result and its iteration and refresh counts, and the other GN
loop (stepwise in a K3 run, K3 in a stepwise run) is run on the same inputs
beside it. It prints, per config and variant against ``k3``: the largest
per-scan gap of the final poses, the first scan past 1e-4, 1e-3 and 5e-3 m,
keyframes, accepted closures and ATE; for the stepwise variants, the first
registration whose result moves past 1e-3 m from ``k3``'s, with both
runs' start gap and iteration counts there; and in every single-rank run
the registrations where K3 and the stepwise loop, on identical inputs,
stop after a different number of iterations (the convergence test
|dx_t|, |dx_r| <= 5e-3 is taken before the step is applied, so such a flip
leaves one loop a step of up to 5 mm short of the other). The JSON of it
all goes to ``--out``; the last line of stdout is its summary.
``--device cpu`` rehearses it on the CPU (where both loops are the plain
stepwise loop; use few ``--scans``).

``--guard N`` shows instead where K3 and the stepwise loop part with the
degeneracy guard on: on the streamed full path's last target and last 48
scans as phase 6 preps them, it registers every scan from its recorded pose
and from the 0.25 m offset three ways: K3 (``loam.gn_loop``), the stepwise
loop as it is (its guarded solve takes the eigenbasis in float64) and the
stepwise loop with the guarded solve in float32 (an f32 ``eigh``, the JAX
package's precision). It prints the largest gap of each stepwise variant to
K3, and for the ``N`` registrations where the f32 one parts furthest, each
iteration's system as the stepwise loop met it: the eigenvalues (float64),
the guard's floor, and how far the f32 ``eigh`` step, the float64 step
rounded to f32 and K3's own step (``csrc/gn_step.h``, its Jacobi sweep,
built for the host: ``native.gn_step``) lie from the float64 step.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (configs; sets CUBLAS_WORKSPACE_CONFIG)
import torch  # noqa: E402

GAPS = (1e-4, 1e-3, 5e-3)   # metres: the first scans past these are reported
DEVICE = "cuda"             # "cpu" rehearses the script (--device cpu)


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"


def _row(res) -> dict:
    pose, conv, _, iters, gathers, support = res
    return {"pose": pose.detach().cpu().numpy().astype(np.float64),
            "converged": bool(conv), "iters": int(iters),
            "gathers": int(gathers), "n_valid": int(support)}


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_clone(f) for f in obj))
    return obj


def run_variant(cfg: dict, streams, sync_every: int, loop: str, pcg: bool,
                capture: int | None = None):
    """One single-rank run; ``loop`` "k3" or "stepwise" registers every
    scan (the other loop recorded beside it on the same inputs). With
    ``capture`` the inputs of that registration are kept: (scan, map,
    start)."""
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import posegraph as pgo
    from simpleslam_tpu_torch.pipeline import app
    from simpleslam_tpu_torch.pipeline import streamed

    orig = streamed.register_kind
    dense_k = pgo.DENSE_SOLVE_MAX_K
    records, captured = [], []

    def stepwise(ds, target, init, degen):
        r = loam.gn_loop_stepwise(ds, target, init, degen_per_row=degen)
        z = torch.zeros((), dtype=torch.float32, device=init.device)
        return (r.pose, r.converged, z, r.iters, r.n_gathers, r.n_valid)

    def recorded(ds, target, init, kind, degen=0.0, *hooks):
        if len(records) == capture:
            captured.append((_clone(ds), _clone(target), init.clone()))
        k3 = orig(ds, target, init, kind, degen)
        sw = stepwise(ds, target, init, degen)
        main, other = (k3, sw) if loop == "k3" else (sw, k3)
        rec = {"init": init.detach().cpu().numpy().astype(np.float64),
               **_row(main)}
        rec["other"] = _row(other)
        records.append(rec)
        return main

    streamed.register_kind = recorded
    if pcg:
        pgo.DENSE_SOLVE_MAX_K = 0
    try:
        system = app.SlamSystem(dict(cfg, torch={"device": DEVICE}))
        system.prewarm()
        res = streamed.run_streamed(system, streams, sync_every=sync_every)
        be = system.backend
        out = {"poses": res.poses, "keyframes": int(res.keyframe_count),
               "closures": int(be.n_lc_edges) if be is not None else 0,
               "solves": int(be.n_solves) if be is not None else 0,
               "records": records,
               "captured": captured[0] if captured else None}
        system.shutdown()
        return out
    finally:
        streamed.register_kind = orig
        pgo.DENSE_SOLVE_MAX_K = dense_k


def run_mesh(cfg: dict, streams, sync_every: int, n: int) -> dict:
    from simpleslam_tpu_torch.parallel import multihost

    with tempfile.TemporaryDirectory(prefix="gn_loop_gap_") as tmp:
        path = os.path.join(tmp, "streams.pkl")
        with open(path, "wb") as f:
            pickle.dump(streams, f)
        res = multihost.run_hosts(
            n, "simpleslam_tpu_torch.parallel.workers:pipeline_worker",
            {"config": dict(cfg, torch={"device": DEVICE},
                            tpu=dict(cfg.get("tpu", {}), mesh_devices=n)),
             "streams": path, "sync_every": sync_every},
            timeout=600.0, device=DEVICE)
    r0 = res[0]
    if any(r["poses"] != r0["poses"] for r in res[1:]):
        raise RuntimeError("mesh ranks differ")
    return {"poses": np.asarray(r0["poses"]),
            "keyframes": r0["keyframe_count"],
            "closures": r0["lc_accepted"] or 0,
            "solves": (r0["backend"] or {}).get("n_solves", 0)}


def gap_report(ref: dict, run: dict, gt) -> dict:
    from simpleslam_tpu_torch.pipeline import simulate as sim

    err = np.linalg.norm(run["poses"][:, :3, 3] - ref["poses"][:, :3, 3],
                         axis=1)
    first = {}
    for g in GAPS:
        over = np.nonzero(err > g)[0]
        first[f"{g:g}"] = int(over[0]) if len(over) else None
    return {"max_gap_m": float(err.max()), "argmax_scan": int(err.argmax()),
            "first_scan_past": first, "keyframes": run["keyframes"],
            "closures": run["closures"], "solves": run["solves"],
            "ate_m": float(sim.ate_rmse(gt, run["poses"], align=False))}


def _t(a, b) -> float:
    return float(np.linalg.norm(a[:3, 3] - b[:3, 3]))


def flips(records) -> list:
    """Registrations where the two loops, on the same inputs, stop after a
    different number of iterations: (index, iterations of the run's loop,
    of the other, their pose gap)."""
    return [(i, r["iters"], r["other"]["iters"],
             _t(r["pose"], r["other"]["pose"]))
            for i, r in enumerate(records)
            if r["iters"] != r["other"]["iters"]]


def parting(ref_recs, recs) -> dict | None:
    """The first registration whose result lies past 1e-3 m from the
    reference run's, with the two starts' gap and both loops' counts."""
    for i, (a, b) in enumerate(zip(ref_recs, recs)):
        out = _t(a["pose"], b["pose"])
        if out > 1e-3:
            return {"registration": i, "result_gap_m": out,
                    "start_gap_m": _t(a["init"], b["init"]),
                    "previous_result_gap_m": (_t(ref_recs[i - 1]["pose"],
                                                 recs[i - 1]["pose"])
                                              if i else 0.0),
                    "iters_ref": a["iters"], "iters_run": b["iters"],
                    "gathers_ref": a["gathers"], "gathers_run": b["gathers"],
                    "same_input_ref": [a["other"]["iters"],
                                       _t(a["pose"], a["other"]["pose"])],
                    "same_input_run": [b["other"]["iters"],
                                       _t(b["pose"], b["other"]["pose"])]}
    return None


def probe(cfg: dict, streams, sync_every: int, i: int) -> dict:
    """At registration ``i``, where the stepwise run parts from the K3 run:
    the two runs' inputs (is the scan the same, the map, how far apart the
    starts), K3 on each run's map from each run's start, and the plane set
    and first step each start gives on the K3 run's map: which input moves
    the result."""
    from simpleslam_tpu_torch.ops import geometry as geo
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.ops import loam_kernels as lk

    src_a, map_a, start_a = run_variant(cfg, streams, sync_every, "k3",
                                        False, capture=i)["captured"]
    src_b, map_b, start_b = run_variant(cfg, streams, sync_every, "stepwise",
                                        False, capture=i)["captured"]
    same_scan = all(torch.equal(x, y) for x, y in zip(src_a, src_b))
    diff = [int((x != y).sum()) for x, y in zip(map_a, map_b)
            if isinstance(x, torch.Tensor) and x.shape == y.shape]

    def k3(src, vm, start):
        return loam.gn_loop(src, vm, start).pose.cpu().numpy().astype(
            np.float64)

    aa = k3(src_a, map_a, start_a)
    cross = {"k3_map_stepwise_start": _t(k3(src_a, map_a, start_b), aa),
             "stepwise_map_k3_start": _t(k3(src_b, map_b, start_a), aa),
             "stepwise_map_stepwise_start": _t(k3(src_b, map_b, start_b),
                                               aa)}

    def first(vm, start):
        sqrt_r = loam.source_sqrt_range(src_a)
        p_map = geo.transform_points(start, src_a.xyz)
        if isinstance(vm, loam.MergedDenseVoxelMap):
            jtj, jte, nv, planes = lk.fit_and_linearize_merged(
                vm, p_map, sqrt_r, src_a.mask)
        else:
            cand, ok = loam.gather_candidates_at(vm, p_map, src_a.mask)
            jtj, jte, nv, planes = lk.fit_and_linearize_candidates(
                cand, ok, p_map, sqrt_r, src_a.mask)
        dx = torch.linalg.solve(jtj.double(), -jte.double())
        return planes.ok.cpu().numpy(), int(nv), dx.cpu().numpy()

    ok_a, nv_a, dx_a = first(map_a, start_a)
    ok_b, nv_b, dx_b = first(map_a, start_b)
    return {"registration": i, "same_scan": same_scan,
            "map_elements_differing": diff,
            "start_gap_m": _t(start_a.cpu().numpy(), start_b.cpu().numpy()),
            "k3_from": cross,
            "planes_ok_flipped": int((ok_a != ok_b).sum()),
            "planes_ok": int(ok_a.sum()), "valid_rows": [nv_a, nv_b],
            "first_step_t_m": [float(np.linalg.norm(dx_a[:3])),
                               float(np.linalg.norm(dx_b[:3]))],
            "first_step_gap_t_m": float(np.linalg.norm(dx_a[:3] - dx_b[:3])),
            "first_step_gap_r_rad": float(np.linalg.norm(dx_a[3:]
                                                         - dx_b[3:]))}


def solve_f32(JtJ, JtE, n_valid, enough, degen_per_row):
    """``loam._solve`` with the guard's eigenbasis in float32."""
    eye = torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
    JtJ_safe = JtJ + eye * (~enough).to(JtJ.dtype)
    w, V = torch.linalg.eigh(JtJ_safe)
    y = V.T @ (-JtE)
    floor = degen_per_row * n_valid.to(JtJ.dtype) * enough.to(JtJ.dtype)
    return V @ torch.where(w > floor, y / torch.clamp(w, min=1e-12),
                           torch.zeros_like(y))


def guard_trace(n_worst: int) -> int:
    """``--guard``: see the module's docstring."""
    from simpleslam_tpu_torch import native
    from simpleslam_tpu_torch.ops import loam
    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.pipeline import streamed

    card = cs.environment()
    cs.build()
    streams = sim.simulate_sequence(sim.make_world(seed=0), n_scans=150,
                                    seed=0, n_az=1800, n_el=16)
    _, system, result = cs.streamed_run(
        "streamed full (bench full config)", cs.BENCH_FULL, streams, card,
        prewarm=True, probe_scans=0)
    dev = torch.device("cuda")
    n = len(streams.scan_stamps)
    idx = list(range(max(1, n - 1 - cs.N_FUSED_SCANS), n - 1))
    rows, _ = cs.prep_scans(system, streams, idx,
                            int(result.extras["scan_capacity"]))
    rows = torch.from_numpy(rows).to(dev)
    vm = system.map_manager.get_target()
    f64_solve = loam._solve

    def gap(a, b) -> float:
        pa, pb = (x.pose.cpu().numpy().astype(np.float64) for x in (a, b))
        return float(np.linalg.norm(pa[:3, 3] - pb[:3, 3]))

    cases, worst = [], {"f64": 0.0, "f32": 0.0}
    for k, j in enumerate(idx):
        src = streamed.upload_cloud(rows[k])
        pose = torch.tensor(result.poses[j].astype(np.float32), device=dev)
        for tag, start in (("recorded pose", pose),
                           ("0.25 m offset", cs.offset_pose(pose))):
            k3 = loam.gn_loop(src, vm, start, degen_per_row=cs.DEGEN)
            g64 = gap(k3, loam.gn_loop_stepwise(src, vm, start,
                                                degen_per_row=cs.DEGEN))
            loam._solve = lambda *a: solve_f32(*a)
            try:
                g32 = gap(k3, loam.gn_loop_stepwise(src, vm, start,
                                                    degen_per_row=cs.DEGEN))
            finally:
                loam._solve = f64_solve
            worst = {"f64": max(worst["f64"], g64),
                     "f32": max(worst["f32"], g32)}
            cases.append((g32, g64, j, tag, src, start))
    print(f"guard on, {len(cases)} registrations of scans {idx[0]}-{idx[-1]}:"
          f" the stepwise loop lies at most {worst['f64']:.3e} m from K3 "
          f"with its float64 guarded solve, {worst['f32']:.3e} m with an f32 "
          f"eigh ({card})")
    for g32, g64, j, tag, src, start in sorted(
            cases, key=lambda c: -c[0])[:n_worst]:
        systems = []

        def tracing(JtJ, JtE, n_valid, enough, degen):
            systems.append((JtJ.double().cpu().numpy(),
                            JtE.double().cpu().numpy(), int(n_valid),
                            bool(enough)))
            return f64_solve(JtJ, JtE, n_valid, enough, degen)

        loam._solve = tracing
        try:
            loam.gn_loop_stepwise(src, vm, start, degen_per_row=cs.DEGEN)
        finally:
            loam._solve = f64_solve
        print(f"scan {j} from the {tag}: K3 to the stepwise loop "
              f"{g64:.3e} m (f32 eigh: {g32:.3e} m)")
        for it, (A, e, nv, enough) in enumerate(systems):
            floor = cs.DEGEN * nv * enough
            w, V = np.linalg.eigh(A)
            y = V.T @ (-e)
            dx64 = V @ np.where(w > floor, y / np.maximum(w, 1e-12), 0.0)
            t = [torch.tensor(x, device=dev) for x in (
                A.astype(np.float32), e.astype(np.float32))]
            dx32 = solve_f32(t[0], t[1], torch.tensor(nv, device=dev),
                             torch.tensor(enough, device=dev),
                             cs.DEGEN).cpu().numpy()
            dxr = dx64.astype(np.float32)
            jac = native.gn_step(A.astype(np.float32), e.astype(np.float32),
                                 nv, cs.DEGEN, np.eye(4, dtype=np.float32),
                                 np.eye(4, dtype=np.float32), 1.0)[0]
            print(f"  iteration {it}: {nv} rows, floor {floor:.2f}, "
                  f"eigenvalues {np.array2string(w, precision=1)}; |dx| "
                  f"{np.abs(dx64).max():.3e}, off the float64 step: f32 eigh "
                  f"{np.abs(dx32 - dx64).max():.3e}, float64 rounded "
                  f"{np.abs(dxr - dx64).max():.3e}, K3's Jacobi "
                  f"{np.abs(jac - dx64).max():.3e} ({card})")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="full,courtyard")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scans", type=int, default=150,
                    help="scans of the full config's sequence")
    ap.add_argument("--guard", type=int, default=0, metavar="N",
                    help="trace the degeneracy guard's solve instead, for "
                         "the N registrations where an f32 eigh parts "
                         "furthest")
    args = ap.parse_args()
    if args.guard:
        return guard_trace(args.guard)
    global DEVICE
    DEVICE = args.device
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from simpleslam_tpu_torch.pipeline import simulate as sim

    gpu = card() if DEVICE == "cuda" else "cpu"
    print(f"card: {gpu}", flush=True)
    if DEVICE == "cuda":
        cs.build()
    out = {"card": gpu}
    for name in args.configs.split(","):
        if name == "full":
            cfg, every = cs.BENCH_FULL, cs.BENCH_SYNC_EVERY
            streams = sim.simulate_sequence(sim.make_world(seed=0),
                                            n_scans=args.scans, seed=0,
                                            n_az=1800,
                                            n_el=16)
            variants = [("k3", False), ("stepwise", False)]
        elif name == "courtyard":
            cfg, every = cs.LC_CFG, 16
            streams = cs.courtyard_streams()
            variants = [("k3", False), ("stepwise", False), ("k3", True),
                        ("stepwise", True)]
        else:
            raise SystemExit(f"unknown config {name!r}")
        runs = {}
        for loop, pcg in variants:
            tag = loop + ("_pcg" if pcg else "")
            runs[tag] = run_variant(cfg, streams, every, loop, pcg)
        runs["mesh"] = run_mesh(cfg, streams, every, args.ranks)
        ref = runs["k3"]
        rep = {}
        for tag, run in runs.items():
            rep[tag] = gap_report(ref, run, streams.gt_poses)
            if "records" in run:
                fl = flips(run["records"])
                rep[tag]["same_input_flips"] = fl
                rep[tag]["same_input_max_gap_m"] = max(
                    _t(r["pose"], r["other"]["pose"]) for r in run["records"])
                rep[tag]["registrations"] = len(run["records"])
                if tag != "k3":
                    rep[tag]["parting"] = parting(ref["records"],
                                                  run["records"])
            print(f"{name} {tag}: {json.dumps(rep[tag])}", flush=True)
        if rep["stepwise"]["parting"] is not None:
            rep["probe"] = probe(cfg, streams, every,
                                 rep["stepwise"]["parting"]["registration"])
            print(f"{name} probe: {json.dumps(rep['probe'])}", flush=True)
        out[name] = rep
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
