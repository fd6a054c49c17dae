"""Run one cell of the benchmark once.

    python -m slambench.run --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1> [--control 1]

Set-up makes the cell's drive from the seed (``drive.py``, ray-cast in
child processes while the parent imports the program and loads its kernel
library; nvcc builds it once per checkout, into the program's build
directory inside the checkout) and maps the drive's first
``WARMUP_BATCHES`` batches as a warm-up, after ``SlamSystem.prewarm`` where
the backend is on. The window then maps the
drive again and again, each time with a fresh ``SlamSystem`` through
``simpleslam_tpu_torch.pipeline.streamed.run_streamed``, until ``--seconds``
have passed; the drive in progress finishes. With ``--trace 1`` the first
and the third drive each run under one ``torch.profiler`` session
(``trace.py``) and the per-layer metrics are printed instead of the
end-to-end ones.

After the window the plain reference judges the outputs (``judge.py``)
against the limits in ``slambench/limits/<cell>.json``; ``--control 1``
also prints the control's numbers (the reference in bfloat16 in the
program's place). The last line of standard output is one JSON object.

Everything of one configuration, traffic mix or metric is a file of its
own, found by the name ``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py``, ``limits/<cell>.json``.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import drive as drive_mod  # noqa: E402
from . import judge as judge_mod  # noqa: E402
from . import reference as ref  # noqa: E402
from . import trace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "simpleslam_tpu")
# drives of a traced window that run under the profiler: two sessions, so
# one that lost events (F9) leaves the other; the rest give the host spans
PROFILED_DRIVES = (0, 2)
# batches of the warm-up drive: the executor's shapes are fixed by the
# batch and the capacities, and six batches of a 1.5 m/s drive pass the
# submap's 24-keyframe window, so its eviction runs before the window too
WARMUP_BATCHES = 6


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str):
        bench = _load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}")
        self.name = name
        self.entry = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = _load_json(os.path.join(ROOT, conf["file"]))
        self.traffic = _load_json(os.path.join(
            HERE, "traffic", self.entry["traffic"] + ".json"))
        self.limits = _load_json(os.path.join(HERE, "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in names)]


def load_reader(metric: dict):
    """The reader of one metric, ``metrics/<name>.py``, checked against its
    entry in ``BENCHMARK.json``."""
    path = os.path.join(HERE, "metrics", metric["name"] + ".py")
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + metric["name"].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key, attr in (("unit", "UNIT"), ("source", "SOURCE"),
                      ("layer", "LAYER"), ("moves", "MOVES")):
        if key in metric and getattr(mod, attr, metric[key]) != metric[key]:
            raise SystemExit(f"metrics/{metric['name']}.py: {attr} "
                             f"{getattr(mod, attr)!r} against "
                             f"BENCHMARK.json's {metric[key]!r}")
    return mod


class DriveRecord:
    """One drive of the window: its timers and counts, and its profiler
    session if it ran under one."""

    def __init__(self, result, n_scans: int, ds_counts: np.ndarray,
                 session: Optional[trace.Session] = None):
        self.timers = result.timers
        self.wall_s = float(result.wall_time)
        self.n_scans = n_scans
        self.scan_capacity = int(result.extras["scan_capacity"])
        self.gn_iters = float(result.extras["gn_iters_mean"])
        self.gn_gathers = float(result.extras["gn_gathers_mean"])
        self.ds_counts = ds_counts
        self.session = session

    def total(self, stage: str) -> float:
        return float(self.timers.total.get(stage, 0.0))

    def count(self, stage: str) -> int:
        return int(self.timers.count.get(stage, 0))

    def series(self, stage: str) -> list:
        return list(self.timers.series.get(stage, []))

    def valid_rows(self):
        """Valid query rows of each registration (every scan but the one
        that seeds the map), at most the scan capacity."""
        return np.minimum(self.ds_counts[1:self.n_scans], self.scan_capacity)


class Context:
    """What the metric readers read."""

    def __init__(self, cell: Cell, drives: List[DriveRecord],
                 window_s: float, setup_s: float, slab: int):
        self.cell = cell
        self.drives = drives
        self.window_s = window_s
        self.setup_s = setup_s
        self.slab = slab
        self.sessions = [d.session for d in drives
                         if d.session is not None and d.session.accepted]
        self.dropped = sum(1 for d in drives
                           if d.session is not None and not d.session.accepted)

    def span_drives(self) -> List[DriveRecord]:
        """The drives without the profiler (all, when every one had it)."""
        plain = [d for d in self.drives if d.session is None]
        return plain or self.drives

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def _streams(sim_mod, drv, n: Optional[int] = None):
    """The program's input bundle for the first ``n`` scans of the drive."""
    n = len(drv.scan_stamps) if n is None else n
    return sim_mod.SensorStreams(
        drv.scan_stamps[:n], drv.scans[:n], drv.gt_poses[:n],
        drv.wheel_stamps, drv.wheel_poses, drv.imu_stamps, drv.imu_quats)


def _outputs(system, result, drv) -> judge_mod.DriveOut:
    """The drive's outputs as host arrays (the system is dropped after)."""
    with system.map_manager.kf_obj.lock:
        kfs = list(system.map_manager.kf_obj.keyframes)
    kf_stamps = np.array([kf.stamp for kf in kfs])
    kf_scan = np.searchsorted(drv.scan_stamps, kf_stamps)
    graph = None
    be = system.backend
    if be is not None and be.prior_pose is not None:
        graph = {"prior_pose": be.prior_pose.copy(),
                 "prior_info": 1.0 / ref.PRIOR_VAR,
                 "ei": np.array(be.edge_i, np.int64),
                 "ej": np.array(be.edge_j, np.int64),
                 "eT": np.array(be.edge_T, np.float64).reshape(-1, 4, 4),
                 "einfo": 1.0 / np.array(be.edge_var,
                                         np.float64).reshape(-1, 6)}
    extras = {"keyframes": len(kfs),
              "converged_frac": float(result.converged_frac),
              "closures": int(be.n_lc_edges) if be is not None else 0}
    return judge_mod.DriveOut(
        poses=np.asarray(result.poses, np.float64), kf_scan=kf_scan,
        kf_poses=(np.stack([kf.pose for kf in kfs]) if kfs
                  else np.zeros((0, 4, 4))),
        kf_clouds=[kf.xyz for kf in kfs],
        scan_capacity=int(result.extras["scan_capacity"]), graph=graph,
        extras=extras)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             control: bool = False) -> dict:
    """Set-up, window, judgement: the result line's object. On a host
    without CUDA (the CPU tests) the program runs on the CPU."""
    cell = Cell(workload)
    cfg = cell.config
    grid = float(cfg["map"]["grid"])
    job = drive_mod.DriveJob(cell.traffic, cfg["sensor"], grid, seed)
    marks = {}
    try:
        import torch

        from simpleslam_tpu_torch.ops import loam_kernels as lk
        from simpleslam_tpu_torch.pipeline import app
        from simpleslam_tpu_torch.pipeline import simulate as psim
        from simpleslam_tpu_torch.pipeline.streamed import run_streamed
        from simpleslam_tpu_torch.utils.logging import Logger

        # a deployment logs at its own level: INFO writes a line per keyframe
        Logger.get_instance().set_level(logging.WARNING)
        cuda = torch.cuda.is_available()
        device = "cuda" if cuda else "cpu"
        if cuda:
            from simpleslam_tpu_torch.ops import _build

            _build.library()
        marks["program"] = time.monotonic() - T_START
        drv = job.result()
        marks["drive"] = time.monotonic() - T_START
    finally:
        job.close()
    n_scans = len(drv.scan_stamps)
    program_cfg = dict(cfg["program"], torch={"device": device})
    backend_on = bool(program_cfg.get("backend", {}).get("enable", True))
    sync_every = int(cfg["sync_every"])
    streams = _streams(psim, drv)

    def one_drive(s, prewarm=False):
        system = app.SlamSystem(program_cfg)
        if prewarm:
            system.prewarm()
        result = run_streamed(system, s, sync_every=sync_every)
        if cuda:
            torch.cuda.synchronize()
        return system, result

    warm_n = min(WARMUP_BATCHES * sync_every, n_scans)
    system, result = one_drive(_streams(psim, drv, warm_n), backend_on)
    del system, result
    if traced and cuda:  # the profiler's own first start, outside the window
        trace.profile(lambda: torch.zeros(1, device="cuda") + 1,
                      lambda: lk.K3_LAUNCHES)
    gc.collect()
    setup_s = time.monotonic() - T_START
    Context.log(f"set-up: program and library at {marks['program']:.3f} s, "
                f"drive ray-cast at {marks['drive']:.3f} s, warm-up drive "
                f"done at {setup_s:.3f} s")

    records: List[DriveRecord] = []
    outs: List[judge_mod.DriveOut] = []
    k3_0 = lk.K3_LAUNCHES
    t0 = time.monotonic()
    while True:
        session = None
        if traced and cuda and len(records) in PROFILED_DRIVES:
            (system, result), session = trace.profile(
                lambda: one_drive(streams), lambda: lk.K3_LAUNCHES)
        else:
            system, result = one_drive(streams)
        records.append(DriveRecord(result, n_scans, drv.ds_counts, session))
        outs.append(_outputs(system, result, drv))
        del system, result
        # a traced window also keeps one drive without the profiler, for
        # the host spans
        if time.monotonic() - t0 >= seconds and (
                not traced or len(records) >= 2):
            break
    window_s = time.monotonic() - t0
    k3_launches = lk.K3_LAUNCHES - k3_0
    mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ctx = Context(cell, records, window_s, setup_s,
                  int(app.Params.get_instance()["tpu"]["loam_slab_size"]))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = load_reader(m).read(ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    failed = sum(int(np.sum(~np.isfinite(o.poses).all(axis=(1, 2))))
                 for o in outs)
    attempted = n_scans * len(outs)
    if traced:
        ctx.log(f"profiled drives {sum(1 for d in records if d.session)}, "
                f"kept {len(ctx.sessions)}, dropped {ctx.dropped} (K3 "
                "launches in the trace differ from the program's count)")
    ctx.log(f"window: {len(records)} drives of {n_scans} scans in "
            f"{window_s:.3f} s, set-up {setup_s:.3f} s (warm-up drive "
            f"{warm_n} scans), K3 launches "
            f"{k3_launches}, keyframes {[o.extras['keyframes'] for o in outs]}"
            f", closures {[o.extras['closures'] for o in outs]}, drive s "
            f"{[round(d.wall_s, 3) for d in records]}, converged "
            f"{[round(o.extras['converged_frac'], 4) for o in outs]}")

    judge = judge_mod.Judge(drv, grid, int(cfg["map"]["submap_kf_window"]),
                            seed)
    t_ref = time.monotonic()
    numbers = judge.numbers(outs)
    ctx.log(f"reference: {time.monotonic() - t_ref:.3f} s")
    limits = cell.limits["limits"]
    correct = failed == 0 and all(
        math.isfinite(numbers[k]) and numbers[k] <= lim
        for k, lim in limits.items())
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": failed, "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(0) if cuda
                                else "cpu"),
                       "count": 1, "memory_peak_bytes": mem_peak}}
    if traced and ctx.sessions:
        line["device"]["busy_s"] = sum(s.busy_s for s in ctx.sessions)
        line["device"]["window_s"] = sum(s.window_s for s in ctx.sessions)
        ops, gaps = {}, {}
        for s in ctx.sessions:
            for k, v in s.ops.items():
                ops[k] = ops.get(k, 0.0) + v
            for k, v in s.gaps.items():
                gaps[k] = gaps.get(k, 0.0) + v
        line["breakdown"] = {"device_ops": trace.top(ops),
                             "idle_gaps": trace.top(gaps)}
    info = {k: v for k, v in numbers.items() if k not in limits}
    if info:
        ctx.log("not compared: " + ", ".join(f"{k} {v!r}"
                                             for k, v in info.items()))
    if control:
        t_c = time.monotonic()
        cnum = judge.control_numbers(outs)
        ctx.log(f"control (reference in bfloat16) in {time.monotonic() - t_c:.3f}"
                " s: " + ", ".join(f"{k} {v!r} (limit {limits.get(k)})"
                                   for k, v in cnum.items()))
        line["control"] = cnum
        line["control_correct"] = all(
            math.isfinite(cnum[k]) and cnum[k] <= lim
            for k, lim in limits.items())
    for k, lim in limits.items():
        ctx.log(f"compared {k} {numbers[k]!r} limit {lim!r}")
    line["compared"] = {k: {"value": numbers[k], "limit": lim}
                        for k, lim in limits.items()}
    return line


def _finite(obj):
    """The line with every non-finite number as null (JSON has none)."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def banned_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = Cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    bool(args.control))
    found = banned_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(_finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
