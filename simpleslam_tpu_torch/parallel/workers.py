"""Rank functions for ``multihost.run_hosts``.

Port of ``simpleslam_tpu/parallel/workers.py``, plus the rank sides of the
sharded paths' checks. Each runs on every rank after the process group is
up, with the signature ``fn(payload: dict, num_processes: int,
process_id: int) -> JSON-serializable``. Results cross process boundaries
as JSON, so they are summaries and small arrays as lists; large inputs
come in through a file named in the payload (``torch.save`` of CPU tensors,
or a pickle of sensor streams), written once by the caller.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Dict

import numpy as np
import torch

from . import mesh as pmesh
from . import multihost as mh


def _counts() -> Dict[str, int]:
    """The LOAM kernels' launch and plain-call counters."""
    from ..ops import loam_kernels as lk

    names = ("K1_LAUNCHES", "K2_LAUNCHES", "K3_LAUNCHES", "K4_LAUNCHES",
             "K1_PLAIN_CUDA_CALLS", "K2_PLAIN_CUDA_CALLS",
             "K3_PLAIN_CUDA_CALLS", "K4_PLAIN_CUDA_CALLS",
             "SHARDED_STEPWISE_CALLS")
    return {n: int(getattr(lk, n)) for n in names}


def _reset() -> None:
    from ..ops import loam_kernels as lk

    lk.reset_counts()
    pmesh.reset_stats()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _load(path: str, dev: torch.device):
    return torch.load(path, map_location=dev, weights_only=False)


def devices_worker(payload: Dict[str, Any], num_processes: int,
                   process_id: int) -> Dict[str, Any]:
    """Report the rank layout, the backend, and one cross-rank sum (of the
    process ids)."""
    mesh = mh.global_mesh(("x",))
    ax = mesh.axis("x")
    total = ax.gather_sum(torch.tensor([float(process_id)], device=mesh.device))
    return {"n_global": mesh.world_size, "n_local": 1,
            "process_id": process_id, "backend": mesh.backend,
            "device": str(mesh.device), "psum": float(total[0])}


def posegraph_worker(payload: Dict[str, Any], num_processes: int,
                     process_id: int) -> Dict[str, Any]:
    """Edge-sharded solve of the ring graph (built in full on every rank,
    each uploading its own edge block): ``reps`` timed solves after one
    warm-up (unless ``warmup`` is false), the final cost and the first
    ``return_poses`` poses.
    ``payload["modes"]``, a list of {"shard_cg", "shard_lin"} flags, runs
    each mode and returns ``{"modes": [result, ...]}``."""
    from .dist_posegraph import _ring_graph, shard_graph, sharded_solve

    mesh = mh.global_mesh(("kf",))
    n = mesh.world_size
    k = int(payload.get("k", 256))
    k_cap = int(payload.get("k_cap", max(256, k)))
    e_cap = int(payload.get("e_cap", 2 * k_cap))
    e_cap = ((e_cap + n - 1) // n) * n
    reps = int(payload.get("reps", 3))
    max_iters = int(payload.get("max_iters", 6))
    cg_iters = int(payload.get("cg_iters", 32))
    n_ret = int(payload.get("return_poses", 0))
    g = _ring_graph(k=k, k_cap=k_cap, e_cap=e_cap,
                    drift=float(payload.get("drift", 0.05)),
                    seed=int(payload.get("seed", 0)),
                    n_lc=int(payload.get("n_lc", max(1, k // 64))))

    def run(fn, graph):
        if payload.get("warmup", True):
            fn(graph)
            _sync(mesh.device)
        pmesh.reset_stats()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn(graph)
            _sync(mesh.device)
            times.append(time.perf_counter() - t0)
        return {
            "times_s": times,
            "cost0": float(res.cost0),
            "cost": float(res.cost),
            "n_devices": n,
            "num_processes": num_processes,
            "collectives_per_solve": pmesh.STATS["collectives"]
            / max(reps, 1),
            "collective_s_per_solve": pmesh.STATS["collective_s"]
            / max(reps, 1),
            "poses": (res.poses[:n_ret].cpu().numpy().tolist() if n_ret
                      else None),
        }

    local = shard_graph(mesh, g, "kf")
    modes = payload.get("modes")
    out = [run(sharded_solve(mesh, axis="kf", max_iters=max_iters,
                             cg_iters=cg_iters,
                             shard_cg=bool(m.get("shard_cg", False)),
                             shard_lin=bool(m.get("shard_lin", False))),
               local)
           for m in (modes if modes is not None else [payload])]
    return {"modes": out} if modes is not None else out[0]


def registration_worker(payload: Dict[str, Any], num_processes: int,
                        process_id: int) -> Dict[str, Any]:
    """Point-parallel registration on a plane world (ground and two walls)
    against a dense map, the reference package's fixture: ``reps`` timed
    runs after one warm-up."""
    from ..ops import pointcloud as pcops
    from ..ops import voxel as vox
    from .dist_registration import shard_cloud, sharded_scan2map

    mesh = mh.global_mesh(("dp",))
    n = mesh.world_size
    dev = mesh.device
    n_src = int(payload.get("n_src", 65536))
    n_map = int(payload.get("n_map", 16384))
    reps = int(payload.get("reps", 3))
    rng = np.random.default_rng(int(payload.get("seed", 0)))
    g = rng.uniform(-8, 8, size=(n_map, 2)).astype(np.float32)
    ground = np.stack([g[:, 0], g[:, 1], np.zeros(n_map, np.float32)], 1)
    w1 = np.stack([g[:, 0], np.full(n_map, 8.0, np.float32),
                   g[:, 1] * 0.3 + 2], 1)
    w2 = np.stack([np.full(n_map, -8.0, np.float32), g[:, 0],
                   g[:, 1] * 0.3 + 2], 1)
    map_xyz = (np.concatenate([ground, w1, w2])
               + rng.normal(size=(3 * n_map, 3)).astype(np.float32) * 0.01)
    n_src = ((n_src + n - 1) // n) * n
    src_np = map_xyz[rng.choice(len(map_xyz), size=n_src, replace=True)]
    map_pc = pcops.from_numpy(map_xyz, 4 * n_map, dev)
    vm = vox.build_dense_voxel_map(map_pc, 2.0,
                                   torch.zeros(3, dtype=torch.float32,
                                               device=dev),
                                   dims=(16, 16, 8), slab_size=16)
    src = shard_cloud(mesh, pcops.from_numpy(src_np, n_src, dev))
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.05, -0.05, 0.02]
    init_pose = torch.tensor(init, device=dev)
    fn = sharded_scan2map(mesh)
    res = fn(src, vm, init_pose)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn(src, vm, init_pose)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    pose = res.pose.cpu().numpy()
    return {"times_s": times, "n_devices": n,
            "converged": bool(res.converged),
            "pose_err": float(np.abs(pose - np.eye(4)).max())}


def _loam_row(res) -> Dict[str, Any]:
    return {"pose": res.pose.cpu().numpy().tolist(),
            "converged": bool(res.converged), "iters": int(res.iters),
            "n_valid": int(res.n_valid), "gathers": int(res.n_gathers)}


def scan2map_worker(payload: Dict[str, Any], num_processes: int,
                    process_id: int) -> Dict[str, Any]:
    """``sharded_scan2map`` on the inputs file ``payload["inputs"]``
    ({"src": PointCloud, "init": (4, 4), "targets": {name: LOAM target}},
    the cloud's point count divisible by the ranks), ``reps`` times on
    every target: per target, each run's result, the kernel counters and
    the run's collectives."""
    from .dist_registration import shard_cloud, sharded_scan2map

    mesh = mh.global_mesh(("dp",))
    dev = mesh.device
    inp = _load(payload["inputs"], dev)
    src = shard_cloud(mesh, inp["src"])
    fn = sharded_scan2map(mesh)
    out = {}
    for name, target in inp["targets"].items():
        _reset()
        runs = []
        t0 = time.perf_counter()
        for _ in range(int(payload.get("reps", 2))):
            runs.append(_loam_row(fn(src, target, inp["init"])))
        _sync(dev)
        out[name] = {"runs": runs, "seconds": time.perf_counter() - t0,
                     "counts": _counts(), "stats": dict(pmesh.STATS)}
    return {"targets": out, "backend": mesh.backend,
            "block": int(src.xyz.shape[0])}


def batch_worker(payload: Dict[str, Any], num_processes: int,
                 process_id: int) -> Dict[str, Any]:
    """``make_sharded_batch`` on the inputs file ``payload["inputs"]``
    ({"rows": (K, C, 3) int16, "pose_prev", "pose_prev2", "odom2map",
    "targets": {kind: target}}) in lo mode, ``reps`` times per kind: the
    packed rows and the carry of each run."""
    from ..pipeline.streamed import make_sharded_batch

    mesh = mh.global_mesh(("dp",))
    dev = mesh.device
    inp = _load(payload["inputs"], dev)
    rows = inp["rows"][:, mesh.axis("dp").shard(inp["rows"].shape[1])]
    rows = rows.contiguous()
    out = {}
    for kind, target in inp["targets"].items():
        fn = make_sharded_batch(mesh, kind, "lo",
                                bool(payload.get("clamp", True)),
                                float(payload.get("degen", 0.0)))
        _reset()
        runs = []
        t0 = time.perf_counter()
        for _ in range(int(payload.get("reps", 1))):
            (pose, prev, o2m), packed = fn(
                rows, None, target, inp["pose_prev"], inp["pose_prev2"],
                inp["odom2map"])
            runs.append({"packed": packed.cpu().numpy().tolist(),
                         "carry": torch.stack([pose, prev, o2m]).cpu()
                         .numpy().tolist()})
        _sync(dev)
        out[kind] = {"runs": runs, "seconds": time.perf_counter() - t0,
                     "counts": _counts(), "stats": dict(pmesh.STATS)}
    return out


class _UnshardedBeside:
    """Inside it, every LOAM registration of the streamed batch is also run
    unsharded beside the sharded one: the ranks gather the scan's blocks
    (in rank order: the whole scan) and ``loam.gn_loop`` registers it from
    the same start against the same map. It changes nothing the pipeline
    sees; the kernel counters and collective stats are restored after each
    extra call. ``rows`` holds, per registration, the start (16), the
    sharded result (16) and its iterations, gathers, valid rows and
    converged flag, then the unsharded result (16) and its four counts."""

    def __init__(self, n: int):
        self.n = n
        self.rows = []

    def __enter__(self):
        from ..ops import loam
        from ..ops import loam_kernels as lk
        from ..ops.pointcloud import PointCloud
        from ..pipeline import streamed

        self._streamed = streamed
        self._orig = orig = streamed.register_kind

        def beside(ds, target, init, kind, degen=0.0, *hooks):
            out = orig(ds, target, init, kind, degen, *hooks)
            if kind != "loam":
                return out
            counts, stats = _counts(), dict(pmesh.STATS)
            ax = pmesh.make_mesh(self.n, ("dp",), device=init.device).axis(
                "dp")
            parts = [ax.all_gather(t.to(torch.float32)).flatten(0, 1)
                     for t in ds]
            whole = PointCloud(parts[0], parts[1], parts[2] > 0.5)
            ref = loam.gn_loop(whole, target, init, degen_per_row=degen)
            for name, v in counts.items():
                setattr(lk, name, v)
            pmesh.STATS.update(stats)
            f = torch.float32
            self.rows.append(torch.cat([
                init.reshape(16).to(f), out[0].reshape(16),
                torch.stack([out[3], out[4], out[5], out[1]]).to(f),
                ref.pose.reshape(16),
                torch.stack([ref.iters, ref.n_gathers, ref.n_valid,
                             ref.converged]).to(f)]))
            return out

        streamed.register_kind = beside
        return self

    def __exit__(self, *exc):
        self._streamed.register_kind = self._orig
        return False


def pipeline_worker(payload: Dict[str, Any], num_processes: int,
                    process_id: int) -> Dict[str, Any]:
    """The streamed pipeline on the mesh: ``payload["config"]`` (with
    ``tpu.mesh_devices`` = the ranks) on the sensor streams pickled at
    ``payload["streams"]``, in batches of ``payload["sync_every"]``. Every
    rank returns its poses, keyframes and backend counts. With
    ``payload["unsharded_beside"]`` every LOAM registration is also run
    unsharded on the same inputs, and ``registrations`` lists both
    (``_UnshardedBeside``)."""
    from contextlib import nullcontext

    from ..pipeline import simulate as sim
    from ..pipeline.app import SlamSystem
    from ..pipeline.streamed import run_streamed
    from ..utils.config import Params
    from ..utils.logging import Logger

    with open(payload["streams"], "rb") as f:
        streams = pickle.load(f)
    Params.reset()
    Logger.reset()
    system = SlamSystem(payload["config"])
    if payload.get("prewarm", True):
        system.prewarm()
    _reset()
    beside = (_UnshardedBeside(num_processes)
              if payload.get("unsharded_beside") else None)
    with beside or nullcontext():
        res = run_streamed(system, streams,
                           sync_every=int(payload.get("sync_every", 16)))
    counts = _counts()
    be = system.backend
    lc = system.loop_closure
    system.shutdown()
    ex = res.extras
    out = {
        "poses": res.poses.tolist(),
        "kf_poses": np.asarray(ex["kf_poses"]).tolist(),
        "keyframe_count": int(res.keyframe_count),
        "converged_frac": float(res.converged_frac),
        "wall_s": float(res.wall_time),
        "scans_per_s": len(res.poses) / max(res.wall_time, 1e-9),
        "ate_m": (float(sim.ate_rmse(streams.gt_poses, res.poses))
                  if streams.gt_poses is not None else None),
        "gn_iters_mean": ex["gn_iters_mean"],
        "n_deltas": ex["n_deltas"],
        "scan_capacity": ex["scan_capacity"],
        "mesh": ex["mesh"],
        "counts": counts,
        "backend": None if be is None else {
            "n_solves": be.n_solves,
            "n_skipped_noop_solves": be.n_skipped_noop_solves,
            "n_lc_edges": be.n_lc_edges},
        "lc_accepted": None if lc is None else int(be.n_lc_edges),
        "registrations": (torch.stack(beside.rows).cpu().tolist()
                          if beside is not None and beside.rows else None),
    }
    Params.reset()
    Logger.reset()
    return out


def dryrun_worker(payload: Dict[str, Any], num_processes: int,
                  process_id: int) -> Dict[str, Any]:
    """The rank side of ``dryrun.dryrun_multichip``: point-parallel
    registration on both dense targets of the plane world, the sharded
    pose-graph solve in its three modes, and the NDT and VGICP sharded
    batches, each asserted finite."""
    from ..ops import ndt as ndt_ops
    from ..ops import pointcloud as pcops
    from ..ops import vgicp as vgicp_ops
    from ..ops import voxel as vox
    from ..pipeline.streamed import UPLOAD_PAD, UPLOAD_SCALE, make_sharded_batch
    from .dist_posegraph import dryrun as pg_dryrun
    from .dist_registration import shard_cloud, sharded_scan2map

    mesh = mh.global_mesh(("dp",))
    dev = mesh.device
    n = mesh.world_size
    n_src = max(256, n * 64)
    rng = np.random.default_rng(0)
    n_map = 2048
    g = rng.uniform(-8, 8, size=(n_map, 2)).astype(np.float32)
    ground = np.stack([g[:, 0], g[:, 1], np.zeros(n_map, np.float32)], 1)
    w1 = np.stack([g[:, 0], np.full(n_map, 8.0, np.float32),
                   g[:, 1] * 0.3 + 2], 1)
    w2 = np.stack([np.full(n_map, -8.0, np.float32), g[:, 0],
                   g[:, 1] * 0.3 + 2], 1)
    map_xyz = np.concatenate([ground, w1, w2]) + rng.normal(
        size=(3 * n_map, 3)).astype(np.float32) * 0.01
    map_pc = pcops.from_numpy(map_xyz, 4 * n_map, dev)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    src_np = map_xyz[rng.choice(len(map_xyz), size=n_src, replace=False)]
    src = pcops.from_numpy(src_np, n_src, dev)
    init = torch.eye(4, dtype=torch.float32, device=dev)
    init[:3, 3] = torch.tensor([0.05, -0.05, 0.02], device=dev)
    out = {}
    for name, vm in (
            ("dense", vox.build_dense_voxel_map(map_pc, 2.0, zero,
                                                dims=(16, 16, 8),
                                                slab_size=16)),
            ("table", vox.build_voxel_map(map_pc, 1.0, zero, num_voxels=4096,
                                          slab_size=4))):
        res = sharded_scan2map(mesh)(shard_cloud(mesh, src), vm, init)
        assert torch.isfinite(res.pose).all(), name
        out[name] = res.pose.cpu().numpy().tolist()
    pg_dryrun(mh.global_mesh(("kf",)))
    q = np.clip(np.rint(src_np / UPLOAD_SCALE), -32766, 32766).astype(np.int16)
    rows = torch.from_numpy(np.tile(q[None], (2, 1, 1)))
    rows = rows[:, mesh.axis("dp").shard(n_src)].contiguous().to(dev)
    assert UPLOAD_PAD not in q
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    for kind, tgt in (
            ("ndt", ndt_ops.build_target(map_pc, 1.0, zero, (24, 24, 12))),
            ("vgicp", vgicp_ops.build_target(map_pc, 1.0, zero,
                                             (24, 24, 12)))):
        (pose, _, _), packed = make_sharded_batch(mesh, kind, "lo", True,
                                                  0.0)(rows, None, tgt, eye,
                                                       eye, eye)
        assert torch.isfinite(pose).all() and torch.isfinite(packed).all(), \
            kind
        out[kind] = packed[:, :16].cpu().numpy().tolist()
    return out


def tasks_worker(payload: Dict[str, Any], num_processes: int,
                 process_id: int) -> Dict[str, Any]:
    """Several rank functions of this module in one set of ranks:
    ``payload["tasks"]`` is a list of {"fn": name, "payload": {...}}; the
    result lists their results in order (one start-up for them all)."""
    out = []
    for task in payload["tasks"]:
        fn = globals()[task["fn"]]
        t0 = time.perf_counter()
        res = fn(task.get("payload", {}), num_processes, process_id)
        out.append({"result": res, "seconds": time.perf_counter() - t0})
    return {"tasks": out}
