"""Launching ranks: ``torch.distributed`` initialisation and a launcher of
one process per rank.

Port of ``simpleslam_tpu/parallel/multihost.py``:

- ``init_distributed``: ``dist.init_process_group`` over ``tcp://`` with
  the backend of ``mesh.choose_backend``, the rank's device made current.
  It prints the backend it chose; a failed NCCL initialisation raises and
  is never retried with gloo. ``init_from_env`` does the same from the
  variables ``torchrun`` sets.
- ``global_mesh`` / ``make_global_array``: the mesh over every rank, and a
  rank's share of an array that every rank builds in full on the host (its
  own rows of a sharded axis, all of a replicated one).
- ``run_hosts``: start ``n`` ranks as fresh interpreters (never a fork of
  the caller, whose CUDA state a child must not inherit), each running
  ``module:function`` on a JSON payload, and return their JSON results. The
  kernels and host helpers are built once in the caller first. A rank that
  fails, or a run past its time limit, ends every rank (by exact PID) and
  raises with the failed ranks' error output.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, choose_backend, make_mesh, rank_device

# how long a rank waits in one collective before it raises (a rank that
# died leaves the others waiting)
COLLECTIVE_TIMEOUT_S = 300.0

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the output of the last ``run_hosts`` ranks: [(stdout, stderr)] per rank
LAST_LOGS: List[tuple] = []


def _device_type(device: Optional[str]) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return "cuda" if str(device).startswith("cuda") else "cpu"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device: Optional[str] = None,
                     local_rank: Optional[int] = None) -> str:
    """Join the process group of ``num_processes`` ranks as ``process_id``,
    with ``coordinator`` ("host:port") as its TCP store. ``device`` is
    "cpu" or "cuda" (default: CUDA when available). Returns the backend
    ("none" for a world of one, which needs no group)."""
    dev_type = _device_type(device)
    local = process_id if local_rank is None else local_rank
    if dev_type == "cuda":
        torch.cuda.set_device(rank_device("cuda", local, num_processes))
    if num_processes <= 1:
        return "none"
    n_cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    backend = choose_backend(num_processes, dev_type, n_cards)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    where = (f"cuda:{torch.cuda.current_device()} of {n_cards} card(s)"
             if dev_type == "cuda" else "cpu")
    print(f"rank {process_id}/{num_processes}: torch.distributed backend "
          f"{backend} on {where}", flush=True)
    return backend


def init_from_env(device: Optional[str] = None) -> str:
    """``init_distributed`` from torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT."""
    return init_distributed(
        f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), device,
        int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def global_mesh(axis_names: Sequence[str] = ("kf",)) -> Mesh:
    """The mesh over every rank of the process group."""
    return make_mesh(None, axis_names)


def make_global_array(full_np: np.ndarray, mesh: Mesh, spec=None,
                      device: Optional[torch.device] = None) -> torch.Tensor:
    """This rank's share of ``full_np``, which every rank builds in full:
    ``spec`` None replicates it; an axis name shards dim 0 over that axis;
    a tuple names, per dim, the axis that dim shards over (or None).
    Uploaded to ``device`` (default the mesh's)."""
    arr = np.asarray(full_np)
    specs = (spec,) if not isinstance(spec, tuple) else spec
    index = []
    for d, name in enumerate(specs):
        index.append(slice(None) if name is None
                     else mesh.axis(name).shard(arr.shape[d]))
    local = np.ascontiguousarray(arr[tuple(index)])
    return torch.from_numpy(local).to(device or mesh.device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def prebuild(device_type: str) -> None:
    """Build the host helpers (and, for CUDA ranks, the kernels) once in
    the caller, so ``n`` ranks do not run ``n`` compilers."""
    from .. import native

    native.backend()
    if device_type == "cuda":
        from ..ops._build import library

        library()


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()  # exact child PIDs only
    for p in procs:
        try:
            p.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            pass


def run_hosts(n_hosts: int, target: str, payload: Dict[str, Any],
              timeout: float = 600.0, device: Optional[str] = None,
              threads: int = 0) -> List[Any]:
    """Run ``target`` ("module:function") on ``n_hosts`` ranks and return
    each rank's JSON result (index = rank). The function receives
    ``(payload, num_processes, process_id)`` after the process group is
    up. ``device`` is "cpu" or "cuda" (default: CUDA when available);
    ``threads`` > 0 caps each rank's torch threads. Raises if a rank fails
    or the run outlasts ``timeout`` seconds; no rank is left running."""
    global LAST_LOGS
    dev_type = _device_type(device)
    prebuild(dev_type)
    coord = f"127.0.0.1:{_free_port()}"
    tmp = tempfile.mkdtemp(prefix="ssl_ranks_")
    procs: List[subprocess.Popen] = []
    logs = []
    try:
        payload_path = os.path.join(tmp, "payload.json")
        with open(payload_path, "w") as f:
            json.dump(payload, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_PKG_PARENT] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        for pid in range(n_hosts):
            cmd = [sys.executable, "-m", "simpleslam_tpu_torch.parallel.multihost",
                   "--coordinator", coord, "--num-processes", str(n_hosts),
                   "--process-id", str(pid), "--target", target,
                   "--payload", payload_path, "--device", dev_type,
                   "--threads", str(threads),
                   "--out", os.path.join(tmp, f"out_{pid}.json")]
            out = open(os.path.join(tmp, f"stdout_{pid}.txt"), "w")
            err = open(os.path.join(tmp, f"stderr_{pid}.txt"), "w")
            logs.append((out, err))
            procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                          stderr=err))
        t_end = time.monotonic() + timeout
        failed = []
        while True:
            rcs = [p.poll() for p in procs]
            failed = [pid for pid, rc in enumerate(rcs)
                      if rc is not None and rc != 0]
            if failed or all(rc == 0 for rc in rcs):
                break
            if time.monotonic() > t_end:
                _kill(procs)
                raise TimeoutError(f"{n_hosts} ranks of {target} outlasted "
                                   f"{timeout:.0f} s")
            time.sleep(0.05)
        if failed:
            # the others would wait in a collective until its timeout
            time.sleep(1.0)
            _kill(procs)
        for f_out, f_err in logs:
            f_out.close()
            f_err.close()
        LAST_LOGS = []
        for pid in range(n_hosts):
            with open(os.path.join(tmp, f"stdout_{pid}.txt")) as f:
                o = f.read()
            with open(os.path.join(tmp, f"stderr_{pid}.txt")) as f:
                e = f.read()
            LAST_LOGS.append((o, e))
        if failed:
            msg = "\n".join(
                f"rank {pid} rc={procs[pid].returncode}:\n"
                f"{LAST_LOGS[pid][1][-3000:]}" for pid in failed)
            raise RuntimeError(f"{len(failed)} of {n_hosts} ranks of "
                               f"{target} failed:\n{msg}")
        results = []
        for pid in range(n_hosts):
            with open(os.path.join(tmp, f"out_{pid}.json")) as f:
                results.append(json.load(f))
        return results
    finally:
        _kill(procs)
        for f_out, f_err in logs:
            f_out.close()
            f_err.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _worker_main() -> int:
    import argparse
    import importlib

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--target", required=True)
    ap.add_argument("--payload", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args()

    if args.threads > 0:
        torch.set_num_threads(args.threads)
    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     args.device)
    mod_name, fn_name = args.target.split(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    with open(args.payload) as f:
        payload = json.load(f)
    result = fn(payload, args.num_processes, args.process_id)
    with open(args.out, "w") as f:
        json.dump(result, f)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main())
