"""Multi-rank dry runs: the port's counterparts of the reference package's
driver hooks ``multichip_pipeline_parity`` and ``dryrun_multichip``.

Both start their ranks with ``multihost.run_hosts`` (one process per rank)
and hold what the ranks return: every rank's poses, and rank 0's result
against a run on one device in this process.
"""

from __future__ import annotations

import copy
import os
import pickle
import tempfile
from typing import Optional

import numpy as np

from . import multihost

# the reference hook's configuration (a short synthetic sequence mapped
# with the backend on, loop closure off, at reduced capacities)
PARITY_CONFIG = {
    "mode": "lo",
    "backend": {"enable": True, "lc": {"enable": False}},
    "frontend": {"pcr": "loam"},
    "saveMapDir": "",
    "tpu": {"scan_capacity": 16384, "ds_scan_capacity": 4096,
            "kf_capacity": 4096, "submap_capacity": 32768,
            "dense_grid_dims": [64, 64, 16], "max_keyframes": 256,
            "max_edges": 1024, "kf_bucket": 64, "edge_bucket": 128},
}


def _device(device: Optional[str]) -> str:
    if device is not None:
        return device
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def multichip_pipeline_parity(n_devices: int, n_scans: int = 16,
                              sync_every: int = 8,
                              device: Optional[str] = None,
                              threads: int = 0):
    """Map one short synthetic sequence twice: on one device in this
    process, and on ``n_devices`` ranks (registration point-sharded over
    "dp", the backend's graph edge-sharded over "kf"). Returns (single
    SlamResult, rank 0's result dict, every rank's poses (n, S, 4, 4))."""
    from ..pipeline import app
    from ..pipeline import simulate as sim
    from ..pipeline.streamed import run_streamed
    from ..utils.config import Params

    dev = _device(device)
    world = sim.make_world(seed=0, extent=40.0, n_buildings=10)
    streams = sim.simulate_sequence(world, n_scans=n_scans, seed=0,
                                    n_az=900, n_el=16, radius=15.0)
    cfg = copy.deepcopy(PARITY_CONFIG)
    cfg["torch"] = {"device": dev}
    cfg["tpu"]["mesh_devices"] = n_devices
    with tempfile.TemporaryDirectory(prefix="ssl_streams_") as tmp:
        path = os.path.join(tmp, "streams.pkl")
        with open(path, "wb") as f:
            pickle.dump(streams, f)
        ranks = multihost.run_hosts(
            n_devices,
            "simpleslam_tpu_torch.parallel.workers:pipeline_worker",
            {"config": cfg, "streams": path, "sync_every": sync_every},
            timeout=900.0, device=dev, threads=threads)
    cfg["tpu"]["mesh_devices"] = 0
    Params.load(cfg)
    try:
        single = run_streamed(app.SlamSystem(), streams,
                              sync_every=sync_every)
    finally:
        Params.reset()
    return single, ranks[0], np.array([r["poses"] for r in ranks])


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     threads: int = 0, n_scans: int = 16,
                     sync_every: int = 8):
    """Run the sharded paths on ``n_devices`` ranks, shallow to deep: the
    point-parallel registration on a dense map and a sorted table, the
    edge-sharded pose-graph solve in its three modes, the NDT and VGICP
    sharded batches (``workers.dryrun_worker``), then the whole streamed
    pipeline against a one-device run (translations within 5e-3 m, more
    than 90 % of scans converged, every rank bit-identical). Returns the
    pipeline's ``multichip_pipeline_parity`` triple."""
    res = multihost.run_hosts(
        n_devices, "simpleslam_tpu_torch.parallel.workers:dryrun_worker", {},
        timeout=900.0, device=_device(device), threads=threads)
    for r in res[1:]:
        assert r == res[0], "ranks disagree"
    single, meshed, poses = multichip_pipeline_parity(
        n_devices, n_scans, sync_every, device=device, threads=threads)
    assert (poses == poses[0]).all(), "ranks disagree"
    err = np.max(np.linalg.norm(single.poses[:, :3, 3]
                                - poses[0][:, :3, 3], axis=1))
    assert err < 5e-3, f"mesh pipeline diverged from one device: {err}"
    assert meshed["converged_frac"] > 0.9
    return single, meshed, poses
