"""The port's whole streamed pipeline on a mesh of ranks, and the launcher.

The mesh pipeline (``tpu.mesh_devices = 2``: two gloo ranks on the CPU,
scan points sharded over "dp", the backend's graph edge-sharded over "kf")
maps the short sequence of the reference package's
``__graft_entry__.multichip_pipeline_parity(8, n_scans=24, sync_every=8)``,
and is held against that run of the JAX package on its 8-device mesh with
tests/test_multichip_pipeline.py's bounds: per-scan translations within
5e-3 m, the same keyframe count (at least 3), more than 90 % of scans
converged; both ranks end with bit-identical poses. The launcher is held to
tests/test_multihost.py's: two hosts agree within 1e-5 and lie within 1e-3
of the single-process solve. The CLI starts its own ranks.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from simpleslam_tpu_torch.parallel import dryrun, multihost
from simpleslam_tpu_torch.parallel.workers import posegraph_worker
from simpleslam_tpu_torch.pipeline import app as tapp
from simpleslam_tpu_torch.utils.config import Params as TParams
from simpleslam_tpu_torch.utils.logging import Logger as TLogger

WORKERS = "simpleslam_tpu_torch.parallel.workers"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    TParams.reset()
    yield
    TParams.reset()
    TLogger.reset()


@pytest.fixture(scope="module")
def parity_runs():
    """``dryrun.dryrun_multichip`` on two ranks (its sharded paths, then the
    pipeline against one device, asserted inside), at the reference test's
    24 scans, and the JAX package's mesh run."""
    single, rank0, poses = dryrun.dryrun_multichip(
        2, device="cpu", threads=2, n_scans=24, sync_every=8)
    _, j_mesh = graft.multichip_pipeline_parity(8, n_scans=24, sync_every=8)
    return single, rank0, poses, j_mesh


def test_mesh_pipeline_matches_jax_mesh(parity_runs):
    single, rank0, poses, j_mesh = parity_runs
    for ref in (j_mesh.poses, single.poses):
        err = np.linalg.norm(poses[0][:, :3, 3] - ref[:, :3, 3], axis=1)
        assert np.max(err) < 5e-3, np.max(err)
    assert rank0["converged_frac"] > 0.9


def test_mesh_pipeline_produces_keyframes(parity_runs):
    single, rank0, _, j_mesh = parity_runs
    assert rank0["keyframe_count"] == j_mesh.keyframe_count
    assert rank0["keyframe_count"] == single.keyframe_count
    assert rank0["keyframe_count"] >= 3


def test_mesh_pipeline_ranks_agree(parity_runs):
    _, rank0, poses, _ = parity_runs
    assert (poses[1] == poses[0]).all()
    m = rank0["mesh"]
    assert m["ranks"] == 2 and m["backend"] == "gloo"
    # one range max and one sum per GN iteration of 23 registrations
    assert m["collectives"] >= 2 * 23 and m["staged_bytes"] == 0
    assert rank0["scan_capacity"] % 2 == 0


def test_one_rank_pipeline_is_the_unsharded_pipeline():
    """``tpu.mesh_devices = 1`` sets no hook and solves the graph as one
    device does: the pipeline is the unsharded one bit for bit."""
    import copy

    from simpleslam_tpu_torch.pipeline import simulate as sim
    from simpleslam_tpu_torch.pipeline.streamed import run_streamed

    world = sim.make_world(seed=0, extent=40.0, n_buildings=10)
    streams = sim.simulate_sequence(world, n_scans=12, seed=0, n_az=900,
                                    n_el=16, radius=15.0)
    runs = []
    for n in (0, 1):
        cfg = copy.deepcopy(dryrun.PARITY_CONFIG)
        cfg["torch"] = {"device": "cpu"}
        cfg["tpu"]["mesh_devices"] = n
        TParams.load(cfg)
        system = tapp.SlamSystem()
        assert system.backend._mesh is None
        res = run_streamed(system, streams, sync_every=4)
        runs.append((res.poses, np.asarray(res.extras["kf_poses"])))
        TParams.reset()
    assert np.array_equal(runs[0][0], runs[1][0])
    assert np.array_equal(runs[0][1], runs[1][1])


def test_two_hosts_devices_and_registration():
    """The reference's devices_worker (one device per host: the layout and a
    cross-host sum of the process ids) and registration_worker (the plane
    world on a dense map, from a 5 cm offset) in one set of two ranks."""
    tasks = [{"fn": "devices_worker"},
             {"fn": "registration_worker",
              "payload": {"n_src": 8192, "n_map": 4096, "reps": 1}}]
    res = multihost.run_hosts(2, f"{WORKERS}:tasks_worker",
                              {"tasks": tasks}, timeout=300.0, device="cpu",
                              threads=2)
    for pid, r in enumerate(res):
        dev, reg = (t["result"] for t in r["tasks"])
        assert dev["n_global"] == 2 and dev["n_local"] == 1
        assert dev["process_id"] == pid and dev["psum"] == 1.0
        assert dev["backend"] == "gloo"
        assert reg["converged"] and reg["pose_err"] < 0.01
        assert reg["n_devices"] == 2
    assert res[0]["tasks"][1]["result"]["pose_err"] == \
        res[1]["tasks"][1]["result"]["pose_err"]


def test_two_host_posegraph_parity():
    """tests/test_multihost.py's payload on two hosts."""
    payload = {"k": 48, "k_cap": 64, "e_cap": 128, "max_iters": 4,
               "cg_iters": 16, "reps": 1, "n_lc": 2, "return_poses": 48}
    res = multihost.run_hosts(2, f"{WORKERS}:posegraph_worker", payload,
                              timeout=300.0, device="cpu", threads=2)
    assert res[0]["cost"] < res[0]["cost0"]
    p0, p1 = np.asarray(res[0]["poses"]), np.asarray(res[1]["poses"])
    np.testing.assert_allclose(p0, p1, atol=1e-5)
    ref = posegraph_worker(payload, 1, 0)
    np.testing.assert_allclose(p0, np.asarray(ref["poses"]), atol=1e-3)
    assert ref["cost"] == pytest.approx(res[0]["cost"], rel=1e-2, abs=1e-4)


def test_cli_runs_a_mesh_on_ranks_it_starts(tmp_path, capsys, monkeypatch):
    """``tpu.mesh_devices = 2`` outside a process group: the CLI starts two
    ranks, prints rank 0's report, and rank 0 writes the artifacts."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # each rank's torch threads
    cfg = tmp_path / "mesh.json"
    cfg.write_text('{"torch": {"device": "cpu"}, "tpu": {"mesh_devices": 2,'
                   ' "scan_capacity": 8192, "kf_bucket": 16, "edge_bucket":'
                   ' 32}, "backend": {"enable": true, "lc": {"enable": '
                   'false}}}')
    out = tmp_path / "map"
    assert tapp.main(["--synthetic", "--streamed", "--config", str(cfg),
                      "--scans", "6", "--out", str(out)]) == 0
    for name in ("fg.g2o", "tum.txt", "0.pcd"):
        assert (out / name).is_file(), name
    text = capsys.readouterr().out
    assert "torch.distributed backend gloo" in text and "dispatch" in text
