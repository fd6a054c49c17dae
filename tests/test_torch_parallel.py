"""The port's sharded paths on the CPU, held against the JAX package.

Ranks are processes of a gloo group on the CPU (``multihost.run_hosts``,
two of them); the JAX package runs its own sharded functions on its
8-device virtual CPU mesh (``tests/conftest.py``). Both take the same numpy
inputs:

- ``sharded_scan2map`` on the fixture of tests/test_parallel.py (a sorted
  voxel table), on a dense map and on a merged map of the same submap,
  against the JAX package's ``sharded_scan2map`` and ``loam.scan2map``:
  pose within 5e-3, n_valid within 2, the same converged flag (the JAX
  test's bounds);
- the NDT and VGICP sharded batches (``make_sharded_batch``) against the
  JAX package's sharded and one-device batches: pose rows within 5e-3;
- ``sharded_solve`` in its three modes on ``_ring_graph(k=24, k_cap=32,
  e_cap=64)`` against the JAX package's: translations within 1e-2, cost
  below 1e-2 of the initial cost (tests/test_parallel_dryrun.py).

Every rank must hold bit-identical results, two runs must repeat bit for
bit, and with one rank the hooks are the identity: bit-identical to the
unsharded call. The backend rule of ``parallel/mesh.py`` is tested pure.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleslam_tpu.ops import loam as jloam
from simpleslam_tpu.ops import ndt as jndt
from simpleslam_tpu.ops import pointcloud as jpc
from simpleslam_tpu.ops import vgicp as jvgicp
from simpleslam_tpu.ops import voxel as jvox
from simpleslam_tpu.parallel import dist_posegraph as jdpg
from simpleslam_tpu.parallel.dist_registration import \
    sharded_scan2map as j_sharded_scan2map
from simpleslam_tpu.parallel.mesh import make_mesh as j_make_mesh
from simpleslam_tpu.pipeline import simulate as sim
from simpleslam_tpu.pipeline import streamed as jstreamed
from simpleslam_tpu_torch.ops import loam as tloam
from simpleslam_tpu_torch.ops import ndt as tndt
from simpleslam_tpu_torch.ops import pointcloud as tpc
from simpleslam_tpu_torch.ops import vgicp as tvgicp
from simpleslam_tpu_torch.ops import voxel as tvox
from simpleslam_tpu_torch.parallel import mesh as tmesh
from simpleslam_tpu_torch.parallel import multihost
from simpleslam_tpu_torch.parallel.dist_posegraph import dryrun as t_dryrun
from simpleslam_tpu_torch.parallel.dist_registration import (
    loam_hooks, shard_cloud, sharded_scan2map)
from simpleslam_tpu_torch.pipeline import streamed as tstreamed

WORKERS = "simpleslam_tpu_torch.parallel.workers"
TARGETS = ("table", "dense", "merged")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ranks(fn: str, payload: dict, n: int = 2):
    return multihost.run_hosts(n, f"{WORKERS}:{fn}", payload, timeout=600.0,
                               device="cpu", threads=2)


# ---------------------------------------------------------------------------
# sharded scan2map
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    """tests/test_parallel.py's fixture, its submap also as a dense and a
    merged map, built by the JAX package; the port's copies from numpy."""
    rng = np.random.default_rng(7)
    world = sim.make_world(seed=11)
    scan = sim.simulate_scan(world, sim.sensor_from_body(np.eye(4)), rng=rng)
    ds = jpc.compact(jvox.voxel_downsample(jpc.from_numpy(scan, 32768), 0.5),
                     16384)
    zero = jnp.zeros(3, jnp.float32)
    table = jvox.build_voxel_map(ds, 1.0, zero, num_voxels=32768,
                                 slab_size=8)
    dense = jvox.build_dense_voxel_map(ds, 2.0, zero, dims=(96, 96, 16),
                                       slab_size=16)
    merged = jvox.build_merged_dense_voxel_map(ds, 2.0, zero,
                                               dims=(64, 64, 8),
                                               slab_size=16)
    scan2 = sim.simulate_scan(world, sim.sensor_from_body(np.eye(4)),
                              rng=rng)
    src = jpc.compact(jvox.voxel_downsample(jpc.from_numpy(scan2, 32768),
                                            0.5), 8192)
    guess = np.eye(4, dtype=np.float32)
    guess[:3, 3] = [0.1, -0.1, 0.0]
    t_targets = {
        "table": tvox.VoxelMap.from_numpy(
            np.asarray(table.keys), np.asarray(table.slab), table.counts,
            table.origin, table.grid, "cpu"),
        "dense": tvox.DenseVoxelMap.from_numpy(
            np.asarray(dense.slab), dense.counts, dense.corner, dense.grid,
            dense.dims, dense.slab_pts, "cpu"),
        "merged": tvox.MergedDenseVoxelMap.from_numpy(
            np.asarray(merged.rows), merged.scale, merged.corner,
            merged.grid, merged.dims, merged.slab_pts, "cpu"),
    }
    t_src = tpc.from_arrays(np.asarray(src.xyz), np.asarray(src.intensity),
                            np.asarray(src.mask), "cpu")
    path = tmp_path_factory.mktemp("reg") / "inputs.pt"
    torch.save({"src": t_src, "init": torch.tensor(guess),
                "targets": t_targets}, path)
    return {"j_src": src, "j_targets": {"table": table, "dense": dense,
                                        "merged": merged},
            "guess": guess, "t_src": t_src, "t_targets": t_targets,
            "path": str(path)}


@pytest.fixture(scope="module")
def jax_reg(reg):
    """The JAX package's sharded (8 devices) and one-device results."""
    fn = j_sharded_scan2map(j_make_mesh(8, ("dp",)))
    guess = jnp.asarray(reg["guess"])
    return {name: (fn(reg["j_src"], vm, guess),
                   jloam.scan2map(reg["j_src"], vm, guess))
            for name, vm in reg["j_targets"].items()}


@pytest.fixture(scope="module")
def reg_ranks(reg):
    return _ranks("scan2map_worker", {"inputs": reg["path"], "reps": 2})


@pytest.mark.parametrize("target", TARGETS)
def test_sharded_scan2map_matches_jax(reg, jax_reg, reg_ranks, target):
    got = reg_ranks[0]["targets"][target]["runs"][0]
    for ref in jax_reg[target]:
        assert got["converged"] == bool(ref.converged)
        np.testing.assert_allclose(np.asarray(got["pose"]),
                                   np.asarray(ref.pose), atol=5e-3)
        assert abs(got["n_valid"] - int(ref.n_valid)) <= 2
    assert got["converged"] and got["n_valid"] > 100


@pytest.mark.parametrize("target", TARGETS)
def test_sharded_scan2map_ranks_agree_and_repeat(reg_ranks, target):
    r0 = reg_ranks[0]["targets"][target]
    assert reg_ranks[1]["targets"][target]["runs"] == r0["runs"]
    assert r0["runs"][0] == r0["runs"][1]
    assert reg_ranks[0]["backend"] == "gloo"
    assert reg_ranks[0]["block"] == 4096
    # one 43-float sum per GN iteration plus the range max, nothing staged
    st = r0["stats"]
    assert st["collectives"] == 2 * (r0["runs"][0]["iters"] + 1)
    assert st["staged_calls"] == 0


@pytest.mark.parametrize("target", TARGETS)
def test_one_rank_hooks_are_the_identity(reg, target):
    """A one-rank mesh needs no process group, sets no hook, and its
    sharded call is the unsharded ``gn_loop`` bit for bit (K3 on CUDA)."""
    mesh = tmesh.make_mesh(1, ("dp",), device=torch.device("cpu"))
    assert loam_hooks(mesh.axis("dp")) == (None, None)
    vm, init = reg["t_targets"][target], torch.tensor(reg["guess"])
    got = sharded_scan2map(mesh)(shard_cloud(mesh, reg["t_src"]), vm, init)
    want = tloam.gn_loop(reg["t_src"], vm, init)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# NDT and VGICP sharded batches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch(reg, tmp_path_factory):
    """tests/test_parallel.py's batch inputs: the fixture's scan, quantized
    as the executor uploads it, twice; NDT and VGICP targets of its own
    points (each package builds its own)."""
    src = reg["j_src"]
    xyz = np.asarray(src.xyz)
    q = np.where(np.asarray(src.mask)[:, None],
                 np.clip(np.rint(xyz / jstreamed.UPLOAD_SCALE), -32766,
                         32766),
                 float(jstreamed.UPLOAD_PAD)).astype(np.int16)
    rows = np.tile(q[None], (2, 1, 1))
    zero = jnp.zeros(3, jnp.float32)
    j_targets = {"ndt": jndt.build_target(src, 1.0, zero, dims=(24, 24, 12)),
                 "vgicp": jvgicp.build_target(src, 1.0, zero,
                                              dims=(24, 24, 12))}
    tzero = torch.zeros(3)
    t_targets = {"ndt": tndt.build_target(reg["t_src"], 1.0, tzero,
                                          (24, 24, 12)),
                 "vgicp": tvgicp.build_target(reg["t_src"], 1.0, tzero,
                                              (24, 24, 12))}
    guess = torch.tensor(reg["guess"])
    path = tmp_path_factory.mktemp("batch") / "inputs.pt"
    torch.save({"rows": torch.from_numpy(rows), "pose_prev": guess,
                "pose_prev2": guess, "odom2map": torch.eye(4),
                "targets": t_targets}, path)
    return {"rows": rows, "j_targets": j_targets, "t_targets": t_targets,
            "path": str(path)}


@pytest.fixture(scope="module")
def batch_ranks(batch):
    return _ranks("batch_worker", {"inputs": batch["path"], "reps": 1})


@pytest.mark.parametrize("kind", ["ndt", "vgicp"])
def test_sharded_batch_matches_jax(reg, batch, batch_ranks, kind):
    rows = jnp.asarray(batch["rows"])
    eyes = jnp.asarray(np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)))
    guess = jnp.asarray(reg["guess"])
    eye = jnp.eye(4, dtype=jnp.float32)
    tgt = batch["j_targets"][kind]
    (_, _, _), p_single = jstreamed._streamed_batch(
        rows, eyes, tgt, guess, guess, eye, kind, "lo")
    fn = jstreamed.make_sharded_batch(j_make_mesh(8, ("dp",)), kind, "lo",
                                      True, 0.0)
    (_, _, _), p_mesh = fn(rows, eyes, tgt, guess, guess, eye)
    got = np.asarray(batch_ranks[0][kind]["runs"][0]["packed"])
    assert np.isfinite(got).all()
    for ref in (p_mesh, p_single):
        np.testing.assert_allclose(got[:, :16], np.asarray(ref)[:, :16],
                                   atol=5e-3, err_msg=kind)


@pytest.mark.parametrize("kind", ["ndt", "vgicp"])
def test_sharded_batch_ranks_agree(batch_ranks, kind):
    assert batch_ranks[1][kind]["runs"] == batch_ranks[0][kind]["runs"]
    # NDT: 44 + 6 floats per Newton iteration (30), 44 + 1 at the end;
    # VGICP: 44 per linearization (31), 2 for the fitness
    per_scan = {"ndt": 2 * 30 + 2, "vgicp": 31 + 1}[kind]
    assert batch_ranks[0][kind]["stats"]["collectives"] == 2 * per_scan


@pytest.mark.parametrize("kind", ["ndt", "vgicp"])
def test_one_rank_batch_is_the_unsharded_batch(reg, batch, kind):
    mesh = tmesh.make_mesh(1, ("dp",), device=torch.device("cpu"))
    rows = torch.from_numpy(batch["rows"][:, :2048])
    guess = torch.tensor(reg["guess"])
    tgt = batch["t_targets"][kind]
    got = tstreamed.make_sharded_batch(mesh, kind, "lo", True, 0.0)(
        rows, None, tgt, guess, guess, torch.eye(4))
    want = tstreamed._batch_body(rows, tgt, guess, guess, torch.eye(4), kind,
                                 True, 0.0)
    assert torch.equal(got[1], want[1])
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# edge-sharded pose-graph solve
# ---------------------------------------------------------------------------

MODES = {"replicated": {}, "shard_cg": {"shard_cg": True},
         "shard_lin": {"shard_lin": True}}
RING = {"k": 24, "k_cap": 32, "e_cap": 64, "drift": 0.05, "n_lc": 0,
        "max_iters": 8, "cg_iters": 48}


@pytest.fixture(scope="module")
def solve_ranks():
    return _ranks("posegraph_worker", dict(
        RING, reps=1, warmup=False, return_poses=RING["k"],
        modes=list(MODES.values())))


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_solve_matches_jax(solve_ranks, mode):
    from jax.sharding import Mesh
    import jax

    g = jdpg._ring_graph(k=RING["k"], k_cap=RING["k_cap"],
                         e_cap=RING["e_cap"], drift=RING["drift"])
    fn = jdpg.sharded_solve(Mesh(np.array(jax.devices()[:8]), ("kf",)),
                            axis="kf", max_iters=RING["max_iters"],
                            cg_iters=RING["cg_iters"], **MODES[mode])
    ref = fn(g)
    got = solve_ranks[0]["modes"][list(MODES).index(mode)]
    assert got["cost"] < got["cost0"] * 1e-2
    assert got["cost0"] == pytest.approx(float(ref.cost0), rel=1e-5)
    np.testing.assert_allclose(np.asarray(got["poses"])[:, :3, 3],
                               np.asarray(ref.poses)[:RING["k"], :3, 3],
                               atol=1e-2)


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_solve_ranks_agree(solve_ranks, mode):
    i = list(MODES).index(mode)
    assert solve_ranks[1]["modes"][i]["poses"] == \
        solve_ranks[0]["modes"][i]["poses"]
    # replicated CG: the topology, then one gather per linearization
    if mode == "replicated":
        assert solve_ranks[0]["modes"][i]["collectives_per_solve"] == \
            2 + RING["max_iters"]


def test_dist_posegraph_dryrun_on_one_rank():
    t_dryrun(tmesh.make_mesh(1, ("kf",), device=torch.device("cpu")))


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,device,cards,want", [
    (2, "cpu", 0, "gloo"),
    (4, "cuda", 1, "gloo"),
    (4, "cuda", 2, "gloo"),
    (2, "cuda", 2, "nccl"),
    (1, "cuda", 8, "nccl"),
], ids=["cpu", "more_ranks_than_cards", "still_more", "a_card_each",
        "one_rank"])
def test_backend_rule(world, device, cards, want):
    assert tmesh.choose_backend(world, device, cards) == want


def test_mesh_refuses_a_world_it_does_not_have():
    with pytest.raises(RuntimeError, match="run_hosts.*torchrun"):
        tmesh.make_mesh(2, ("dp",))
    mesh = tmesh.make_mesh(1, ("dp", "mp"), device=torch.device("cpu"))
    assert mesh.shape == {"dp": 1, "mp": 1} and mesh.world_size == 1
    assert mesh.axis("dp").gather_sum(torch.ones(3)).tolist() == [1.0, 1.0, 1.0]
    assert tmesh._largest_factor_leq_sqrt(8) == 2


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank"):
        _ranks("posegraph_worker", {"k": 24, "k_cap": 32, "e_cap": 64,
                                    "modes": [{"no_such_flag": 1}],
                                    "max_iters": "not a number"})
