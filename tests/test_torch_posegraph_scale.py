"""The PyTorch port's pose-graph solver above the dense cut
(``posegraph.DENSE_SOLVE_MAX_K`` = 512, no monkeypatch), beside the JAX
package, on the ring graphs of tests/test_posegraph_scale.py.

The graphs come from ``parallel.dist_posegraph._ring_graph`` of both
packages with the same arguments: the port's equals the JAX package's
(closures and measurements bit for bit, the drifted start within 1e-4 m,
one batched ``se3_exp`` in another library). Both solvers are then given
the JAX package's graph.

- K = 600 / E = 2400 with 200 closures, PCG in both packages at 6 LM
  iterations of 48 CG iterations (a small count, so that both solves fit
  Tier-1): poses within 1e-4 m of the JAX package's ``posegraph.solve``,
  final cost within 1e-4 of the initial cost (measured on the CPU: see the
  test's print).
- the incremental case of tests/test_posegraph_scale.py (K = 256, dense):
  half the graph solved, then the whole from that warm start, against the
  batch solve, in both packages and across them.
- K = 1536 / E = 6144 at the reference test's 40 x 256 iterations, marked
  ``slow`` as that test is: its recovery bounds on the port, and within
  1e-4 m of the JAX package.
"""

import numpy as np
import pytest
import torch

from simpleslam_tpu.ops import posegraph as jpg
from simpleslam_tpu.parallel.dist_posegraph import _ring_graph as j_ring_graph
from simpleslam_tpu_torch.ops import posegraph as tpg
from simpleslam_tpu_torch.parallel.dist_posegraph import _ring_graph

POSE_T_TOL = 1e-4         # metres, port against JAX


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs several workers on a few cores: two torch threads a
    worker keeps them from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(g) -> tpg.PoseGraph:
    return tpg.PoseGraph(*(torch.tensor(np.asarray(x)) for x in g))


def _graphs(**kw):
    """The JAX package's ring graph, the port's, and the ground truth."""
    jg, gt = j_ring_graph(return_gt=True, **kw)
    tg, tgt = _ring_graph(return_gt=True, **kw)
    np.testing.assert_array_equal(tgt, gt)
    for name in ("kf_mask", "edge_i", "edge_j", "edge_T", "edge_info",
                 "edge_mask", "prior_pose", "prior_info"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)), name)
    np.testing.assert_allclose(tg.poses.numpy(), np.asarray(jg.poses),
                               rtol=0, atol=POSE_T_TOL)
    return jg, gt


def _hold(rt, rj, k: int):
    cost0 = float(rj.cost0)
    assert abs(float(rt.cost0) - cost0) <= 1e-5 * cost0
    assert abs(float(rt.cost) - float(rj.cost)) <= 1e-4 * cost0
    gap = np.abs(rt.poses.numpy()[:k] - np.asarray(rj.poses)[:k]).max()
    assert gap < POSE_T_TOL, gap
    return gap


@pytest.fixture(scope="module")
def k600():
    k = 600
    jg, gt = _graphs(k=k, k_cap=k, e_cap=2400, n_lc=200, drift=0.03, seed=3)
    assert k > tpg.DENSE_SOLVE_MAX_K == jpg.DENSE_SOLVE_MAX_K
    rj = jpg.solve(jg, max_iters=6, cg_iters=48)
    rt = tpg.solve(_port(jg), max_iters=6, cg_iters=48)
    return k, gt, jg, rj, rt


def test_pcg_above_the_cut_matches_jax(k600):
    k, gt, _, rj, rt = k600
    gap = _hold(rt, rj, k)
    err = np.linalg.norm(rt.poses.numpy()[:k, :3, 3] - gt[:, :3, 3], axis=1)
    print(f"K = {k}: cost {float(rt.cost0):.2f} -> {float(rt.cost):.4f} "
          f"(JAX {float(rj.cost):.4f}); poses {gap:.3e} from the JAX "
          f"package's; worst error against the truth {err.max():.4f} m")
    assert int(rt.iters) == int(rj.iters)
    assert float(rt.cost) < float(rt.cost0)


def test_pcg_above_the_cut_leaves_padding_and_repeats(k600):
    k, _, jg, _, rt = k600
    tg = _port(jg)
    again = tpg.solve(tg, max_iters=6, cg_iters=48)
    assert torch.equal(again.poses, rt.poses)
    assert torch.equal(again.cost, rt.cost)
    np.testing.assert_array_equal(rt.poses.numpy()[k:], tg.poses.numpy()[k:])


def test_incremental_solve_matches_batch():
    """Growing the graph (the backend's masked row updates) reaches the
    batch optimum: tests/test_posegraph_scale.py's case, in both packages."""
    k = 256
    jg, _ = _graphs(k=k, k_cap=k, e_cap=512, n_lc=32, drift=0.02, seed=5)
    g = _port(jg)
    half = k // 2
    first = (g.edge_i < half) & (g.edge_j < half) & g.edge_mask
    batch = tpg.solve(g, max_iters=10, cg_iters=64)
    g1 = g._replace(kf_mask=torch.arange(k) < half, edge_mask=first)
    r1 = tpg.solve(g1, max_iters=10, cg_iters=64)
    assert float(r1.cost) < float(r1.cost0)
    poses = r1.poses.clone()
    poses[half:] = g.poses[half:]
    inc = tpg.solve(g._replace(poses=poses), max_iters=10, cg_iters=64)
    p_b, p_i = batch.poses.numpy()[:, :3, 3], inc.poses.numpy()[:, :3, 3]
    np.testing.assert_allclose(p_i, p_b, atol=2e-2)
    # the same three solves in the JAX package
    import jax.numpy as jnp

    jb = jpg.solve(jg, max_iters=10, cg_iters=64)
    j1 = jpg.solve(jg._replace(kf_mask=jnp.asarray(np.arange(k) < half),
                               edge_mask=jnp.asarray(first.numpy())),
                   max_iters=10, cg_iters=64)
    ji = jpg.solve(jg._replace(poses=j1.poses.at[half:].set(jg.poses[half:])),
                   max_iters=10, cg_iters=64)
    for rt, rj in ((batch, jb), (r1, j1), (inc, ji)):
        _hold(rt, rj, k)


@pytest.mark.slow
def test_large_graph_f32_convergence():
    """tests/test_posegraph_scale.py's K = 1536 case on the port."""
    k = 1536
    jg, gt = _graphs(k=k, k_cap=k, e_cap=6144, n_lc=512, drift=0.03, seed=3)
    init_err = np.linalg.norm(np.asarray(jg.poses)[:k, :3, 3] - gt[:, :3, 3],
                              axis=1)
    assert init_err.max() > 1.0
    rt = tpg.solve(_port(jg), max_iters=40, cg_iters=256)
    assert np.isfinite(float(rt.cost))
    assert float(rt.cost) < 1e-3 * float(rt.cost0)
    opt = rt.poses.numpy()[:k].astype(np.float64)
    err = np.linalg.norm(opt[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert err.max() < 0.05, (err.max(), err.mean())
    R = opt[:, :3, :3]
    np.testing.assert_allclose(np.einsum("kij,kil->kjl", R, R),
                               np.tile(np.eye(3), (k, 1, 1)), atol=5e-4)
    rj = jpg.solve(jg, max_iters=40, cg_iters=256)
    gap = _hold(rt, rj, k)
    print(f"K = {k}: worst error against the truth {err.max() * 1e3:.2f} mm;"
          f" {gap:.3e} from the JAX package's poses")

