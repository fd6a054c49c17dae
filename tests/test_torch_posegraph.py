"""Parity: the PyTorch port's pose-graph solver against the JAX package on
the graphs of tests/test_posegraph.py (same seeds): a drifted circle with
one loop closure, a drifted chain without one, and the undrifted circle.

Tolerances, with what was measured on these graphs on the CPU:
- residuals within 1e-5 (measured 1.0e-6);
- Jacobians within 2e-4 of the largest |J| entry of the graph (measured
  7.9e-5 on the drifted chain):
  the rotation part goes through ``arccos`` of a trace near 1 in f32, where
  a few ulps of the composed rotation (matrix products in another order)
  become ~1e-4 relative at millirad residuals, in either package;
- graph cost within 1e-5 relative;
- solved poses within 1e-4 (measured 5.7e-6 dense, 1.7e-5 PCG), final
  chi2 at the same noise floor (both < 1e-2 of the initial chi2 where the
  reference test asks it).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from simpleslam_tpu.ops import posegraph as jpg
from simpleslam_tpu_torch.ops import posegraph as tpg
from test_posegraph import _build_graph

# jitted once per module (all graphs share K = 32, E = 64); the PCG solve is
# traced inside the first test that patches DENSE_SOLVE_MAX_K
_jax_linearize = jax.jit(jpg._linearize_edges)
_jax_pcg_solve = jax.jit(functools.partial(jpg.solve_impl, max_iters=20,
                                           cg_iters=96))

GRAPHS = {
    "circle_lc": dict(),
    "chain": dict(with_lc=False, drift=0.02),
    "exact": dict(drift=0.0),
}


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


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request):
    g, gt, k = _build_graph(**GRAPHS[request.param])
    return request.param, g, _port(g), gt, k


def test_linearize_edges_matches_jax(graph):
    _, g, tg, _, _ = graph
    rj, Jij, Jjj = (np.asarray(a) for a in _jax_linearize(g))
    rt, Jit, Jjt = (a.numpy() for a in tpg._linearize_edges(tg))
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-5)
    scale = max(np.abs(Jij).max(), np.abs(Jjj).max())
    for jt, jj in ((Jit, Jij), (Jjt, Jjj)):
        assert np.isfinite(jt).all()
        np.testing.assert_allclose(jt, jj, rtol=0, atol=2e-4 * scale)


def test_graph_cost_matches_jax(graph):
    _, g, tg, _, _ = graph
    cj, ct = float(jpg.graph_cost(g)), float(tpg.graph_cost(tg))
    assert abs(ct - cj) <= 1e-5 * max(cj, 1e-3), (ct, cj)


@pytest.mark.parametrize("path", ["dense", "pcg"])
def test_solve_matches_jax(graph, path, monkeypatch):
    name, g, tg, gt, k = graph
    if path == "pcg":  # K = 32 above the cut: both packages take PCG
        monkeypatch.setattr(tpg, "DENSE_SOLVE_MAX_K", 4)
        monkeypatch.setattr(jpg, "DENSE_SOLVE_MAX_K", 4)
        rj = _jax_pcg_solve(g)
    else:
        rj = jpg.solve(g, max_iters=20, cg_iters=96)
    rt = tpg.solve(tg, max_iters=20, cg_iters=96)
    cost0 = float(rj.cost0)
    assert abs(float(rt.cost0) - cost0) <= 1e-5 * max(cost0, 1e-3)
    assert abs(float(rt.cost) - float(rj.cost)) <= 1e-4 * max(cost0, 1e-3)
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses),
                               rtol=0, atol=1e-4)
    if name == "circle_lc":  # the reference test's recovery bounds
        assert float(rt.cost) < cost0 * 1e-2
        err = np.linalg.norm(rt.poses.numpy()[:k, :3, 3] - gt[:, :3, 3],
                             axis=1)
        assert err.max() < 0.05, err.max()
    # padding nodes are never touched
    np.testing.assert_array_equal(rt.poses.numpy()[k:], tg.poses.numpy()[k:])


def test_solve_repeats_bit_for_bit(graph):
    _, _, tg, _, _ = graph
    a = tpg.solve(tg, max_iters=12)
    b = tpg.solve(tg, max_iters=12)
    assert torch.equal(a.poses, b.poses) and torch.equal(a.cost, b.cost)
