"""The pose-graph solve above the dense cut reads nothing from the device
once its topology tables are built: on the card an LM iteration of the PCG
solve runs with ``torch.cuda.set_sync_debug_mode("error")``. The damping
starts as a device fill (a tensor made from a host scalar is a copy the
host waits for) and the block-Jacobi preconditioner inverts without
``torch.linalg.inv``'s singularity check (which reads the device).

Sync debugging is a CUDA facility, so the test needs a card; it imports
only the port, so that it runs there with
``python -m pytest --noconftest -o addopts="" tests/test_torch_posegraph_sync.py``
(the suite's conftest imports jax). On the CPU the inverse is held to
``torch.linalg.inv``'s bit for bit.
"""

import pytest
import torch

from simpleslam_tpu_torch.ops import posegraph as tpg
from simpleslam_tpu_torch.parallel.dist_posegraph import _ring_graph


def test_preconditioner_inverse_is_linalg_inv():
    g = _ring_graph(k=64, k_cap=64, e_cap=128, n_lc=8, drift=0.03, seed=3)
    lin = tpg._linearize_full(g, g.poses, tpg._tables(g))
    eye = torch.eye(6).expand(64, 6, 6)
    damped = lin.diag + 1e-4 * (lin.diag * eye) + 1e-8 * eye
    assert torch.equal(tpg._inv(damped), torch.linalg.inv(damped))


@pytest.mark.cuda
def test_lm_iteration_makes_no_host_sync_after_the_topology_read(
        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: sync debugging is a CUDA facility")
    g = _ring_graph(k=600, k_cap=600, e_cap=2400, n_lc=200, drift=0.03,
                    seed=3, device=torch.device("cuda"))
    assert 600 > tpg.DENSE_SOLVE_MAX_K
    tab = tpg._tables(g)
    monkeypatch.setattr(tpg, "_tables", lambda _g: tab)
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = tpg.solve(g, max_iters=2, cg_iters=16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(res.cost) < float(res.cost0)
