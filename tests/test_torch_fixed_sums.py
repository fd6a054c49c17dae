"""The layout and the fixed-order sums of the LOAM kernels K1, K2 and K3
(``simpleslam_tpu_torch/csrc/fixed_sums.h``), compiled for the host as the
whole body of K2 (``native.k2_host``: every block and lane of a grid of G
blocks emulated on one thread).

On the card block b owns queries b, b + G, ..., thread t of its 512 takes
its local queries t, t + 512, ... and adds their rows in float; the block's
partial is summed in double (lane l adds threads l, l + 32, ..., then the
warp's tree), the grid's sum likewise over the blocks' partials, rounded to
float once. Held here, on planes and queries made from a numpy seed, over
G in {1, 7, 132} (132: the H100's SMs) and Q in {0, 5, 131, 3072, 6144}:
- against ``plane_normal_equations_plain`` at the tolerances of
  tests/test_loam_pallas.py (J^T J within 2e-5 max|J^T J|, J^T e within
  5e-4 max|J^T e|: f32 sums in another order), n_valid exactly, also with
  every plane's gate off;
- bit for bit against a numpy float64 mirror of that order, and against
  itself on a second call.
"""

import numpy as np
import pytest
import torch

from simpleslam_tpu_torch import native
from simpleslam_tpu_torch.ops import loam_kernels as lk
from simpleslam_tpu_torch.ops.loam import Planes

GRIDS = [1, 7, 132]
QUERIES = [0, 5, 131, 3072, 6144]
THREADS = 512   # fs::kBlockThreads
F = np.float32


def _planes(n_q: int, case: str):
    """Queries and frozen planes near them: (centroid, normal, ok, p,
    sqrt_r); some rows fail the weight test (a plane far from its query)."""
    rng = np.random.default_rng([n_q, ["random", "all-masked"].index(case)])
    p = rng.uniform(-20, 20, (n_q, 3)).astype(F)
    n = rng.normal(size=(n_q, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(F)
    off = rng.uniform(-0.3, 0.3, (n_q, 1)) * np.where(
        rng.random((n_q, 1)) < 0.05, 40.0, 1.0)
    c = (p + n * off + rng.uniform(-1, 1, (n_q, 3))
         * 0.1).astype(F)
    ok = rng.random(n_q) > 0.2
    if case == "all-masked":
        ok[:] = False
    sqrt_r = np.sqrt(np.maximum(np.linalg.norm(p, axis=1), 1e-6)).astype(F)
    return c, n, ok, p, sqrt_r


def _rows(c, n, ok, p, sqrt_r):
    """Each query's 28 terms in float32, op for op as accumulate_row; zero
    where the row is not valid."""
    d = ((p[:, 0] - c[:, 0]) * n[:, 0] + (p[:, 1] - c[:, 1]) * n[:, 1]) \
        + (p[:, 2] - c[:, 2]) * n[:, 2]
    s = F(1.0) - (F(0.9) * np.abs(d)) / sqrt_r
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    J = [s * nx, s * ny, s * nz, s * (py * nz - pz * ny),
         s * (pz * nx - px * nz), s * (px * ny - py * nx)]
    e = s * d
    terms = [J[i] * J[j] for i in range(6) for j in range(i, 6)]
    terms += [J[i] * e for i in range(6)] + [np.ones_like(s)]
    valid = ok & (s > F(0.1))
    return np.where(valid[:, None], np.stack(terms, 1), F(0.0)).astype(F)


def _fixed_sum(v: np.ndarray) -> np.ndarray:
    """Sums over axis 0 of v (n, 28) in the kernels' order: lane l adds rows
    l, l + 32, ... in float64, then the warp's tree."""
    lanes = np.zeros((32, v.shape[1]))
    for m in range(0, len(v), 32):
        chunk = v[m:m + 32].astype(np.float64)
        lanes[:len(chunk)] += chunk
    for off in (16, 8, 4, 2, 1):
        lanes[:off] += lanes[off:2 * off]
    return lanes[0]


def _mirror(c, n, ok, p, sqrt_r, grid: int):
    """The K2 body's sums in numpy, in the stated order."""
    n_q = len(p)
    rows = _rows(c, n, ok, p, sqrt_r)
    n_thr = min((n_q + grid - 1) // grid, THREADS)
    part = np.zeros((grid, 28))
    for b in range(grid):
        qi = np.arange(b, n_q, grid)          # local queries j = 0, 1, ...
        acc = np.zeros((n_thr, 28), F)
        for m in range(0, len(qi), THREADS):  # thread t: j = t, t + T, ...
            take = qi[m:m + THREADS]
            acc[:len(take)] += rows[take]
        part[b] = _fixed_sum(acc)
    total = _fixed_sum(part).astype(F)
    iu = np.triu_indices(6)
    jtj = np.zeros((6, 6), F)
    jtj[iu] = total[:21]
    jtj.T[iu] = total[:21]
    return jtj, total[21:27], int(total[27])


@pytest.mark.parametrize("case", ["random", "all-masked"])
@pytest.mark.parametrize("n_q", QUERIES)
@pytest.mark.parametrize("grid", GRIDS)
def test_k2_body_matches_plain(grid, n_q, case):
    c, n, ok, p, sqrt_r = _planes(n_q, case)
    jtj, jte, nv = native.k2_host(c, n, ok, p, sqrt_r, grid)
    ref = lk.plane_normal_equations_plain(
        Planes(torch.tensor(c), torch.tensor(n), torch.tensor(ok)),
        torch.tensor(p), torch.tensor(sqrt_r))
    JtJ, JtE = ref[0].numpy(), ref[1].numpy()
    assert nv == int(ref[2])
    if case == "random" and n_q > 100:
        assert nv > 0.5 * n_q
    else:
        assert nv <= n_q
    np.testing.assert_allclose(jtj, JtJ, atol=2e-5 * np.abs(JtJ).max())
    np.testing.assert_allclose(jte, JtE, atol=5e-4 * np.abs(JtE).max())


@pytest.mark.parametrize("n_q", QUERIES)
@pytest.mark.parametrize("grid", GRIDS)
def test_k2_body_is_the_stated_order(grid, n_q):
    c, n, ok, p, sqrt_r = _planes(n_q, "random")
    got = native.k2_host(c, n, ok, p, sqrt_r, grid)
    want = _mirror(c, n, ok, p, sqrt_r, grid)
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  want[0].view(np.uint32))
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  want[1].view(np.uint32))
    assert got[2] == want[2]
    again = native.k2_host(c, n, ok, p, sqrt_r, grid)
    assert all(np.array_equal(a, b) for a, b in zip(got[:2], again[:2]))
    assert again[2] == got[2]


def test_k2_host_refuses_an_empty_grid():
    c, n, ok, p, sqrt_r = _planes(5, "random")
    with pytest.raises(ValueError, match="grid of 0"):
        native.k2_host(c, n, ok, p, sqrt_r, 0)
