"""The LOAM kernels' five-nearest-neighbour selection
(``simpleslam_tpu_torch/csrc/select5.h``), compiled for the host with one
warp's 32 lanes and their two reductions per round emulated
(``native.select5``), against the plain argmin rounds of
``ops/loam.py`` (``select_nearest``, the rounds of ``fit_planes_at``).

On the card each lane sorts its candidates by (d^2, index) once and a round
compares only the lanes' heads; the plain rounds rescan every candidate and
take the first index among the hits. The chosen indices (in index order,
absent ones last) and the gate must be the same exactly, on candidate sets
made from a numpy seed: random sets, sets heavy with ties (equal distances
on several lanes and within one lane), sets with fewer than five set
candidates, and 1, 7, 192, 216 and 256 candidates per query (6 and 8 slots a
lane).
"""

import numpy as np
import pytest
import torch

from simpleslam_tpu_torch import native
from simpleslam_tpu_torch.ops import loam as tloam

N_QUERIES = 64
CASES = ["random", "ties-across-lanes", "ties-within-a-lane", "few-set",
         "far"]
WIDTHS = [1, 7, 192, 216, 256]


def _candidates(case: str, n_cand: int):
    """(cand (Q, C, 3), ok (Q, C), queries (Q, 3), mask (Q,)) for a case."""
    rng = np.random.default_rng([CASES.index(case), n_cand])
    q = rng.uniform(-20, 20, (N_QUERIES, 3)).astype(np.float32)
    cand = q[:, None, :] + rng.uniform(-0.8, 0.8, (N_QUERIES, n_cand, 3))
    ok = rng.random((N_QUERIES, n_cand)) > 0.2
    mask = rng.random(N_QUERIES) > 0.1
    if case == "ties-across-lanes":
        # neighbouring candidates (lanes c and c + 1) at one point, and the
        # same point on several lanes at once
        src = rng.integers(0, n_cand, (N_QUERIES, n_cand // 3 + 1))
        dst = np.minimum(src + rng.integers(1, 4, src.shape), n_cand - 1)
        rows = np.arange(N_QUERIES)[:, None]
        cand[rows, dst] = cand[rows, src]
        ok[rows, dst] = True
    elif case == "ties-within-a-lane":
        # candidates c and c + 32 (one lane's slots j and j + 1) at one point
        c = rng.integers(0, max(n_cand - 32, 1), (N_QUERIES, n_cand // 4 + 1))
        d = np.minimum(c + 32, n_cand - 1)
        rows = np.arange(N_QUERIES)[:, None]
        cand[rows, d] = cand[rows, c]
        ok[rows, d] = True
    elif case == "few-set":
        ok[:] = False
        for i in range(N_QUERIES):
            k = rng.integers(0, min(5, n_cand + 1))
            ok[i, rng.choice(n_cand, size=min(k, n_cand), replace=False)] = True
    elif case == "far":
        # some queries with their fifth neighbour beyond the search radius
        cand = q[:, None, :] + rng.uniform(-1.3, 1.3, (N_QUERIES, n_cand, 3))
    # exact ties of distance, not only of points: mirror some candidates
    # through their query
    flip = rng.random((N_QUERIES, n_cand)) < 0.1
    cand = np.where(flip[..., None], 2 * q[:, None, :] - cand, cand)
    return cand.astype(np.float32), ok, q, mask


@pytest.mark.parametrize("n_cand", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_warp_selection_matches_argmin_rounds(case, n_cand):
    cand, ok, q, mask = _candidates(case, n_cand)
    sel, gate = native.select5(cand, ok, q, mask, tloam.MAX_SEARCH_SQ)
    want, want_gate = tloam.select_nearest(
        torch.tensor(q), torch.tensor(mask), torch.tensor(cand),
        torch.tensor(ok))
    want = want.numpy()
    want = np.where(want == n_cand, -1, want)   # absent: C there, -1 here
    np.testing.assert_array_equal(sel, want)
    np.testing.assert_array_equal(gate, want_gate.numpy())
    if case == "few-set":
        assert (sel == -1).any() and not gate.all()
    elif n_cand >= 32:
        assert gate.any()


def test_ties_are_taken_by_the_first_index():
    """All candidates of a query at one distance: the five lowest indices,
    whichever lanes and slots hold them."""
    n_cand = 216
    q = np.zeros((3, 3), np.float32)
    d = np.array([[0.3, 0.0, 0.0]], np.float32)
    cand = np.repeat(np.repeat(d[None], n_cand, axis=1), 3, axis=0)
    ok = np.ones((3, n_cand), bool)
    ok[1, :40] = False                       # the first 40 not set
    ok[2, ::2] = False                       # every other one
    sel, gate = native.select5(cand, ok, q, np.ones(3, bool))
    np.testing.assert_array_equal(sel[0], [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(sel[1], [40, 41, 42, 43, 44])
    np.testing.assert_array_equal(sel[2], [1, 3, 5, 7, 9])
    assert gate.all()


def test_more_candidates_than_a_warp_holds_is_refused():
    cand = np.zeros((1, 257, 3), np.float32)
    with pytest.raises(ValueError, match="257 candidates"):
        native.select5(cand, np.ones((1, 257), bool), np.zeros((1, 3)),
                       np.ones(1, bool))
