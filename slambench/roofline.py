"""The card's peaks and the work K3 (the persistent Gauss-Newton kernel)
needs, frozen here so that the yardstick never moves with the program.

Copied from ``chip_smoke.py``: ``bounds`` (the K3 row on the merged map,
the production target of the streamed executor) and the peaks beside it.
K3 reads the candidate row of every valid query once per K1 phase (a plane
refit; ``gn_gathers`` of them per registration) and the scan once; about
``24 * C + 520`` float operations per valid query per K1 phase, ``120`` per
query per K2 iteration and ``1500`` per small step.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def k3_work(n_q: int, n_valid: int, n_cand: int, gathers: float,
            iters: float):
    """(bytes, float operations) one K3 launch needs: ``n_q`` query slots
    (the scan capacity), ``n_valid`` of them valid, ``n_cand`` candidates
    in a merged row (8 voxels x the slab), ``gathers`` K1 phases in
    ``iters`` iterations."""
    row = n_cand * 3 * 2                       # int16 xyz per candidate
    k1_ops = n_valid * (24 * n_cand + 520)
    k2_ops = n_q * 120
    nbytes = gathers * n_valid * row + n_q * (12 + 1) + 64 + 80
    ops = gathers * k1_ops + (iters - gathers) * k2_ops + iters * 1500
    return nbytes, ops


def k3_bound_s(n_q: int, n_valid: int, n_cand: int, gathers: float,
               iters: float):
    """The least time the card could take for one K3 launch, and what sets
    it ("bytes" or "operations")."""
    nbytes, ops = k3_work(n_q, n_valid, n_cand, gathers, iters)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")
