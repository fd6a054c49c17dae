"""Edge-sharded pose-graph solve over the ranks of a mesh axis.

Port of ``simpleslam_tpu/parallel/dist_posegraph.py``: the O(E) work (per
edge residuals, autodiff Jacobians, 6x6 block products, the matvec's edge
terms) is split into one contiguous block of edges per rank; the O(K) state
(poses, CG vectors, the block-Jacobi preconditioner) is replicated. Edges,
not keyframes, are partitioned, so the gather ``v[edge_i]`` stays local and
no halo exchange is needed. The three distribution modes are those of
``ops.posegraph.solve_impl``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import geometry as geo
from ..ops import posegraph as pgo
from .mesh import Mesh


def shard_graph(mesh: Mesh, g: pgo.PoseGraph, axis: str = "kf") -> pgo.PoseGraph:
    """This rank's share of a graph that every rank built in full, on the
    mesh's device (``multihost.make_global_array``): its contiguous block
    of the edge rows (E must divide by the axis size), poses and prior in
    full."""
    from .multihost import make_global_array

    return pgo.PoseGraph(*(
        make_global_array(t.cpu().numpy(), mesh,
                          axis if f.startswith("edge_") else None)
        for f, t in zip(pgo.PoseGraph._fields, g)))


def sharded_solve(mesh: Mesh, axis: str = "kf", max_iters: int = 10,
                  cg_iters: int = 64, shard_cg: bool = False,
                  shard_lin: bool = False):
    """PoseGraph (this rank's edge block, ``shard_graph``) -> SolveResult,
    replicated on every rank. ``shard_cg`` selects the mode whose CG matvec
    and preconditioner shard too, ``shard_lin`` the one whose whole
    linearization shards behind one gather per LM iteration with CG
    replicated; neither is the replicated-CG mode (one gather per
    linearization, CG with no collective)."""
    ax = mesh.axis(axis)

    def fn(g: pgo.PoseGraph) -> pgo.SolveResult:
        return pgo.solve_impl(g, max_iters=max_iters, cg_iters=cg_iters,
                              axis=ax, shard_cg=shard_cg,
                              shard_lin=shard_lin)

    return fn


def _ring_graph(k: int, k_cap: int, e_cap: int, drift: float = 0.05,
                seed: int = 0, n_lc: int = 0, return_gt: bool = False,
                device: Optional[torch.device] = None):
    """Synthetic loop graph (a circle plus ``n_lc`` closures between
    diametrically opposed nodes) for dry runs and scaling tests, the same
    numbers as the reference package's: built in numpy with one batched
    ``se3_exp`` of the drift noise, then composed on the host."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, k, endpoint=False)
    gt = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    gt[:, 0, 3] = 10.0 * np.cos(th)
    gt[:, 1, 3] = 10.0 * np.sin(th)
    c, s = np.cos(th + np.pi / 2), np.sin(th + np.pi / 2)
    gt[:, 0, 0], gt[:, 0, 1], gt[:, 1, 0], gt[:, 1, 1] = c, -s, s, c
    gt_inv = np.linalg.inv(gt)

    n_e = k + n_lc
    assert n_e <= e_cap, (n_e, e_cap)
    ei = np.zeros(e_cap, np.int64)
    ej = np.zeros(e_cap, np.int64)
    eT = np.tile(np.eye(4, dtype=np.float32), (e_cap, 1, 1))
    einfo = np.zeros((e_cap, 6), np.float32)
    nxt = (np.arange(k) + 1) % k
    ei[:k] = np.arange(k)
    ej[:k] = nxt
    eT[:k] = np.einsum("kij,kjl->kil", gt_inv, gt[nxt]).astype(np.float32)
    einfo[:k] = [10.0, 10.0, 10.0, 1e4, 1e4, 1e4]
    if n_lc:
        a = rng.integers(0, k, n_lc)
        b = (a + k // 2) % k
        ei[k:n_e] = a
        ej[k:n_e] = b
        eT[k:n_e] = np.einsum("kij,kjl->kil", gt_inv[a],
                              gt[b]).astype(np.float32)
        einfo[k:n_e] = [10.0, 10.0, 10.0, 1e4, 1e4, 1e4]
    emask = np.arange(e_cap) < n_e

    tw = (rng.normal(0, drift, (k - 1, 6)) * [1, 1, 1, .2, .2, .2]
          ).astype(np.float32)
    noises = geo.se3_exp(torch.from_numpy(tw)).numpy()
    init = np.tile(np.eye(4, dtype=np.float32), (k_cap, 1, 1))
    init[0] = gt[0]
    for a in range(k - 1):
        init[a + 1] = init[a] @ eT[a] @ noises[a]
    kmask = np.arange(k_cap) < k

    dev = device or torch.device("cpu")

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    g = pgo.PoseGraph(
        poses=t(init), kf_mask=t(kmask), edge_i=t(ei), edge_j=t(ej),
        edge_T=t(eT), edge_info=t(einfo), edge_mask=t(emask),
        prior_pose=t(gt[0]),
        prior_info=t(np.full(6, 1e4, np.float32)))
    return (g, gt) if return_gt else g


def dryrun(mesh: Mesh, axis: Optional[str] = None) -> None:
    """Run the sharded solve on a small ring graph in all three modes
    (replicated CG, sharded CG, sharded linearization) and assert a finite
    cost that does not rise."""
    if axis is None:
        axis = next(iter(mesh.shape))
    n = mesh.axis(axis).size
    k_cap = ((32 + n - 1) // n) * n   # K divides by the ranks (sharded CG)
    g = shard_graph(mesh, _ring_graph(k=24, k_cap=k_cap,
                                      e_cap=((64 + n - 1) // n) * n), axis)
    for kw in ({}, {"shard_cg": True}, {"shard_lin": True}):
        res = sharded_solve(mesh, axis=axis, max_iters=4, cg_iters=16,
                            **kw)(g)
        cost, cost0 = float(res.cost), float(res.cost0)
        assert np.isfinite(cost), f"sharded solve: non-finite cost ({kw})"
        assert cost <= cost0, f"sharded solve did not reduce cost ({kw})"
