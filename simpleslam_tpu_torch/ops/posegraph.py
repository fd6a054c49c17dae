"""Batched SE(3) pose-graph solver (the GTSAM/iSAM2 role), on torch tensors.

Port of ``simpleslam_tpu/ops/posegraph.py`` for one device: the factor
graph is a padded edge tensor, residuals and Jacobians are one batched
forward-mode autodiff evaluation (``torch.func.vmap`` of ``jacfwd``), and
Levenberg-Marquardt steps solve ``(H + lambda D) dx = -g`` densely for
K <= DENSE_SOLVE_MAX_K nodes, else by block-Jacobi preconditioned conjugate
gradient on the block-sparse 6x6 form.

Conventions (as the reference package):
- twist ordering [rho (trans), w (rot)];
- right perturbation ``T_k <- T_k exp(xi_k)``, so the between-factor
  residual is ``r_e = log(Tij^-1 (T_i exp(xi_i))^-1 (T_j exp(xi_j)))``;
- ``edge_info`` is the diagonal information of each edge; padding edges
  carry zero info and a False mask;
- the gauge is fixed by a diagonal prior on node 0.

Fixed-order sums: the reference's three scatter-sums (gradient and block
diagonal per node, the matvec's off-diagonal terms, the dense H assembly)
are gathers through tables built once per solve from the graph topology —
each node's incident edge ends, each node pair's edges, in edge order —
followed by sums over the gathered axis. No float atomics, so a solve
repeats bit for bit on the GPU.

The reference's ``while_loop``s run a fixed number of iterations here with
the state frozen once the loop condition fails, so no host read decides
them: the iterates are those of the early-exit loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from . import geometry as geo


class PoseGraph(NamedTuple):
    """Padded pose-graph tensors (static shapes K, E)."""

    poses: torch.Tensor       # (K, 4, 4) current estimates
    kf_mask: torch.Tensor     # (K,) bool valid nodes
    edge_i: torch.Tensor      # (E,) int64 from-node
    edge_j: torch.Tensor      # (E,) int64 to-node
    edge_T: torch.Tensor      # (E, 4, 4) measured between T_i^-1 T_j
    edge_info: torch.Tensor   # (E, 6) diagonal information [trans, rot]
    edge_mask: torch.Tensor   # (E,) bool
    prior_pose: torch.Tensor  # (4, 4) prior on node 0
    prior_info: torch.Tensor  # (6,) diagonal information of the prior


class SolveResult(NamedTuple):
    poses: torch.Tensor     # (K, 4, 4) optimized
    cost0: torch.Tensor     # () initial chi2
    cost: torch.Tensor      # () final chi2
    iters: torch.Tensor     # () int32 LM iterations executed
    accepted: torch.Tensor  # () int32 accepted LM steps


def _edge_residual(xi_i, xi_j, Ti, Tj, Tij):
    """r = log(Tij^-1 (Ti exp(xi_i))^-1 (Tj exp(xi_j))), (..., 6)."""
    A = geo.pose_compose(Ti, geo.se3_exp(xi_i))
    B = geo.pose_compose(Tj, geo.se3_exp(xi_j))
    return geo.se3_log(
        geo.pose_compose(geo.pose_inverse(Tij),
                         geo.pose_compose(geo.pose_inverse(A), B)))


def _prior_residual(xi, T, Tp):
    """r = log(Tp^-1 (T exp(xi))), (..., 6)."""
    return geo.se3_log(
        geo.pose_compose(geo.pose_inverse(Tp),
                         geo.pose_compose(T, geo.se3_exp(xi))))


def _unit_batch(fn):
    """``fn`` on one element, evaluated with a leading batch axis of 1:
    functorch promotes a tangent to f64 when a 0-dim intermediate meets a
    Python scalar in ``clamp``, which a kept axis avoids."""
    def one(*args):
        return fn(*(a[None] for a in args))[0]
    return one


_edge_residual_1 = _unit_batch(_edge_residual)
_prior_residual_1 = _unit_batch(_prior_residual)


def _edge_jacobians(xi, Ti, Tj, Tij):
    """Per-edge (Ji, Jj) at xi: one vmapped jacfwd over the edge axis."""
    def one(Ti, Tj, Tij):
        Ji = jacfwd(_edge_residual_1, argnums=0)(xi, xi, Ti, Tj, Tij)
        Jj = jacfwd(_edge_residual_1, argnums=1)(xi, xi, Ti, Tj, Tij)
        return Ji, Jj
    return vmap(one)(Ti, Tj, Tij)


def _edge_residuals(g: PoseGraph) -> torch.Tensor:
    """(E, 6) residuals at xi = 0, padding edges zeroed."""
    Ti = g.poses[g.edge_i]
    Tj = g.poses[g.edge_j]
    z = torch.zeros((Ti.shape[0], 6), dtype=Ti.dtype, device=Ti.device)
    r = _edge_residual(z, z, Ti, Tj, g.edge_T)
    return torch.where(g.edge_mask[:, None], r, torch.zeros_like(r))


def _linearize_edges(g: PoseGraph):
    """Residuals + forward-mode Jacobians at xi = 0: (r (E, 6), Ji (E, 6, 6),
    Jj (E, 6, 6)) with padding edges zeroed."""
    Ti = g.poses[g.edge_i]
    Tj = g.poses[g.edge_j]
    z6 = torch.zeros(6, dtype=Ti.dtype, device=Ti.device)
    Ji, Jj = _edge_jacobians(z6, Ti, Tj, g.edge_T)
    m = g.edge_mask[:, None, None].to(Ji.dtype)
    return _edge_residuals(g), Ji * m, Jj * m


def _linearize_prior(g: PoseGraph):
    z6 = torch.zeros(6, dtype=g.poses.dtype, device=g.poses.device)
    r = _prior_residual(z6, g.poses[0], g.prior_pose)
    Jp = jacfwd(_prior_residual_1, argnums=0)(z6, g.poses[0], g.prior_pose)
    return r, Jp


def graph_cost(g: PoseGraph) -> torch.Tensor:
    """Total chi2 = sum_e r^T W r + prior (the GTSAM error function role)."""
    r = _edge_residuals(g)
    rp, _ = _linearize_prior(g)
    return torch.sum(r * r * g.edge_info) + torch.sum(rp * rp * g.prior_info)


class _Tables(NamedTuple):
    """Gather tables of one graph topology (built once per solve).

    node: (K, D) rows into the 2E+1 edge-end list [i-ends, j-ends, zero],
          each node's live ends in that order, padded with the zero row.
    pair_key: (U,) flat keys i*K + j of the node pairs with a live edge
          block, in either orientation; pair: (U, P) rows into the 2E+1
          block list [B_e, B_e^T, zero], in edge order, padded likewise.
    """

    node: torch.Tensor
    pair_key: torch.Tensor
    pair: torch.Tensor


def _group_table(keys: np.ndarray):
    """Rows of ``keys`` grouped by key value in ascending order, each group
    in index order, padded with -1: (unique keys, (U, D) table)."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    uniq, start, cnt = np.unique(ks, return_index=True, return_counts=True)
    table = np.full((len(uniq), max(int(cnt.max(initial=0)), 1)), -1,
                    np.int64)
    grp = np.repeat(np.arange(len(uniq)), cnt)
    rank = np.arange(len(ks)) - start[grp]
    table[grp, rank] = order
    return uniq, table


def _tables(g: PoseGraph) -> _Tables:
    """Topology tables from one host read of the edge indices and masks."""
    K = g.poses.shape[0]
    ei = g.edge_i.cpu().numpy().astype(np.int64)
    ej = g.edge_j.cpu().numpy().astype(np.int64)
    emask = g.edge_mask.cpu().numpy()
    kmask = g.kf_mask.cpu().numpy()
    E = len(ei)
    ends = np.concatenate([ei, ej])
    live = np.concatenate([emask, emask])
    sel = np.nonzero(live)[0]
    uniq, t = _group_table(ends[sel])
    node = np.full((K, t.shape[1]), 2 * E, np.int64)
    node[uniq] = np.where(t >= 0, sel[np.clip(t, 0, None)], 2 * E)
    # dense assembly: blocks of edges whose both nodes are live
    pl = emask & kmask[ei] & kmask[ej]
    keys = np.concatenate([ei * K + ej, ej * K + ei])
    sel = np.nonzero(np.concatenate([pl, pl]))[0]
    pair_key, t = _group_table(keys[sel])
    pair = np.where(t >= 0, sel[np.clip(t, 0, None)], 2 * E)
    dev = g.poses.device
    return _Tables(torch.from_numpy(node).to(dev),
                   torch.from_numpy(pair_key).to(dev),
                   torch.from_numpy(pair).to(dev))


def _node_sum(tab: _Tables, at_i: torch.Tensor, at_j: torch.Tensor):
    """Per-node sum of edge-end values (E, ...) at i and at j -> (K, ...)."""
    zero = torch.zeros_like(at_i[:1])
    return torch.cat([at_i, at_j, zero])[tab.node].sum(dim=1)


class _Lin(NamedTuple):
    """Block-sparse normal equations at one linearization point."""

    cost: torch.Tensor   # () total chi2 (edges + prior)
    grad: torch.Tensor   # (K, 6) J^T W r (incl. prior)
    diag: torch.Tensor   # (K, 6, 6) block diagonal of H (incl. prior)
    bij: torch.Tensor    # (E, 6, 6) off-diagonal blocks H[i, j]
    ei: torch.Tensor     # (E,)
    ej: torch.Tensor     # (E,)


def _linearize_full(g: PoseGraph, poses: torch.Tensor, tab: _Tables) -> _Lin:
    """Linearize + assemble the block-sparse normal equations (single
    device; the prior is added to node 0 after the edge sums)."""
    gg = g._replace(poses=poses)
    r, Ji, Jj = _linearize_edges(gg)
    rp, Jp = _linearize_prior(gg)
    wi = Ji * gg.edge_info[:, :, None]              # W Ji (rows weighted)
    wj = Jj * gg.edge_info[:, :, None]
    bii = torch.einsum("eab,eac->ebc", wi, Ji)      # Ji^T W Ji
    bjj = torch.einsum("eab,eac->ebc", wj, Jj)
    bij = torch.einsum("eab,eac->ebc", wi, Jj)      # Ji^T W Jj = H[i, j]
    gi = torch.einsum("eab,ea->eb", wi, r)
    gj = torch.einsum("eab,ea->eb", wj, r)
    chi2 = torch.sum(r * r * gg.edge_info, dim=1)
    grad = _node_sum(tab, gi, gj)
    diag = _node_sum(tab, bii, bjj)
    wp = Jp * g.prior_info[:, None]
    grad = torch.cat([grad[:1] + torch.einsum("ab,a->b", wp, rp), grad[1:]])
    diag = torch.cat([diag[:1] + torch.einsum("ab,ac->bc", wp, Jp)[None],
                      diag[1:]])
    cost = torch.sum(chi2) + torch.sum(rp * rp * g.prior_info)
    return _Lin(cost, grad, diag, bij, gg.edge_i, gg.edge_j)


def _make_hvp(lin: _Lin, lam: torch.Tensor, tab: _Tables):
    """(H + lambda diag(H)) v from the block-sparse form: the off-diagonal
    blocks contribute H[i,j] v_j at i and H[i,j]^T v_i at j."""
    damp = lam * torch.diagonal(lin.diag, dim1=-2, dim2=-1)   # (K, 6)
    damp = torch.maximum(damp, lam * 1e-6)

    def hvp(v):  # v: (K, 6)
        ui = torch.einsum("eab,eb->ea", lin.bij, v[lin.ej])  # at i
        uj = torch.einsum("eab,ea->eb", lin.bij, v[lin.ei])  # at j (B^T v_i)
        out = torch.einsum("kab,kb->ka", lin.diag, v) + _node_sum(tab, ui, uj)
        return out + damp * v

    return hvp


# Largest node count solved densely: H is (6K, 6K), a 9.4 MB matrix at
# K = 512; above it dense memory grows O(K^2) and PCG takes over.
DENSE_SOLVE_MAX_K = 512


def _dense_lm_solve(lin: _Lin, damped_diag, grad, mask, tab: _Tables):
    """One damped-normal-equation solve via a dense (6K, 6K) system.

    Masked nodes get identity rows and zero rhs (their update is 0); blocks
    of edges touching a masked node are left out, as in the reference.
    """
    K = grad.shape[0]
    eye6 = torch.eye(6, dtype=damped_diag.dtype, device=damped_diag.device)
    diag_blocks = torch.where(mask[:, None, None], damped_diag, eye6)
    blocks = torch.cat([lin.bij, lin.bij.transpose(-1, -2),
                        torch.zeros_like(lin.bij[:1])])
    H4 = torch.zeros((K * K, 6, 6), dtype=grad.dtype, device=grad.device)
    H4[tab.pair_key] = blocks[tab.pair].sum(dim=1)
    idx = torch.arange(K, device=grad.device) * (K + 1)
    H4[idx] = H4[idx] + diag_blocks
    H = H4.reshape(K, K, 6, 6).transpose(1, 2).reshape(K * 6, K * 6)
    m = mask[:, None].to(grad.dtype)
    b = (-grad * m).reshape(K * 6)
    dx = torch.linalg.solve(H, b).reshape(K, 6)
    return dx * m


def _pcg(hvp, b, precond_inv, mask, iters: int, tol: float = 1e-8,
         rel_tol: float = 1e-2):
    """Block-Jacobi preconditioned CG on H dx = b (masked nodes pinned to 0),
    stopping once ``rz < max(rel_tol^2 * rz_initial, tol)`` or after
    ``iters`` steps: every step runs, and the state freezes at the stop."""
    m = mask[:, None].to(b.dtype)

    def apply_p(r):
        return torch.einsum("kab,kb->ka", precond_inv, r) * m

    x = torch.zeros_like(b)
    r = b * m
    z = apply_p(r)
    p = z
    rz = torch.sum(r * z)
    floor = torch.clamp(rel_tol * rel_tol * rz, min=tol)
    for _ in range(iters):
        active = rz > floor
        Hp = hvp(p) * m
        alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-30)
        x1 = x + alpha * p
        r1 = r - alpha * Hp
        z1 = apply_p(r1)
        rz1 = torch.sum(r1 * z1)
        p1 = z1 + rz1 / torch.clamp(rz, min=1e-30) * p
        x = torch.where(active, x1, x)
        r = torch.where(active, r1, r)
        z = torch.where(active, z1, z)
        p = torch.where(active, p1, p)
        rz = torch.where(active, rz1, rz)
    return x


def solve_impl(g: PoseGraph, max_iters: int = 10, cg_iters: int = 64,
               lambda0: float = 1e-4) -> SolveResult:
    """Levenberg-Marquardt with dense or PCG inner solves.

    Per LM iteration: solve the damped normal equations of the carried
    linearization, apply ``T_k exp(dx_k)``, linearize at the trial and
    accept iff chi2 drops (lambda /= 4, keep the trial's linearization)
    else reject (lambda *= 8). The loop runs while ``lambda < 1e5``.
    """
    K = g.poses.shape[0]
    dt, dev = g.poses.dtype, g.poses.device
    tab = _tables(g)
    eye = torch.eye(6, dtype=dt, device=dev).expand(K, 6, 6)
    lin0 = _linearize_full(g, g.poses, tab)
    use_dense = K <= DENSE_SOLVE_MAX_K

    poses, lin = g.poses, lin0
    lam = torch.tensor(lambda0, dtype=dt, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        active = lam < 1e5
        damped_diag = lin.diag + lam * (lin.diag * eye) + 1e-8 * eye
        if use_dense:
            dx = _dense_lm_solve(lin, damped_diag, lin.grad, g.kf_mask, tab)
        else:
            hvp = _make_hvp(lin, lam, tab)
            dx = _pcg(hvp, -lin.grad, torch.linalg.inv(damped_diag),
                      g.kf_mask, cg_iters)
        trial = geo.reorthonormalize(
            geo.pose_compose(poses, geo.se3_exp(dx)))
        trial = torch.where(g.kf_mask[:, None, None], trial, poses)
        lin_t = _linearize_full(g, trial, tab)
        accept = active & (lin_t.cost < lin.cost)
        poses = torch.where(accept, trial, poses)
        lin = _Lin(*(torch.where(accept, new, old)
                     for new, old in zip(lin_t, lin)))
        lam_next = torch.clamp(torch.where(accept, lam * 0.25, lam * 8.0),
                               1e-9, 1e6)
        lam = torch.where(active, lam_next, lam)
        it = it + active.to(torch.int32)
        accepted = accepted + accept.to(torch.int32)
    return SolveResult(poses, lin0.cost, lin.cost, it, accepted)


def solve(g: PoseGraph, max_iters: int = 10, cg_iters: int = 64,
          lambda0: float = 1e-4) -> SolveResult:
    """Single-device LM solve (see ``solve_impl``)."""
    return solve_impl(g, max_iters, cg_iters, lambda0)
