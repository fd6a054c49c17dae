"""ScanContext place-recognition descriptor as tensor code.

Port of ``simpleslam_tpu/ops/scancontext.py`` (reference
``backend/src/ScanContext.cpp:56-278``): the polar BEV max-height descriptor
is one scatter-max, ring-key retrieval is a brute-force distance plus the
``num_candidates`` nearest keys, and the circular-shift alignment is a
cosine column distance evaluated for all 60 shifts at once.

Ties resolve as in the reference package: candidates by ascending key
distance then lower index (a stable sort), the best shift and the best
candidate at their first minimum. ``torch.argmin`` does not promise the
first index on CUDA, so those picks are written out.

Constants (ScanContext.hpp:17-19): 20 rings x 60 sectors, 80 m radius.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

NUM_RING = 20
NUM_SECTOR = 60
MAX_RADIUS = 80.0
SECTOR_ANGLE_RAD = 2.0 * math.pi / NUM_SECTOR


def make_descriptor(xyz: torch.Tensor, mask: torch.Tensor,
                    lidar_height: float = 2.0) -> torch.Tensor:
    """(N, 3) sensor-frame points -> (20, 60) polar max-height descriptor.

    z is shifted by the lidar height, range > 80 m is dropped, bin indices
    are ``clamp(ceil(frac * bins), 1, bins) - 1``, empty bins are 0. The
    scatter-max does not depend on order, so descriptors repeat exactly.
    """
    x, y = xyz[:, 0], xyz[:, 1]
    z = xyz[:, 2] + lidar_height
    rng = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x)                       # xy2theta: [0, 2pi)
    theta = torch.where(theta < 0, theta + 2 * math.pi, theta)

    valid = mask & (rng <= MAX_RADIUS)
    ring = torch.clamp(torch.ceil(rng / MAX_RADIUS * NUM_RING), 1, NUM_RING) - 1
    sector = torch.clamp(torch.ceil(theta / (2 * math.pi) * NUM_SECTOR), 1,
                         NUM_SECTOR) - 1
    flat = (ring * NUM_SECTOR + sector).to(torch.int64)
    n_cell = NUM_RING * NUM_SECTOR
    flat = torch.where(valid, flat, torch.full_like(flat, n_cell))
    zv = torch.where(valid, z, torch.full_like(z, float("-inf")))
    desc = torch.full((n_cell + 1,), float("-inf"), dtype=xyz.dtype,
                      device=xyz.device)
    desc = desc.scatter_reduce(0, flat, zv, "amax")[:n_cell]
    desc = torch.where(torch.isfinite(desc), desc, torch.zeros_like(desc))
    return desc.reshape(NUM_RING, NUM_SECTOR)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Row-wise means, the rotation-invariant retrieval key (..., 20)."""
    return torch.mean(desc, dim=-1)


def sector_key(desc: torch.Tensor) -> torch.Tensor:
    """Column-wise means (API parity; retrieval evaluates every shift)."""
    return torch.mean(desc, dim=-2)


def _first_argmin(d: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last axis."""
    n = d.shape[-1]
    iota = torch.arange(n, device=d.device)
    hit = d == torch.amin(d, dim=-1, keepdim=True)
    return torch.amin(torch.where(hit, iota, torch.full_like(iota, n)), dim=-1)


def _all_shift_distances(sc1: torch.Tensor, sc2: torch.Tensor) -> torch.Tensor:
    """Cosine column distance of sc1 vs every circular shift of sc2 (..., 20,
    60) -> (..., 60) (``computeSimularity``, ScanContext.cpp:69-93): columns
    where either side is all zero are left out; distance = 1 - mean
    similarity."""
    cols = torch.arange(NUM_SECTOR, device=sc1.device)
    idx = (cols[None, :] - cols[:, None]) % NUM_SECTOR   # shift s, column c
    sc2_sh = sc2[..., idx].transpose(-3, -2)             # (..., 60s, 20, 60c)
    dots = torch.einsum("rc,...src->...sc", sc1, sc2_sh)
    n1 = torch.linalg.norm(sc1, dim=0)                   # (60,)
    n2 = torch.linalg.norm(sc2_sh, dim=-2)               # (..., 60s, 60c)
    eff = (n1 > 0) & (n2 > 0)
    sim = torch.where(eff, dots / torch.clamp(n1 * n2, min=1e-12),
                      torch.zeros_like(dots))
    cnt = torch.clamp(torch.sum(eff, dim=-1), min=1)
    return 1.0 - torch.sum(sim, dim=-1) / cnt


def distance_between(sc1: torch.Tensor, sc2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min distance, argmin shift) over all 60 shifts."""
    d = _all_shift_distances(sc1, sc2)
    a = _first_argmin(d)
    return d[a], a


class QueryResult(NamedTuple):
    idx: torch.Tensor       # () int32, matched context id or -1
    yaw: torch.Tensor       # () f32, yaw offset in rad (sector angle * shift)
    min_dist: torch.Tensor  # () f32


def query(descs: torch.Tensor, ring_keys: torch.Tensor, qid: int,
          num_exclude_recent: int, dist_thres: float,
          num_candidates: int = 10) -> QueryResult:
    """Match context ``qid`` against contexts ``[0, qid - num_exclude_recent)``
    (``ScanContext::query``, ScanContext.cpp:228-278) with a brute-force
    ring-key search. Eligible once ``qid > num_exclude_recent +
    num_candidates``."""
    ncap = descs.shape[0]
    q_ring = ring_keys[qid]
    allowed = torch.arange(ncap, device=descs.device) < qid - num_exclude_recent
    d2 = torch.sum((ring_keys - q_ring[None, :]) ** 2, dim=-1)
    d2 = torch.where(allowed, d2, torch.full_like(d2, float("inf")))
    d2_sorted, order = torch.sort(d2, stable=True)
    cand = order[:num_candidates]
    cand_ok = torch.isfinite(d2_sorted[:num_candidates])
    q_desc = descs[qid]
    dists = _all_shift_distances(q_desc, descs[cand])    # (C, 60)
    shifts = _first_argmin(dists)
    dists = torch.gather(dists, 1, shifts[:, None])[:, 0]
    dists = torch.where(cand_ok, dists, torch.full_like(dists, float("inf")))
    best = _first_argmin(dists)
    min_dist = dists[best]
    ok = (min_dist < dist_thres) & (qid > num_exclude_recent + num_candidates)
    idx = torch.where(ok, cand[best], torch.full_like(cand[best], -1))
    yaw = torch.where(ok, SECTOR_ANGLE_RAD * shifts[best].to(torch.float32),
                      torch.zeros_like(min_dist))
    return QueryResult(idx.to(torch.int32), yaw, min_dist)
