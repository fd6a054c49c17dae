"""evo-style APE/RPE trajectory metrics with stamp association.

The reference evaluates TUM trajectories against RTK ground truth with evo
(``docs/imgs/perf.png`` APE/RPE tables; protocol: translation RMSE, Umeyama
alignment, no scale). This module is the standalone evaluator: it associates
two stamped trajectories by nearest timestamp (evo's association step — the
simulator-side metrics in ``pipeline/simulate.py`` assume index alignment),
computes APE/RPE statistics (rmse/mean/median/std/min/max like evo), and
powers the ``python -m simpleslam_tpu_torch.eval`` CLI.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class ErrorStats:
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float
    n: int

    @classmethod
    def from_errors(cls, e: np.ndarray) -> "ErrorStats":
        if len(e) == 0:
            return cls(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0)
        return cls(
            rmse=float(np.sqrt(np.mean(e ** 2))),
            mean=float(np.mean(e)),
            median=float(np.median(e)),
            std=float(np.std(e)),
            min=float(np.min(e)),
            max=float(np.max(e)),
            n=len(e),
        )

    def row(self) -> str:
        return (f"rmse {self.rmse:.3f}  mean {self.mean:.3f}  "
                f"median {self.median:.3f}  std {self.std:.3f}  "
                f"min {self.min:.3f}  max {self.max:.3f}  (n={self.n})")


def associate(ref_stamps: np.ndarray, est_stamps: np.ndarray,
              max_diff: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-stamp association: indices (into ref, into est) of pairs
    within ``max_diff`` seconds; each est stamp used at most once."""
    ref_stamps = np.asarray(ref_stamps)
    est_stamps = np.asarray(est_stamps)
    order = np.argsort(ref_stamps)
    ri, ei = [], []
    used = set()
    for i in order:
        j = int(np.argmin(np.abs(est_stamps - ref_stamps[i])))
        if j in used:
            continue
        if abs(est_stamps[j] - ref_stamps[i]) <= max_diff:
            ri.append(i)
            ei.append(j)
            used.add(j)
    return np.asarray(ri, np.int64), np.asarray(ei, np.int64)


def umeyama_align(src: np.ndarray, dst: np.ndarray,
                  with_scale: bool = False) -> np.ndarray:
    """SE(3) (optionally Sim(3)) alignment of src points onto dst."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    c = 1.0
    if with_scale:
        var_s = np.mean(np.sum((src - mu_s) ** 2, axis=1))
        c = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    return c * (src - mu_s) @ R.T + mu_d


def ape(gt_poses: np.ndarray, est_poses: np.ndarray,
        align: bool = True) -> ErrorStats:
    """Absolute (translation) pose error of associated pose arrays."""
    g = np.asarray(gt_poses)[:, :3, 3]
    e = np.asarray(est_poses)[:, :3, 3]
    if align and len(g) >= 3:
        e = umeyama_align(e, g)
    return ErrorStats.from_errors(np.linalg.norm(g - e, axis=1))


def rpe(gt_poses: np.ndarray, est_poses: np.ndarray,
        delta: int = 1) -> ErrorStats:
    """Relative (translation) pose error over ``delta``-frame increments."""
    errs = []
    for i in range(len(gt_poses) - delta):
        g_rel = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e_rel = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        d = np.linalg.inv(g_rel) @ e_rel
        errs.append(np.linalg.norm(d[:3, 3]))
    return ErrorStats.from_errors(np.asarray(errs))


def evaluate(gt_tum: str, est_tum: str, delta: int = 10,
             max_diff: float = 0.02, align: bool = True
             ) -> Tuple[ErrorStats, ErrorStats]:
    """Load two TUM files, associate by stamp, return (APE, RPE) stats."""
    from ..utils import fileio

    g_stamps, g_poses = fileio.load_tum(gt_tum)
    e_stamps, e_poses = fileio.load_tum(est_tum)
    ri, ei = associate(g_stamps, e_stamps, max_diff)
    if len(ri) < 2:
        raise ValueError(
            f"only {len(ri)} associated pose pairs (max_diff={max_diff})")
    return (ape(g_poses[ri], e_poses[ei], align=align),
            rpe(g_poses[ri], e_poses[ei], delta=delta))
