"""Closed-form batched 3x3 symmetric eigensolve on torch tensors.

Port of ``simpleslam_tpu/ops/linalg3.py`` (``symeig3x3_values``,
``_eigvec_for``, ``symeig3x3_smallest``): the plane fit's per-query scatter
eigenproblem as elementwise math. The CUDA kernel ``fit_and_linearize_merged``
(``csrc/loam_kernels.cu``) computes the same formulas per query.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def symeig3x3_values(M: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3), ascending — trigonometric form."""
    m00, m11, m22 = M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]
    m01, m02, m12 = M[..., 0, 1], M[..., 0, 2], M[..., 1, 2]
    p1 = m01 * m01 + m02 * m02 + m12 * m12
    q = (m00 + m11 + m22) / 3.0
    p2 = (m00 - q) ** 2 + (m11 - q) ** 2 + (m22 - q) ** 2 + 2.0 * p1
    diag_case = p2 <= 1e-24
    p = torch.sqrt(torch.where(diag_case, torch.ones_like(p2), p2) / 6.0)
    # B = (M - qI)/p; r = det(B)/2
    b00, b11, b22 = (m00 - q) / p, (m11 - q) / p, (m22 - q) / p
    b01, b02, b12 = m01 / p, m02 / p, m12 / p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    lam = torch.stack([e_lo, e_mid, e_hi], dim=-1)
    return torch.where(diag_case[..., None], q[..., None].expand_as(lam), lam)


def _norm3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def _eigvec_for(M: torch.Tensor, lam_a: torch.Tensor,
                lam_b: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the remaining eigenvalue via the column space of
    (M - lam_a I)(M - lam_b I) (Eberly's method); the column of largest norm
    wins, first one on ties.

    The product is written out per component for symmetric M, exactly as the
    CUDA kernel computes it, so both round alike.
    """
    m00, m11, m22 = M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]
    m01, m02, m12 = M[..., 0, 1], M[..., 0, 2], M[..., 1, 2]
    a00, a11, a22 = m00 - lam_a, m11 - lam_a, m22 - lam_a
    c00, c11, c22 = m00 - lam_b, m11 - lam_b, m22 - lam_b
    p00 = a00 * c00 + m01 * m01 + m02 * m02
    p10 = m01 * c00 + a11 * m01 + m12 * m02
    p20 = m02 * c00 + m12 * m01 + a22 * m02
    p01 = a00 * m01 + m01 * c11 + m02 * m12
    p11 = m01 * m01 + a11 * c11 + m12 * m12
    p21 = m02 * m01 + m12 * c11 + a22 * m12
    p02 = a00 * m02 + m01 * m12 + m02 * c22
    p12 = m01 * m02 + a11 * m12 + m12 * c22
    p22 = m02 * m02 + m12 * m12 + a22 * c22
    n0, n1, n2 = _norm3(p00, p10, p20), _norm3(p01, p11, p21), \
        _norm3(p02, p12, p22)
    best0 = (n0 >= n1) & (n0 >= n2)
    best1 = ~best0 & (n1 >= n2)
    v = torch.stack([torch.where(best0, p00, torch.where(best1, p01, p02)),
                     torch.where(best0, p10, torch.where(best1, p11, p12)),
                     torch.where(best0, p20, torch.where(best1, p21, p22))],
                    dim=-1)
    vn = torch.clamp(_norm3(v[..., 0], v[..., 1], v[..., 2]), min=1e-20)
    return v / vn[..., None]


def symeig3x3_smallest(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending (..., 3), unit eigenvector of the smallest)."""
    lam = symeig3x3_values(M)
    return lam, _eigvec_for(M, lam[..., 1], lam[..., 2])
