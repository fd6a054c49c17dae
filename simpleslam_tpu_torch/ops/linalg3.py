"""Closed-form batched 3x3 symmetric eigensolve on torch tensors.

Port of ``simpleslam_tpu/ops/linalg3.py``: the plane fit's per-query
scatter eigenproblem (``symeig3x3_smallest``), the full eigendecomposition
behind VGICP's covariance regularization (``symeig3x3``) and Cramer's-rule
solves, all as elementwise math. The CUDA kernel ``fit_and_linearize_merged``
(``csrc/loam_kernels.cu``) computes the plane-fit formulas per query.
"""

from __future__ import annotations

import math
import operator
from typing import Callable, Tuple

import torch


def div_const(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` as a true division on every device. PyTorch's CUDA
    division by a Python number multiplies by its reciprocal instead, which
    rounds apart from the CPU's division and from the CUDA kernels' (x / 3
    and x * (1 / 3) differ in the last bit for about half of all x); a
    0-dim tensor filled on the device, on the caller's stream, divides.
    The LOAM plane fit's plain version uses it, to round as its kernels do."""
    return x / torch.full((), float(value), dtype=x.dtype, device=x.device)


def solve3x3(A: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Cramer's-rule solve. Returns (x, ok) — ok flags a usable det.

    Only appropriate for well-scaled matrices (f32 determinant).
    """
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    scale = torch.amax(torch.abs(A), dim=(-1, -2))
    ok = torch.abs(det) > 1e-7 * torch.clamp(scale, min=1e-12) ** 3
    det_safe = torch.where(ok, det, torch.ones_like(det))
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    x0 = (c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2]) / det_safe
    x1 = (c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2]) / det_safe
    x2 = (c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]) / det_safe
    return torch.stack([x0, x1, x2], dim=-1), ok


def symeig3x3_values(M: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3), ascending — trigonometric form."""
    return _symeig3x3_values(M, operator.truediv)


def _symeig3x3_values(M: torch.Tensor, div: Callable) -> torch.Tensor:
    """``symeig3x3_values`` with its divisions by constants done by ``div``."""
    m00, m11, m22 = M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]
    m01, m02, m12 = M[..., 0, 1], M[..., 0, 2], M[..., 1, 2]
    p1 = m01 * m01 + m02 * m02 + m12 * m12
    q = div(m00 + m11 + m22, 3.0)
    p2 = (m00 - q) ** 2 + (m11 - q) ** 2 + (m22 - q) ** 2 + 2.0 * p1
    diag_case = p2 <= 1e-24
    p = torch.sqrt(div(torch.where(diag_case, torch.ones_like(p2), p2), 6.0))
    # B = (M - qI)/p; r = det(B)/2
    b00, b11, b22 = (m00 - q) / p, (m11 - q) / p, (m22 - q) / p
    b01, b02, b12 = m01 / p, m02 / p, m12 / p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(div(detB, 2.0), -1.0, 1.0)
    phi = div(torch.arccos(r), 3.0)
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
    """(eigenvalues ascending (..., 3), unit eigenvector of the smallest);
    the LOAM plane fit's, so its constant divisions are ``div_const``'s."""
    lam = _symeig3x3_values(M, div_const)
    return lam, _eigvec_for(M, lam[..., 1], lam[..., 2])


def symeig3x3(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full symmetric eigendecomposition: (eigenvalues ascending, eigenvectors
    (..., 3, 3) with matching columns). Assumes reasonably separated
    spectra; a degenerate second vector is replaced by one orthogonal to the
    first, as in the reference."""
    lam = symeig3x3_values(M)
    v0 = _eigvec_for(M, lam[..., 1], lam[..., 2])
    v2 = _eigvec_for(M, lam[..., 0], lam[..., 1])
    v2 = v2 - torch.sum(v2 * v0, dim=-1, keepdim=True) * v0
    n2 = torch.linalg.norm(v2, dim=-1, keepdim=True)
    # unit vectors made on the device (a host list would be a blocking copy)
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    ex, ey = eye[0].expand_as(v0), eye[1].expand_as(v0)
    alt = torch.linalg.cross(v0, ex)
    alt = torch.where(torch.linalg.norm(alt, dim=-1, keepdim=True) > 0.1, alt,
                      torch.linalg.cross(v0, ey))
    alt = alt / torch.clamp(torch.linalg.norm(alt, dim=-1, keepdim=True),
                            min=1e-20)
    v2 = torch.where(n2 > 1e-6, v2 / torch.clamp(n2, min=1e-20), alt)
    v1 = torch.linalg.cross(v2, v0)
    return lam, torch.stack([v0, v1, v2], dim=-1)
