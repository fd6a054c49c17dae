"""NDT helpers on torch tensors.

Only ``solve3x3_batch`` of ``simpleslam_tpu/ops/ndt.py`` is ported so far:
VGICP (loop-closure verification) inverts its per-point combined
covariances with it. NDT registration itself is ROADMAP item 10.
"""

from __future__ import annotations

import torch

from .linalg3 import solve3x3


def solve3x3_batch(A: torch.Tensor):
    """Batched 3x3 inverse via Cramer on well-conditioned (floored)
    matrices: (inverse (..., 3, 3), ok (...))."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    cols, oks = [], []
    for k in range(3):
        x, ok = solve3x3(A, eye[..., k])
        cols.append(x)
        oks.append(ok)
    return torch.stack(cols, dim=-1), oks[0] & oks[1] & oks[2]
