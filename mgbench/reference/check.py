"""The comparison of the answers that decides `correct`, for every kind
of operator: the reference's own float64 residual of each column.  (The
check of the set-up's level operators is the operator kind's
`level_errors`, in reference/<kind>.py.)  The limits live in the
configuration file (`checks`), set from the readings PERF.md gives.
"""
from __future__ import annotations

import numpy as np
import torch


def relres(op, b: torch.Tensor, x: torch.Tensor) -> np.ndarray:
    """||b - A x|| / ||b|| of each column, A the reference's operator in
    float64 (b, x flat (n,) or (n, m))."""
    b64 = b.to(op.device, torch.float64).reshape(op.n, -1)
    x64 = x.to(op.device, torch.float64).reshape(op.n, -1)
    r = b64 - op.apply(x64)
    num = torch.linalg.vector_norm(r, dim=0)
    den = torch.linalg.vector_norm(b64, dim=0)
    return (num / den).cpu().numpy()
