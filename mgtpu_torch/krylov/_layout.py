"""Operand layout of the port's Krylov methods: leading batch.

Operands are (m, *space) fields with the right-hand sides first — the grid
engine's (m, *grid) layout (mgtpu/krylov/_layout.py's ``batch_leading``
form; the port has no flat column layout).  Per-RHS scalars (alpha, beta,
rho, residual norms) are (m,) tensors.

On the multi-device tier each rank holds one block of the space: `reduce`
(a RankGrid's `psum`) sums every inner product, Gram block and squared
norm over the ranks before it is used, so that every rank takes the same
scalars and the same branch of every stop test.  Without it the code is
the single-device one.
"""
from __future__ import annotations

import torch


class Layout:
    """dot / norm / scale over the spatial axes of (m, *space) operands,
    and the block (shared-Krylov-space) primitives."""

    def __init__(self, B: torch.Tensor, reduce=None):
        self.nbatch = B.shape[0]
        self.reduce = reduce
        self._axes = tuple(range(1, B.ndim))
        self._expand = (slice(None),) + (None,) * (B.ndim - 1)

    def dot(self, a, b):
        """Per-RHS inner product <a, b> -> (m,)."""
        return self.sum(torch.sum(a.conj() * b, dim=self._axes))

    def norm(self, a):
        """Per-RHS 2-norm -> (m,) real (the squares summed over the ranks
        before the root)."""
        return torch.sqrt(self.sum(torch.sum((a.conj() * a).real,
                                             dim=self._axes)))

    def sum(self, s):
        """s summed over the ranks (s itself on one device)."""
        return s if self.reduce is None else self.reduce(s)

    def scale(self, v, s):
        """v * s with s (m,) broadcast over the spatial axes."""
        return v * s[self._expand]

    def gram(self, a, b):
        """Block inner product a^H b -> (m, m)."""
        af = a.reshape(self.nbatch, -1)
        bf = b.reshape(self.nbatch, -1)
        return self.sum(af.conj() @ bf.T)

    def mix(self, v, S):
        """Column mixing: sum_i v_i S[i, j] -> j-th output RHS."""
        return (S.T @ v.reshape(self.nbatch, -1)).reshape(v.shape)


def safe_div(num, den):
    """num / den with a zero denominator replaced by one."""
    return num / torch.where(den == 0, torch.ones_like(den), den)
