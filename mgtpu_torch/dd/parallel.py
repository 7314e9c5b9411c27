"""Multi-device overlapping Schwarz over the ranks of a torch.distributed
group (mgtpu/dd/parallel.py).

The subdomains are regrouped colour-major as (ncolors, L, ...) with L
padded to a multiple of the rank count (identity factors, zero masks), and
each rank factors nothing new: it keeps its L / P slice of every colour of
the serial state (dd/schwarz.py's batched LU).  A sweep solves each
colour's domains of the rank with the serial `block_solve`, scatters the
corrections into a zero field and sums that field over the ranks (`psum`):
corrections within a colour are disjoint, so the sum adds one correction a
node.  x and b are replicated on every rank, as in mgtpu.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.comm import rank_device
from .schwarz import DDSolver, block_solve

__all__ = ["ShardedSchwarz", "build_sharded_schwarz", "shard_schwarz",
           "sharded_sweep", "dd_parallel_preconditioner"]


@dataclass(frozen=True, eq=False)
class ShardedSchwarz:
    """This rank's slice of the colour-major domain batch: arrays are
    (ncolors, L / P, ...)."""
    idx: torch.Tensor        # (ncolors, Lr, k) int64
    mask: torch.Tensor       # (ncolors, Lr, k)
    rows_idx: torch.Tensor   # (ncolors, Lr, k, K)
    rows_val: torch.Tensor
    lu: torch.Tensor         # (ncolors, Lr, k, k)
    piv: torch.Tensor        # (ncolors, Lr, k) 1-based int32 pivots
    perm: torch.Tensor       # (ncolors, Lr, k) the pivots' row order
    iperm: torch.Tensor      # and its inverse
    ncolors: int


def shard_schwarz(arrays, ncolors: int, num_ranks: int, rank: int,
                  device) -> ShardedSchwarz:
    """Rank `rank`'s slice of colour-major, padded host arrays (idx, mask,
    rows_idx, rows_val, lu, piv 1-based, perm, iperm; each (ncolors, L,
    ...), L a multiple of num_ranks)."""
    L = np.asarray(arrays[0]).shape[1]
    if L % num_ranks:
        raise ValueError(f"{L} domains a colour do not split over "
                         f"{num_ranks} ranks")
    s = L // num_ranks
    sl = slice(rank * s, (rank + 1) * s)
    out = [torch.tensor(np.ascontiguousarray(np.asarray(a)[:, sl]),
                        device=device) for a in arrays]
    return ShardedSchwarz(*out, ncolors)


def build_sharded_schwarz(dd: DDSolver, num_ranks: int, rank: int,
                          device=None) -> ShardedSchwarz:
    """Regroup a set-up DDSolver's state colour-major, pad each colour to a
    multiple of `num_ranks` domains and keep rank `rank`'s slice, on
    `device` (default the rank's card)."""
    st = dd.state
    groups = st.colors
    ncolors = len(groups)
    L = max(len(g) for g in groups)
    L = int(-(-L // num_ranks) * num_ranks)
    host = lambda t: t.detach().cpu().numpy()

    def pad_gather(a, pad):
        a = host(a)
        out = np.empty((ncolors, L) + a.shape[1:], dtype=a.dtype)
        out[:] = pad
        for c, g in enumerate(groups):
            out[c, :len(g)] = a[list(g)]
        return out

    k = st.idx.shape[1]
    eye = np.eye(k)
    ar = np.arange(k)
    arrays = (pad_gather(st.idx, 0), pad_gather(st.mask, 0),
              pad_gather(st.rows_idx, 0), pad_gather(st.rows_val, 0),
              pad_gather(st.lu, eye), pad_gather(st.piv, ar + 1),
              pad_gather(st.perm, ar), pad_gather(st.iperm, ar))
    return shard_schwarz(arrays, ncolors, num_ranks, rank,
                         rank_device(device))


def sharded_sweep(sh: ShardedSchwarz, x, b, comm, num_it: int = 1):
    """Multiplicative coloured sweeps from x on b, both (n, m) and
    replicated: each colour's corrections of this rank's domains, summed
    over the ranks."""
    for _ in range(num_it):
        for c in range(sh.ncolors):
            t = block_solve(sh.idx[c], sh.mask[c], sh.rows_idx[c],
                            sh.rows_val[c], sh.lu[c], sh.perm[c],
                            sh.iperm[c], x, b)
            upd = torch.zeros_like(x).index_add_(
                0, sh.idx[c].reshape(-1), t.reshape(-1, x.shape[1]))
            x = x + comm.psum(upd)
    return x


def dd_parallel_preconditioner(dd: DDSolver, comm, device=None):
    """One sweep from zero with the subdomains spread over the ranks of
    `comm` (mgtpu's dd_parallel_preconditioner): a closure on replicated
    (n,) or (n, m) tensors."""
    P = int(np.prod(comm.shape))
    sh = build_sharded_schwarz(dd, P, comm.rank, device)

    def prec(r):
        squeeze = r.ndim == 1
        rr = r[:, None] if squeeze else r
        x = sharded_sweep(sh, torch.zeros_like(rr), rr, comm)
        return x[:, 0] if squeeze else x

    return prec
