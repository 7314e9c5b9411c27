"""The partitioned flat tier: a flat (AMG) hierarchy over the ranks of a
torch.distributed group with rows AND vectors split into blocks
(mgtpu/parallel/part_amg.py).

The row-sharded tier (sharded_amg.py) keeps every iterate replicated and
all-gathers the whole vector after each row product, so neither memory nor
traffic shrinks as ranks are added.  Here each rank holds its contiguous
block of every level's rows and of every vector, and an operator apply
exchanges only the remote entries its rows read, by a halo plan made on the
host:

 * `partition_plan` (host numpy, mgtpu's arrays bit for bit): for an
   operator with row blocks of p_r and column blocks of p_c, each rank's
   off-block columns grouped by owning rank, one send list per ring
   distance (padded to the largest over the ranks, as mgtpu's static
   shapes are), and the ELL column indices remapped into the concatenation
   [local block | halo of distance d1 | d2 | ...];
 * `PartELL`: this rank's remapped ELL rows and send lists; its apply is
   one `RankGrid.ring_permute` (every distance posted at once: mgtpu's
   `ppermute` per distance), the concatenation, and the port's
   `ell_matvec` (plain torch, as mgtpu's is XLA);
 * the coarsest: `PartDenseLU` (the coarse right-hand side all-gathered,
   the replicated dense LU, this rank's slice), `PartSparseLU` (gathered,
   the host SuperLU on rank 0 alone, then broadcast: mgtpu's `lax.cond` on
   the device index made explicit), `PartIterativeCoarse` (Jacobi-FGMRES
   on the coarsest `PartELL`, its Gram sums reduced: no replication);
 * `PartitionedAMGSolver`: the port's unchanged `recursive_cycle` on a
   `Hierarchy` of `PartELL` levels whose `reduce` is `RankGrid.psum`, so
   Jac-GMRES smoothing and K-cycles run partitioned; `solve_refined`
   certifies against a native float64 `PartELL` of the original operator
   (mgtpu certifies in double-single).

Pad rows (a level's rows round up to a multiple of the rank count) are
index 0 / value 0 and stay zero through the cycle.  The loops run eagerly:
gloo's calls cannot be recorded.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..config import torch_dtype
from ..cycle.coarse import DenseLU, IterativeCoarse, SparseLUCoarse
from ..cycle.cycle import recursive_cycle
from ..cycle.relax import ChebyshevRelax, DiagRelax, fgmres_relaxation
from ..ops.ell import ell_arrays_from_scipy, ell_matvec
from ..setup.hierarchy import Hierarchy, Level
from .comm import rank_device

__all__ = ["PartitionedAMGSolver", "PartELL", "partition_plan"]

PART_RELAX = ("jacobi", "spai", "chebyshev", "chebyshev4", "jac-gmres")


@dataclass(frozen=True, eq=False)
class PartELL:
    """This rank's rows of an operator with a static halo plan: remapped
    ELL indices and values (p_rows, K), per ring distance the local rows
    this rank sends (S_d,); `shape` (p_rows, p_cols + H), so the cycle
    sizes coarse vectors locally.  Padded ELL slots are index 0 / value 0;
    padded send slots ship row 0, which no receiver reads."""
    indices: torch.Tensor
    values: torch.Tensor
    sends: tuple
    shape: tuple
    dists: tuple
    comm: object

    @property
    def dtype(self):
        return self.values.dtype

    def halo(self, x: torch.Tensor) -> torch.Tensor:
        """[x | received for distance d1 | d2 | ...] along rows."""
        if not self.dists:
            return x
        bufs = [x.index_select(0, s) for s in self.sends]
        return torch.cat([x] + self.comm.ring_permute(bufs, self.dists))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return ell_matvec(self.indices, self.values, self.halo(x))


def _rank_block(x: torch.Tensor, comm, nc: int, p: int) -> torch.Tensor:
    """This rank's block of rows of a replicated (nc, m) x, zero-padded to
    P p rows."""
    k = comm.axis_index(0)
    lo, hi = min(k * p, nc), min((k + 1) * p, nc)
    out = x.new_zeros((p,) + tuple(x.shape[1:]))
    out[:hi - lo] = x[lo:hi]
    return out


def _gather_rows(b: torch.Tensor, comm, nc: int) -> torch.Tensor:
    """The first nc rows of the blocks of every rank, in rank order."""
    full = comm.all_gather(b)
    return full.reshape((-1,) + tuple(b.shape[1:]))[:nc]


@dataclass(frozen=True, eq=False)
class PartDenseLU:
    """The replicated dense coarsest solve on partitioned vectors: the
    coarse right-hand side all-gathered, solved on every rank, this rank's
    slice kept (the reference's coarsest LU is global, MGsetup.jl:350)."""
    lu: DenseLU
    nc: int
    p: int
    comm: object

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        x = self.lu.solve(_gather_rows(b, self.comm, self.nc))
        return _rank_block(x, self.comm, self.nc, self.p)


@dataclass(frozen=True, eq=False)
class PartSparseLU:
    """The host SuperLU coarsest solve on partitioned vectors: the coarse
    right-hand side all-gathered, solved by rank 0 alone, broadcast, this
    rank's slice kept.  `inner` (a SparseLUCoarse) is read on rank 0 only;
    the other ranks may hold None."""
    inner: SparseLUCoarse | None
    nc: int
    p: int
    comm: object

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        bf = _gather_rows(b, self.comm, self.nc)
        x = (self.inner.solve(bf) if self.comm.rank == 0
             else torch.zeros_like(bf))
        x = self.comm.broadcast(x, src=0)
        return _rank_block(x, self.comm, self.nc, self.p)


@dataclass(frozen=True, eq=False)
class PartIterativeCoarse:
    """Jacobi-preconditioned one-shot FGMRES coarsest solve on partitioned
    vectors (the reference's MGcycle.jl:152-168 escape hatch): the
    coarsest `PartELL` and this rank's block of the damped inverse
    diagonal, the projection's Gram sums reduced over the ranks.  The only
    coarsest with no replication."""
    A: PartELL
    d: torch.Tensor
    inner: int
    reduce: object

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        dcol = self.d[:, None]
        return fgmres_relaxation(self.A.matvec, lambda r: dcol * r, b,
                                 torch.zeros_like(b), self.inner,
                                 self.reduce)


def _ell_with_mask(A: sp.csr_matrix, dtype):
    idx, val, shape = ell_arrays_from_scipy(A, dtype=dtype)
    counts = np.diff(A.indptr)
    mask = np.arange(idx.shape[1])[None, :] < counts[:, None]
    return idx, val, mask, shape


def partition_plan(A: sp.csr_matrix, ndev: int, p_r: int, p_c: int, dtype):
    """The host halo plan of one operator with row blocks of p_r and column
    blocks of p_c over ndev ranks (mgtpu's partition_plan, the same
    arrays).

    Returns (idx3 (ndev, p_r, K) remapped, val3, dists, sends, H): sends[i]
    is the (ndev, S_i) per-rank LOCAL send list for ring distance dists[i]
    (rank t ships to rank t + dists[i]) and H = sum S_i each rank's halo
    length."""
    A = sp.csr_matrix(A)
    idx, val, mask, (n_r, _) = _ell_with_mask(A, dtype)
    K = idx.shape[1]
    Nr = p_r * ndev
    pad = ((0, Nr - n_r), (0, 0))
    idx3 = np.pad(idx, pad).reshape(ndev, p_r, K)
    val3 = np.pad(val, pad).reshape(ndev, p_r, K)
    mask3 = np.pad(mask, pad).reshape(ndev, p_r, K)

    # needed[s][t]: the sorted distinct columns rank s reads from owner t
    needed = [[None] * ndev for _ in range(ndev)]
    for s in range(ndev):
        cols = idx3[s][mask3[s]]
        own = cols // p_c
        for t in np.unique(own):
            if t != s:
                needed[s][int(t)] = np.unique(cols[own == t])

    dists = sorted({(s - t) % ndev
                    for s in range(ndev) for t in range(ndev)
                    if needed[s][t] is not None})
    sends, offs, H = [], {}, 0
    for d in dists:
        S_d = max(len(needed[(t + d) % ndev][t])
                  if needed[(t + d) % ndev][t] is not None else 0
                  for t in range(ndev))
        send = np.zeros((ndev, S_d), np.int32)
        for t in range(ndev):
            nl = needed[(t + d) % ndev][t]
            if nl is not None:
                send[t, :len(nl)] = nl - t * p_c
        sends.append(send)
        offs[d] = H
        H += S_d

    new_idx = np.zeros_like(idx3)
    for s in range(ndev):
        cols = idx3[s]
        own = cols // p_c
        out = np.where(own == s, cols - s * p_c, 0)
        for d in dists:
            t = (s - d) % ndev
            nl = needed[s][t]
            if nl is None:
                continue
            sel = own == t
            out[sel] = p_c + offs[d] + np.searchsorted(nl, cols[sel])
        new_idx[s] = np.where(mask3[s], out, 0)
    return new_idx, val3, tuple(dists), sends, H


def _pad_vec_blocks(v: np.ndarray, ndev: int, p: int) -> np.ndarray:
    return np.pad(v, ((0, ndev * p - v.shape[0]),) + ((0, 0),) * (v.ndim - 1))


def part_ell(idx3, val3, dists, sends, shape, comm, device) -> PartELL:
    """This rank's PartELL of a plan's arrays (every rank's, as
    `partition_plan` returns them or mgtpu's PartELL holds them)."""
    k = comm.axis_index(0)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return PartELL(t(idx3[k]), t(val3[k]),
                   tuple(t(np.asarray(s[k], np.int64)) for s in sends),
                   tuple(int(v) for v in shape),
                   tuple(int(d) for d in dists), comm)


def _plan_ell(A, ndev, p_r, p_c, dtype, comm, device):
    """(this rank's PartELL, {"halo_entries", "dists"}) of a matrix."""
    i3, v3, dd, ss, H = partition_plan(A, ndev, p_r, p_c, dtype)
    return (part_ell(i3, v3, dd, ss, (p_r, p_c + H), comm, device),
            {"halo_entries": H, "dists": list(dd)})


class PartitionedAMGSolver:
    """Partitioned solves over one flat (AMG) hierarchy: iterates split
    into blocks, a rank's memory n/P + halo a level.  Built once a (state,
    rank grid) on every rank from an MGState of the flat engine
    (`sa_amg_setup` without a mesh, `classical_amg_setup`; float32, a
    pointwise or Jac-GMRES smoother), on `device` (default the rank's
    card).  `comm_entries_per_cycle()` gives the halo plan's sizes.
    `cycle` and `solve_refined` take the whole b on every rank and return
    the whole x on every rank."""

    def __init__(self, state, comm, device=None):
        from ..cycle.grid_cycle import GridHierarchy
        cfg = state.config
        if isinstance(state.hier, GridHierarchy):
            raise ValueError("state uses the structured grid engine — use "
                             "ShardedGridSolver (parallel/sharded_solve.py)")
        if cfg.relax_type not in PART_RELAX:
            raise ValueError(
                "partitioned AMG supports pointwise smoothers "
                "(jacobi/spai/chebyshev/jac-gmres); Vanka/Kaczmarz states "
                "are not partitioned — use ShardedAMGSolver")
        if np.dtype(cfg.dtype) != np.float32:
            raise ValueError("partitioned AMG refinement assumes a float32 "
                             "hierarchy (its residual is float64)")
        self.state, self.cfg, self.comm = state, cfg, comm
        self.device = dev = rank_device(device)
        ndev = self.ndev = comm.axis_size(0)
        self.p = [-(-A.shape[0] // ndev) for A in state.As]
        self.n_true = int(state.As[0].shape[0])
        nlev = len(state.As)

        def plan(M, p_r, p_c):
            return _plan_ell(sp.csr_matrix(M).astype(cfg.dtype), ndev, p_r,
                             p_c, cfg.dtype, comm, dev)

        self._comm = {}
        levels = []
        for l, lvl in enumerate(state.hier.levels):
            A_op, ent = plan(state.As[l], self.p[l], self.p[l])
            self._comm[l] = {"A": ent}
            P_op = R_op = None
            if l < nlev - 1:
                # P maps coarse to fine (fine rows), R fine to coarse
                P_op, self._comm[l]["P"] = plan(state.Ps[l], self.p[l],
                                                self.p[l + 1])
                R_op, self._comm[l]["R"] = plan(state.Rs[l], self.p[l + 1],
                                                self.p[l])
            levels.append(Level(A_op, P_op, R_op,
                                self._relax_block(lvl.relax, l)))

        coarse, nc = state.hier.coarse, int(state.As[-1].shape[0])
        if isinstance(coarse, DenseLU):
            part = PartDenseLU(DenseLU(coarse.lu.to(dev), coarse.piv.to(dev)),
                               nc, self.p[-1], comm)
        elif isinstance(coarse, SparseLUCoarse):
            part = PartSparseLU(coarse if comm.rank == 0 else None, nc,
                                self.p[-1], comm)
        elif isinstance(coarse, IterativeCoarse):
            # the coarsest level's PartELL and its plan, reused
            part = PartIterativeCoarse(
                levels[-1].A, self._block(coarse.d, nlev - 1), coarse.inner,
                comm.psum)
            self._comm[nlev - 1]["coarse_gmres"] = dict(
                self._comm[nlev - 1]["A"])
        else:
            raise ValueError(
                f"partitioned AMG supports dense-LU, host-SuperLU, or "
                f"FGMRES coarsest solves; got {type(coarse).__name__}")
        self.hier = Hierarchy(tuple(levels), part, comm.psum)

        # the certified residual's operator: the original fine matrix in
        # native float64, with its own plan (mgtpu's df32 entry's key)
        A_hi = state.A_input if state.A_input is not None else state.As[0]
        self.A64, self._comm[0]["df_residual"] = _plan_ell(
            sp.csr_matrix(A_hi), ndev, self.p[0], self.p[0], np.float64,
            comm, dev)

    # -- setup helpers -------------------------------------------------------

    def _block(self, v, l: int) -> torch.Tensor:
        """This rank's zero-padded block of a level-l vector."""
        v = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v,
                       self.cfg.dtype)
        k, p = self.comm.axis_index(0), self.p[l]
        blk = _pad_vec_blocks(v, self.ndev, p)[k * p:(k + 1) * p]
        return torch.as_tensor(np.ascontiguousarray(blk), device=self.device)

    def _relax_block(self, rx, l: int):
        if rx is None:                      # the coarsest has no smoother
            return None
        if isinstance(rx, ChebyshevRelax):
            return ChebyshevRelax(self._block(rx.d, l), rx.lam_max)
        if isinstance(rx, DiagRelax):
            return DiagRelax(self._block(rx.d, l))
        raise ValueError(f"unsupported relax type {type(rx).__name__}")

    # -- vectors -------------------------------------------------------------

    def to_block(self, v, dtype=None):
        """(this rank's zero-padded block (p, m), squeeze) of a replicated
        (n,) or (n, m) array."""
        t = torch.as_tensor(np.asarray(v)).to(
            device=self.device,
            dtype=torch_dtype(self.cfg.dtype) if dtype is None else dtype)
        squeeze = t.ndim == 1
        t = t[:, None] if squeeze else t
        return _rank_block(t, self.comm, self.n_true, self.p[0]), squeeze

    def from_block(self, v: torch.Tensor, squeeze: bool) -> np.ndarray:
        """The whole x (numpy) from every rank's block."""
        x = _gather_rows(v, self.comm, self.n_true).cpu().numpy()
        return x[:, 0] if squeeze else x

    def _norm(self, v: torch.Tensor) -> float:
        return float(torch.sqrt(self.comm.psum(torch.sum(v * v))))

    # -- cycles and solves --------------------------------------------------

    def cycle(self, b, x=None):
        """One multigrid cycle of the state's configuration on (n,) or
        (n, m) operands; from zero (x None) the cycle skips the entry
        residual and its halo exchange (`x_zero`)."""
        b2, squeeze = self.to_block(b)
        x2 = torch.zeros_like(b2) if x is None else self.to_block(x)[0]
        y = recursive_cycle(self.cfg, self.hier, b2, x2, x_zero=x is None)
        return self.from_block(y, squeeze)

    def solve_refined(self, b, x=None, tol: float = 1e-8,
                      max_iter: int | None = None):
        """Refinement to a true float64 relative residual below `tol`: at
        most `max_iter` (default max_outer_iter) corrections, each one
        float32 cycle from zero; stops once the residual exceeds 1e3 ||b||.
        One halo exchange a residual, the norms summed over the ranks.
        Returns (x float64 numpy, info with iters, relres, resvec)."""
        cfg = self.cfg
        max_iter = cfg.max_outer_iter if max_iter is None else max_iter
        cd = torch_dtype(cfg.dtype)
        bv, squeeze = self.to_block(b, torch.float64)
        xv = (torch.zeros_like(bv) if x is None
              else self.to_block(x, torch.float64)[0])
        res0 = max(self._norm(bv), 1e-300)
        r = bv - self.A64.matvec(xv)
        res = self._norm(r)
        resvec = [res]
        iters = 0
        while iters < max_iter and tol * res0 <= res < 1e3 * res0:
            rl = r.to(cd)
            z = recursive_cycle(cfg, self.hier, rl, torch.zeros_like(rl),
                                x_zero=True)
            xv = xv + z.to(torch.float64)
            r = bv - self.A64.matvec(xv)
            res = self._norm(r)
            resvec.append(res)
            iters += 1
        return self.from_block(xv, squeeze), {
            "iters": iters, "relres": res / res0, "resvec": np.array(resvec)}

    def comm_entries_per_cycle(self) -> dict:
        """The halo plan's sizes: per level and operator the entries a rank
        receives an apply ("halo_entries") and the ring distances; the
        iterative coarsest's under "coarse_gmres", the float64 residual's
        under "df_residual" (mgtpu's keys)."""
        return self._comm

    def local_vector_rows(self) -> dict:
        """A rank's vector rows per level: ceil(n_l / P)."""
        return {l: self.p[l] for l in range(len(self.p))}
