"""Device-parallel AMG setup: MIS-2 aggregation and PMIS coloring.

Counterpart of mgtpu/setup/device_agg.py.  The reference's aggregation and
C/F coloring are sequential greedy loops (SA-AMG.jl:119-211,
coloring.jl:13-97); here they are deterministic fixed-point iterations
over a padded ELL neighbor graph, each step a gather and a masked
reduction over the K-wide neighbor axis, in torch on the caller's device
("cuda" unless the caller asks for the CPU).  Each of mgtpu's
``lax.while_loop``s is a Python ``while`` whose condition is read back to
the host once a round.

* `device_aggregation(S)`: a distance-2 maximal independent set (Luby
  rounds on fixed pseudo-random int32 keys, hubs outranked) seeds the
  aggregates, a second MIS-2 layer over the uncovered shell restores the
  greedy seed density, and nodes join the neighboring aggregate with the
  best (sum of strengths into it) / (its size) until none is left.
* `pmis_coloring(S)`: PMIS C/F splitting on float32 weights (degree plus
  a fractional tiebreak); `enforce_common_c` (host scipy) then gives every
  strong F-F pair a common strong C neighbor.

The integer passes give mgtpu's roots, states and colorings bit for bit.
The adoption score sums float32 strengths in slot order (mgtpu: an
einsum), so a near-tie may be broken otherwise (tests/test_torch_device_agg.py
states what holds).  Every public function returns host numpy arrays; the
round counts of each call are appended to `ROUNDS` (the last 64 calls).
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import scipy.sparse as sp
import torch

from ..config import resolve_device

__all__ = ["device_aggregation", "pmis_coloring", "enforce_common_c",
           "ell_graph", "ROUNDS"]

_K_CAP = 32     # keep the strongest _K_CAP neighbors of pathological hubs

# the last calls' round counts: {"call", "n", "K", <loop>: rounds, "seconds"}
ROUNDS: deque = deque(maxlen=64)


def ell_graph(S: sp.csr_matrix, k_cap: int = _K_CAP):
    """Padded ELL of the strength graph, self-loops excluded.

    Returns (idx, val): (n, K) int32 neighbor indices (-1 = padding) and
    float32 strength values (0 at padding).  Rows wider than `k_cap` keep
    their `k_cap` strongest entries."""
    S = S.tocsr()
    n = S.shape[0]
    indptr, indices, data = S.indptr, S.indices, np.abs(S.data)
    counts = np.diff(indptr)
    K = int(min(max(counts.max() if n else 0, 1), k_cap))
    idx = np.full((n, K), -1, dtype=np.int32)
    val = np.zeros((n, K), dtype=np.float32)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        nb = indices[lo:hi]
        vv = data[lo:hi]
        keep = nb != i
        nb, vv = nb[keep], vv[keep]
        if len(nb) > K:
            top = np.argpartition(vv, -K)[-K:]
            nb, vv = nb[top], vv[top]
        idx[i, :len(nb)] = nb
        val[i, :len(nb)] = vv
    return idx, val


def _ell_graph_fast(S: sp.csr_matrix, k_cap: int = _K_CAP):
    """`ell_graph` without a per-row loop when no row is wider than
    `k_cap`; `ell_graph` otherwise."""
    S = S.tocsr()
    n = S.shape[0]
    counts = np.diff(S.indptr)
    K = int(counts.max()) if n else 1
    if K > k_cap:
        return ell_graph(S, k_cap)
    K = max(K, 1)
    idx = np.full((n, K), -1, dtype=np.int32)
    val = np.zeros((n, K), dtype=np.float32)
    rows = np.repeat(np.arange(n), counts)
    pos = np.arange(S.nnz) - np.repeat(S.indptr[:-1], counts)
    idx[rows, pos] = S.indices
    val[rows, pos] = np.abs(S.data)
    self_m = idx == np.arange(n, dtype=np.int32)[:, None]
    idx[self_m] = -1
    val[self_m] = 0.0
    return idx, val


class _Graph:
    """The ELL graph on the device: clamped int64 gather indices and the
    padding mask."""

    def __init__(self, idx_np: np.ndarray, device):
        idx = torch.from_numpy(idx_np).to(device)
        self.valid = idx >= 0
        self.safe = idx.clamp(min=0).long()
        self.n, self.K = idx_np.shape

    def nbr_max(self, x, fill):
        """max over {x[i]} and {x[j] : j a neighbor of i}."""
        g = torch.where(self.valid, x[self.safe], fill)
        return torch.maximum(x, g.max(dim=1).values)


def _mis_rounds(g: _Graph, key, covered, hops):
    """Distance-`hops` maximal independent set by deterministic Luby rounds
    (higher key wins).  Nodes with `covered` set neither seed nor block.
    Returns the roots and the round count."""
    neg = torch.tensor(-1, dtype=key.dtype, device=key.device)
    zero = torch.tensor(0, dtype=key.dtype, device=key.device)
    root = torch.zeros_like(covered)
    rounds = 0
    while bool((~root & ~covered).any()):
        alive = ~root & ~covered
        ka = torch.where(alive, key, neg)
        k = ka
        for _ in range(hops):
            k = g.nbr_max(k, neg)
        root = root | (alive & (ka == k))
        r = root.to(key.dtype)
        for _ in range(hops):
            r = g.nbr_max(r, zero)
        covered = covered | ((r > 0) & ~root)
        rounds += 1
    return root, rounds


def _mis_roots(g: _Graph, key, hops, stats):
    """MIS-`hops` roots, then (hops > 1) a second MIS layer over the shell
    of nodes that no root reaches in one hop (mgtpu's shell re-seeding:
    random keys pack seeds about 30 % sparser than the greedy scan)."""
    none = torch.zeros(g.n, dtype=torch.bool, device=key.device)
    root, stats["mis"] = _mis_rounds(g, key, none, hops)
    if hops > 1:
        i8 = torch.tensor(0, dtype=torch.int8, device=key.device)
        near = root | (g.nbr_max(root.to(torch.int8), i8) > 0)
        root2, stats["shell"] = _mis_rounds(g, key, near, hops)
        root = root | root2
    return root


def _assign_labels(g: _Graph, val, rank, root, stats):
    """Root labels, then adoption rounds: every unlabeled node with a
    labeled neighbor joins the neighboring aggregate with the best (sum of
    strengths into it) / (its size), ties broken on rank (SA-AMG.jl:174-205's
    score); nodes with no neighbor at all become singletons."""
    n, dev = g.n, root.device
    nodes = torch.arange(n, device=dev)
    label = torch.where(root, nodes, -1)
    tie = torch.tensor(1.0 / (4 * n), dtype=torch.float32,
                       device=dev) * rank[g.safe]
    valf = val.float()
    deg0 = ~g.valid.any(dim=1)
    rounds = 0
    while bool((label < 0).any()):
        nlab = torch.where(g.valid, label[g.safe], -1)
        ok = nlab >= 0
        # per-slot affinity: the strengths of the neighbors that share the
        # slot's label, summed in slot order
        aff = torch.zeros((n, g.K), dtype=torch.float32, device=dev)
        for k in range(g.K):
            same = (nlab[:, k:k + 1] == nlab) & ok[:, k:k + 1]
            aff = aff + same.float() * valf[:, k:k + 1]
        size = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
            0, label.clamp(min=0), (label >= 0).float())
        s = aff / size[nlab.clamp(min=0)].clamp(min=1.0) + tie
        s = torch.where(ok, s, -torch.inf)
        best = nlab.gather(1, s.argmax(dim=1, keepdim=True))[:, 0]
        un = label < 0
        label = torch.where(un & ok.any(dim=1), best, label)
        label = torch.where(un & deg0, nodes, label)
        rounds += 1
    stats["labels"] = rounds
    return label


def device_aggregation(S: sp.csr_matrix, tau: float = 3.0, seed: int = 0,
                       hops: int = 2, device=None) -> np.ndarray:
    """aggr[i] = root node of i's aggregate, as a host int64 array for
    `aggregation_to_tentative_p`; the work runs on `device` ("cuda" unless
    the caller asks for the CPU).

    hops: seed separation; 2 = MIS-2 neighborhood aggregation, 1 = denser
    seeding."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    n = S.shape[0]
    idx_np, val_np = _ell_graph_fast(S)
    counts = (idx_np >= 0).sum(axis=1)
    hub = counts > tau * max(counts.mean(), 1e-300)
    # fixed pseudo-random distinct priorities, hubs always outranked
    rank = np.empty(n, dtype=np.int64)
    rank[np.random.RandomState(seed).permutation(n)] = np.arange(n)
    key = (rank + n * (~hub)).astype(np.int32)
    g = _Graph(idx_np, dev)
    stats = {"call": "device_aggregation", "n": n, "K": g.K}
    root = _mis_roots(g, torch.from_numpy(key).to(dev), hops, stats)
    label = _assign_labels(
        g, torch.from_numpy(val_np).to(dev),
        torch.from_numpy((rank / n).astype(np.float32)).to(dev), root,
        stats)
    out = label.cpu().numpy().astype(np.int64)
    stats["seconds"] = time.perf_counter() - t0
    ROUNDS.append(stats)
    return out


def _pmis_loop(g: _Graph, w, stats):
    neg = torch.tensor(-1.0, dtype=w.dtype, device=w.device)
    zero = torch.tensor(0.0, dtype=w.dtype, device=w.device)
    one_i8 = torch.tensor(1, dtype=torch.int8, device=w.device)
    zero_i8 = torch.tensor(0, dtype=torch.int8, device=w.device)
    state = torch.full((g.n,), -1, dtype=torch.int8, device=w.device)
    rounds = 0
    while bool((state < 0).any()):
        un = state < 0
        k = torch.where(un, w, neg)
        k1 = g.nbr_max(k, neg)
        # local maxima among the unassigned (ties promote both)
        st = torch.where(un & (k == k1), one_i8, state)
        c1 = g.nbr_max((st == 1).to(w.dtype), zero)
        state = torch.where((st < 0) & (c1 > 0), zero_i8, st)
        rounds += 1
    stats["pmis"] = rounds
    return state


def pmis_coloring(S: sp.csr_matrix, seed: int = 0,
                  device=None) -> np.ndarray:
    """PMIS C/F splitting on `device` ("cuda" unless the caller asks for
    the CPU); 1 = coarse, 0 = fine, as a host int64 array.  Every F node
    with a strong neighbor has a strong C neighbor; isolated nodes are F."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    n = S.shape[0]
    idx_np, _ = _ell_graph_fast(S)
    counts = (idx_np >= 0).sum(axis=1)
    rank = np.empty(n, dtype=np.float64)
    rank[np.random.RandomState(seed).permutation(n)] = np.arange(n)
    w = (counts + (rank + 0.5) / (n + 1)).astype(np.float32)
    g = _Graph(idx_np, dev)
    stats = {"call": "pmis_coloring", "n": n, "K": g.K}
    state = _pmis_loop(g, torch.from_numpy(w).to(dev), stats).cpu().numpy()
    coloring = (state == 1).astype(np.int64)
    coloring[counts == 0] = 0
    stats["seconds"] = time.perf_counter() - t0
    ROUNDS.append(stats)
    return coloring


def enforce_common_c(S: sp.csr_matrix, coloring: np.ndarray,
                     max_rounds: int = 50) -> np.ndarray:
    """Promote F nodes until every strong F-F pair shares a strong C
    neighbor (reference pass 2, coloring.jl:104-122), in bulk sparse
    rounds on the host: uncovered pairs are the strong F-F pairs with no
    common C in S[F, C] S[C, F]; each round promotes the uncovered nodes
    whose (uncovered-pair count, -index) beats every uncovered partner's.
    max_rounds is a safety net (typically 2-4 rounds)."""
    coloring = coloring.astype(np.int64).copy()
    n = S.shape[0]
    Sp = sp.csr_matrix(S, copy=True)
    Sp.setdiag(0)
    Sp.eliminate_zeros()
    Sp.data = np.ones_like(Sp.data)
    for _ in range(max_rounds):
        c = coloring == 1
        f = ~c
        SF = Sp[f][:, f]
        if SF.nnz == 0:
            break
        SC = Sp[f][:, c]
        P2 = (SC @ SC.T).tocsr()
        cov = np.asarray(P2[SF.astype(bool)]).ravel()
        coo = SF.tocoo()
        unc = cov == 0
        if not unc.any():
            break
        fi = np.where(f)[0]
        ui, uj = coo.row[unc], coo.col[unc]
        u_cnt = np.bincount(ui, minlength=len(fi)) \
            + np.bincount(uj, minlength=len(fi))
        key = u_cnt.astype(np.float64) * n - np.arange(len(fi))
        lose = np.zeros(len(fi), dtype=bool)
        lose[ui[key[ui] <= key[uj]]] = True
        lose[uj[key[uj] <= key[ui]]] = True
        winners = np.unique(np.concatenate([ui[~lose[ui]], uj[~lose[uj]]]))
        if len(winners) == 0:                 # break symmetric stalemates
            winners = np.unique(np.minimum(ui, uj))
        coloring[fi[winners]] = 1
    return coloring
