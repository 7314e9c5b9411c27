"""Device-side AMG setup of the PyTorch port (mgtpu_torch/setup/device_agg.py)
against mgtpu's (mgtpu/setup/device_agg.py), on the CPU: the ELL packing,
the MIS-2 roots, the aggregate labels, the PMIS coloring and the common-C
enforcement equal mgtpu's bit for bit, and the port passes its versions of
mgtpu's device-setup contracts (tests/test_device_agg.py).

The labels' adoption step sums float32 strengths (mgtpu: an einsum over
the K neighbor slots; the port: a sum in slot order), so a near-tie could
be broken otherwise; on every level tested here the labels are equal
(measured difference: 0 labels)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.models.operators import nodal_div_sig_grad_matrix as dsg_ref
from mgtpu.setup import classical_amg as ca_ref
from mgtpu.setup import device_agg as da_ref
from mgtpu.setup import sa_amg as sa_ref

import mgtpu_torch as mt
from mgtpu_torch.setup import classical_amg as ca_port
from mgtpu_torch.setup import device_agg as da_port
from mgtpu_torch.setup import sa_amg as sa_port


def _op(cells, rough=1.0, seed=0, shift=1e-4):
    """tests/test_device_agg.py's operator: rough-sigma DivSigGrad +
    shift * (max column sum) I."""
    M = mgtpu.get_regular_mesh([0.0, 1.0] * len(cells), list(cells))
    rng = np.random.RandomState(seed)
    L = dsg_ref(M, np.exp(rough * rng.randn(M.num_cells)))
    return (L + shift * abs(L).sum(0).max()
            * sp.identity(L.shape[0])).tocsr()


def _same(A, B):
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    return A.shape == B.shape and A.dtype == B.dtype and (A != B).nnz == 0


def _sa_strengths(cells, monkeypatch):
    """The SA strength matrix of every level of mgtpu's MIS-2 hierarchy
    (4 levels, f32): the fine level's K is 8 or 26, the coarse levels'
    wider."""
    monkeypatch.setenv("MGTPU_AGG", "device")
    cfg, rp = mgtpu.get_mg_param(levels=4, relax_type="spai",
                                 dtype=np.float32)
    st = sa_ref.sa_amg_setup(_op(cells), cfg, rp)
    monkeypatch.delenv("MGTPU_AGG")
    return [sa_ref.strength_matrix(a, 0.4) for a in st.As[:-1]]


def _hub_graph(n=30, hubs=(7, 200, 611)):
    """A 2D strength graph with a few hub nodes joined to 40-80 others, so
    that rows exceed the 32-slot cap."""
    A = _op((n, n))
    rng = np.random.RandomState(1)
    big = abs(A).max()
    A = A.tolil()
    for h in hubs:
        for j in rng.choice(A.shape[0], 40 + h % 41, replace=False):
            if j != h:
                A[h, j] = A[j, h] = -big * (0.5 + rng.rand())
    return sa_ref.strength_matrix(A.tocsr(), 0.4)


# ---------------------------------------------------------------------------
# bitwise parity
# ---------------------------------------------------------------------------

def test_ell_graph_bitwise():
    """ell_graph and _ell_graph_fast equal mgtpu's, on a regular graph and
    on one with hubs beyond the 32-slot cap (strongest 32 kept)."""
    for S in (sa_ref.strength_matrix(_op((20, 20)), 0.4), _hub_graph()):
        for f in ("ell_graph", "_ell_graph_fast"):
            i_r, v_r = getattr(da_ref, f)(S)
            i_p, v_p = getattr(da_port, f)(S)
            assert i_p.dtype == np.int32 and v_p.dtype == np.float32
            assert np.array_equal(i_p, i_r) and np.array_equal(v_p, v_r)
    i_p, _ = da_port._ell_graph_fast(_hub_graph())
    assert i_p.shape[1] == da_port._K_CAP


@pytest.mark.parametrize("hops", [1, 2])
@pytest.mark.parametrize("cells", [(40, 40), (16, 16, 12)])
def test_mis_roots_bitwise(cells, hops):
    """The MIS roots (both layers for hops = 2) equal mgtpu's."""
    import jax.numpy as jnp
    S = sa_ref.strength_matrix(_op(cells), 0.4)
    idx, _ = da_ref._ell_graph_fast(S)
    n = S.shape[0]
    rank = np.empty(n, dtype=np.int64)
    rank[np.random.RandomState(0).permutation(n)] = np.arange(n)
    key = (rank + n).astype(np.int32)
    r_ref = np.asarray(da_ref._mis_roots(jnp.asarray(idx), jnp.asarray(key),
                                         n, hops))
    stats = {}
    r_port = da_port._mis_roots(da_port._Graph(idx, "cpu"),
                                torch.from_numpy(key), hops, stats)
    assert np.array_equal(r_port.numpy(), r_ref)
    assert stats["mis"] > 0 and ("shell" in stats) == (hops > 1)


@pytest.mark.parametrize("cells", [(64, 64), (16, 16, 12)])
def test_device_aggregation_labels_bitwise(cells, monkeypatch):
    """device_aggregation's labels equal mgtpu's on every level of an MIS-2
    hierarchy (K from 8 up to the coarse levels' widths), for hops 1 and 2;
    each call appends its round counts to ROUNDS."""
    for S in _sa_strengths(cells, monkeypatch):
        for hops in (1, 2):
            da_port.ROUNDS.clear()
            lab = da_port.device_aggregation(S, hops=hops, device="cpu")
            assert lab.dtype == np.int64
            ref = da_ref.device_aggregation(S, hops=hops)
            assert np.array_equal(lab, ref), (S.shape, hops,
                                               int((lab != ref).sum()))
            (st,) = da_port.ROUNDS
            assert st["n"] == S.shape[0] and st["labels"] > 0


def test_device_aggregation_on_hubs_bitwise():
    S = _hub_graph()
    assert np.array_equal(da_port.device_aggregation(S, device="cpu"),
                          da_ref.device_aggregation(S))


@pytest.mark.parametrize("theta", [0.25, 0.4])
@pytest.mark.parametrize("cells", [(64, 64), (16, 16, 12)])
def test_pmis_and_common_c_bitwise(cells, theta):
    """pmis_coloring (f32 weights with ties at the fraction's spacing) and
    enforce_common_c equal mgtpu's, on the fine level and on a Galerkin
    coarse level of the classical hierarchy."""
    A = _op(cells)
    st = ca_ref.classical_amg_setup(A, *mgtpu.get_mg_param(
        levels=2, relax_type="spai"))
    for A_l in (A, st.As[1]):
        S = ca_ref.strength_matrix_classical(A_l, theta)
        col = da_port.pmis_coloring(S, device="cpu")
        assert col.dtype == np.int64
        assert np.array_equal(col, da_ref.pmis_coloring(S))
        assert da_port.ROUNDS[-1]["pmis"] > 0
        assert np.array_equal(da_port.enforce_common_c(S, col),
                              da_ref.enforce_common_c(S, col))


def test_sa_device_levels_bitwise(monkeypatch):
    """sa_amg_setup with MGTPU_AGG=device: every level equals mgtpu's."""
    monkeypatch.setenv("MGTPU_AGG", "device")
    A = _op((48, 48))
    kw = dict(levels=4, relax_type="spai", dtype=np.float32)
    st_r = sa_ref.sa_amg_setup(A, *mgtpu.get_mg_param(**kw))
    st_p = mt.sa_amg_setup(A, *mt.get_mg_param(**kw), device="cpu")
    assert st_p.num_levels == st_r.num_levels
    for a_r, a_p in zip(st_r.As, st_p.As):
        assert _same(a_r, a_p)


# ---------------------------------------------------------------------------
# the port's versions of mgtpu's contracts (tests/test_device_agg.py)
# ---------------------------------------------------------------------------

def _iters(st, b):
    x, res = mt.solve_mg(st, b)
    return int(res["iters"]), float(np.asarray(res["relres"]).ravel()[-1])


def test_device_aggregation_valid_and_deterministic():
    S = sa_port.strength_matrix(_op((64, 64)), 0.4)
    a1 = da_port.device_aggregation(S, device="cpu")
    a2 = da_port.device_aggregation(S, device="cpu")
    assert np.array_equal(a1, a2)
    assert (a1 >= 0).all()
    roots = np.unique(a1)
    assert np.array_equal(a1[roots], roots)
    assert 2.0 < S.shape[0] / len(roots) < 9.5


@pytest.mark.slow
def test_sa_device_convergence_parity(monkeypatch):
    """MIS-2 SA within one cycle of greedy SA at 128^2 (Jacobi 0.8 V(2,1),
    5 levels, f64, to 1e-8), at most twice its operator complexity."""
    L = _op((128, 128))
    cfg, rp = mt.get_mg_param(levels=5, relax_type="jacobi", relax_param=0.8,
                              nu_pre=2, nu_post=1, dtype=np.float64,
                              max_outer_iter=50, relative_tol=1e-8)
    b = L @ np.random.RandomState(1).rand(L.shape[0])
    b /= np.linalg.norm(b)
    monkeypatch.setenv("MGTPU_AGG", "greedy")
    st_g = mt.sa_amg_setup(L, cfg, rp, device="cpu")
    it_g, rr_g = _iters(st_g, b)
    monkeypatch.setenv("MGTPU_AGG", "device")
    st_d = mt.sa_amg_setup(L, cfg, rp, device="cpu")
    it_d, rr_d = _iters(st_d, b)
    assert rr_d < 1e-8 or rr_d <= rr_g
    assert it_d <= it_g + 1
    assert st_d.operator_complexity() < 2.0 * st_g.operator_complexity()


def test_pmis_coloring_contract():
    S = ca_port.strength_matrix_classical(_op((64, 64)), 0.25)
    col = da_port.pmis_coloring(S, device="cpu")
    assert np.array_equal(col, da_port.pmis_coloring(S, device="cpu"))
    assert set(np.unique(col)) <= {0, 1}
    indptr, indices = S.indptr, S.indices
    for i in np.where(col == 0)[0]:
        nb = indices[indptr[i]:indptr[i + 1]]
        nb = nb[nb != i]
        assert len(nb) == 0 or np.any(col[nb] == 1)
    assert 0.15 < col.mean() < 0.6


@pytest.mark.parametrize("cells,levels", [((64, 64), 4), ((16, 16, 12), 3)])
def test_classical_pmis_contract(cells, levels):
    """PMIS against common-C (tests/test_device_agg.py::_pmis_vs_commonc):
    the same 1e-8 target, cycles within 35 % of common-C's, an operator
    complexity ceiling."""
    L = _op(cells, seed=0 if len(cells) == 2 else 3)
    cfg, rp = mt.get_mg_param(levels=levels, relax_type="jacobi",
                              relax_param=0.8, nu_pre=2, nu_post=1,
                              dtype=np.float64, max_outer_iter=60,
                              relative_tol=1e-8)
    b = L @ np.random.RandomState(1).rand(L.shape[0])
    b /= np.linalg.norm(b)
    st_c = mt.classical_amg_setup(L, cfg, rp, coarsening="common-c",
                                  device="cpu")
    it_c, rr_c = _iters(st_c, b)
    st_p = mt.classical_amg_setup(L, cfg, rp, coarsening="pmis",
                                  device="cpu")
    it_p, rr_p = _iters(st_p, b)
    assert rr_p < 1e-8, (rr_p, rr_c)
    assert it_p <= 1.35 * it_c + 1, (it_p, it_c)
    opc_c, opc_p = st_c.operator_complexity(), st_p.operator_complexity()
    assert opc_p <= max(1.5 * opc_c, opc_c + 0.5), (opc_p, opc_c)


def test_device_setup_defaults_to_cuda():
    """Without device=, the device setup runs on the card: it raises when
    there is none."""
    S = sa_port.strength_matrix(_op((8, 8)), 0.4)
    for f in (da_port.device_aggregation, da_port.pmis_coloring):
        if torch.cuda.is_available():
            assert np.array_equal(f(S), f(S, device="cpu"))
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                f(S)
