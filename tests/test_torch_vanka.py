"""Vanka parity of the PyTorch port (mgtpu_torch) with mgtpu, on the CPU:
the cell index sets, colors, gathered blocks, weighted inverses and flat
tables bit for bit for every variant, the flat engine's sweeps and one
cycle per variant on mgtpu's own hierarchy (carried across by
`flat_hierarchy_from_arrays`), kernel E's plain version (the lexicographic
sweep), the fixed-order scatter of the overlapping variants, and the
variants' refined counts.  Float64 cycles agree to 1e-9 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle.cycle import recursive_cycle as cycle_ref
from mgtpu.cycle.vanka import vanka_sweep as sweep_ref
from mgtpu.models.operators import linear_elasticity_operator_mixed as mix_ref
from mgtpu.setup import smoothers as sm_ref

import mgtpu_torch as mt
from mgtpu_torch.convert import flat_hierarchy_from_arrays
from mgtpu_torch.cycle.cycle import recursive_cycle as cycle_port
from mgtpu_torch.cycle.vanka import VankaRelax, _scatter_add, vanka_sweep
from mgtpu_torch.ops.cuda import vanka as vk
from mgtpu_torch.setup import smoothers as sm

VARIANTS = ["vanka", "econ-vanka", "vanka-lex", "vanka-add",
            "kaczmarz-vanka"]


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _mixed(dims, shift=1e-3):
    """mgtpu's mixed-elasticity test operator on `dims` cells, lam = 10 mu:
    (mgtpu mesh, port mesh, A)."""
    dom = [0.0, 1.0] * len(dims)
    M = mgtpu.get_regular_mesh(dom, list(dims))
    Mp = mt.get_regular_mesh(dom, list(dims))
    mu = np.ones(M.num_cells)
    A = mix_ref(M, mu, 10.0 * mu)
    A = A + shift * abs(A).sum(axis=0).max() * sp.identity(A.shape[0])
    return M, Mp, A.tocsr()


def _weight(variant):
    return 2.0 if variant == "econ-vanka" else 0.75


# ---------------------------------------------------------------------------
# host products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [[6, 4], [4, 3, 5]])
@pytest.mark.parametrize("pressure", [False, True])
def test_vanka_cell_indices_bitwise(dims, pressure):
    M, Mp, _ = _mixed(dims)
    Ir, cr = sm_ref.vanka_cell_indices(M, pressure)
    Ip, cp = sm.vanka_cell_indices(Mp, pressure)
    assert np.array_equal(Ir, Ip) and np.array_equal(cr, cp)
    assert Ip.shape == (M.num_cells, 2 * len(dims) + pressure)
    assert set(np.unique(cp)) == set(range(2 ** len(dims)))


@pytest.mark.parametrize("variant,w", [
    ("vanka", 0.75), ("vanka", (0.7, 0.9)), ("econ-vanka", 2.0),
    ("vanka-lex", 0.75), ("vanka-add", 0.75), ("vanka-add", (0.7, 0.9)),
    ("kaczmarz-vanka", 0.9)])
@pytest.mark.parametrize("dims", [[8, 6], [4, 4, 3]])
def test_vanka_block_inverses_bitwise(variant, w, dims):
    M, Mp, A = _mixed(dims)
    Ir, cr, dr = sm_ref.vanka_block_inverses(A, M, w, True, variant)
    Ip, cp, dp = sm.vanka_block_inverses(A, Mp, w, True, variant)
    assert np.array_equal(Ir, Ip) and np.array_equal(cr, cp)
    assert dp.dtype == dr.dtype and np.array_equal(dr, dp)


def test_gather_blocks_in_chunks(monkeypatch):
    """gather_blocks' chunks change nothing: blocks equal mgtpu's one-shot
    product bit for bit at a chunk of 7 cells."""
    M, Mp, A = _mixed([8, 6])
    I, _ = sm.vanka_cell_indices(Mp, True)
    ref = sm_ref.gather_blocks(A, I)
    monkeypatch.setattr(sm, "GATHER_CHUNK", 7)
    assert np.array_equal(sm.gather_blocks(A, I), ref)
    assert np.array_equal(ref[:, 2, 2], A.diagonal()[I[:, 2]])


@pytest.mark.parametrize("variant", VARIANTS)
def test_setup_vanka_tables_bitwise(variant):
    M, Mp, A = _mixed([8, 8])
    w = _weight(variant)
    vr = sm_ref.setup_vanka(A, M, w, True, variant)
    vp = sm.setup_vanka(A, Mp, w, True, variant)
    for k in ("idx", "dinv", "rows_idx", "rows_val"):
        a, b = np.asarray(getattr(vr, k)), getattr(vp, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert vp.dinv.dtype == np.float32
    assert (vp.scatter is not None) == (variant in ("vanka-add",
                                                    "kaczmarz-vanka"))


def test_scatter_table_replays_the_sequential_scatter():
    """Adding the table's columns in turn is the sequential scatter-add
    (x.at[t].add(c), contribution by contribution) bit for bit."""
    rng = np.random.RandomState(0)
    n, m = 13, 2
    targets = rng.randint(0, n, 60)
    contrib = rng.randn(60, m)
    tab = sm._scatter_table(targets, n)
    x = rng.randn(n, m)
    want = x.copy()
    for t, c in zip(targets, contrib):
        want[t] += c
    got = _scatter_add(torch.tensor(x), torch.tensor(contrib),
                       torch.tensor(tab))
    assert np.array_equal(_np(got), want)
    live = rng.rand(60) > 0.3
    tab = sm._scatter_table(targets, n, live)
    assert tab.shape[1] == np.bincount(targets[live]).max()


# ---------------------------------------------------------------------------
# sweeps and cycles
# ---------------------------------------------------------------------------

def _tables(v):
    return dict(idx=np.asarray(v.idx), dinv=np.asarray(v.dinv),
                rows_idx=np.asarray(v.rows_idx),
                rows_val=np.asarray(v.rows_val), variant=v.variant)


@pytest.mark.parametrize("variant", VARIANTS)
def test_vanka_sweep_matches_reference(variant):
    """Two sweeps of every variant on mgtpu's tables, f64, 2 RHS."""
    from mgtpu_torch.convert import vanka_relax_from_arrays
    M, Mp, A = _mixed([8, 8])
    vr = sm_ref.setup_vanka(A, M, _weight(variant), True, variant)
    vp = vanka_relax_from_arrays(_tables(vr), A.shape[0], torch.float64,
                                 "cpu")
    rng = np.random.RandomState(1)
    x, b = rng.rand(A.shape[0], 2), rng.rand(A.shape[0], 2)
    y_r = sweep_ref(jnp.asarray(x), jnp.asarray(b), vr, 2)
    y_p = vanka_sweep(torch.tensor(x), torch.tensor(b), vp, 2)
    assert _rel(y_p, np.asarray(y_r)) < 1e-12


def test_lex_sweep_plain_version_counts_and_matches_a_cell_loop():
    """kernel E's plain version: counted, and the per-cell update by hand."""
    M, Mp, A = _mixed([4, 4])
    vp = sm.setup_vanka(A, Mp, 0.75, True, "vanka-lex").to(torch.float64,
                                                             "cpu")
    rng = np.random.RandomState(2)
    x, b = rng.rand(A.shape[0], 1), rng.rand(A.shape[0], 1)
    n0 = vk.PLAIN_CALLS["float64"]
    y = vanka_sweep(torch.tensor(x), torch.tensor(b), vp, 1)
    assert vk.PLAIN_CALLS["float64"] == n0 + 1
    want = x.copy()
    Ad = A.toarray()
    idx, dinv = _np(vp.idx[0]), _np(vp.dinv[0]).astype(np.float64)
    for l in range(idx.shape[0]):
        r = b[idx[l]] - Ad[idx[l]] @ want
        want[idx[l]] += dinv[l] @ r
    assert _rel(y, want) < 1e-12


def _export_flat(h):
    def mat(E):
        if hasattr(E, "indices"):
            return dict(indices=np.asarray(E.indices),
                        values=np.asarray(E.values), shape=E.shape)
        return dict(data=np.asarray(E.data), offsets=E.offsets,
                    shape=E.shape)
    levels = []
    for lv in h.levels:
        spec = dict(A=mat(lv.A), P=None if lv.P is None else mat(lv.P),
                    R=None if lv.R is None else mat(lv.R))
        if lv.relax is not None:
            spec["vanka"] = _tables(lv.relax)
        levels.append(spec)
    c = h.coarse
    return levels, dict(lu=np.asarray(c.lu), piv=np.asarray(c.piv))


@pytest.mark.parametrize("variant", VARIANTS)
def test_flat_vanka_cycle_matches_reference(variant):
    """One flat-engine cycle per variant on mgtpu's own hierarchy (carried
    across by flat_hierarchy_from_arrays), f64, 2 right-hand sides."""
    M, Mp, A = _mixed([8, 8])
    kw = dict(levels=2, relax_type=variant, relax_param=_weight(variant),
              nu_pre=1, nu_post=1, transfer_type="systems-faces-mixed",
              engine="flat")
    cfg_r, rp = mgtpu.get_mg_param(**kw)
    cfg_p, _ = mt.get_mg_param(**kw)
    st_r = mgtpu.mg_setup(A, M, cfg_r, rp)
    h = flat_hierarchy_from_arrays(*_export_flat(st_r.hier), device="cpu")
    assert isinstance(h.levels[0].relax, VankaRelax)
    b = np.random.RandomState(3).rand(A.shape[0], 2)
    x0 = np.random.RandomState(4).rand(A.shape[0], 2)
    y_r = cycle_ref(cfg_r, st_r.hier, jnp.asarray(b), jnp.asarray(x0))
    y_p = cycle_port(cfg_p, h, torch.tensor(b), torch.tensor(x0))
    assert _rel(y_p, np.asarray(y_r)) < 1e-9
    # the port's own setup gives the same cycle
    st_p = mt.mg_setup(A, Mp, cfg_p, rp, device="cpu")
    y_s = cycle_port(cfg_p, st_p.hier, torch.tensor(b), torch.tensor(x0))
    assert _rel(y_s, np.asarray(y_r)) < 1e-9


@pytest.mark.parametrize("variant,w", [("econ-vanka", 2.0),
                                       ("vanka-add", 0.75),
                                       ("vanka", (0.75, 0.75)),
                                       ("vanka-lex", 0.75),
                                       ("kaczmarz-vanka", 0.9)])
def test_vanka_variant_refined_counts(variant, w):
    """Each variant (on its engine: grid for econ, add and tuple weights,
    flat for lex and cell Kaczmarz) takes mgtpu's refined count at 16^2,
    f32, and the recorded loop is the eager one bit for bit."""
    M, Mp, A = _mixed([16, 16])
    kw = dict(levels=3, relax_type=variant, relax_param=w, nu_pre=1,
              nu_post=1, transfer_type="systems-faces-mixed",
              dtype=np.float32, max_outer_iter=40)
    cfg_r, rp = mgtpu.get_mg_param(**kw)
    cfg_p, _ = mt.get_mg_param(**kw)
    st_r = mgtpu.mg_setup(A, M, cfg_r, rp)
    st_p = mt.mg_setup(A, Mp, cfg_p, rp, device="cpu")
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__
    b = A @ np.random.RandomState(5).rand(A.shape[0])
    b = b / np.linalg.norm(b)
    _, info_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=40)
    x, info = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=40)
    assert info["iters"] == info_r["iters"]
    xe, info_e = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=40,
                                     device_loop=False)
    assert info_e["iters"] == info["iters"] and torch.equal(xe, x)
