"""Setup parity of the PyTorch port (mgtpu_torch) with mgtpu: host models,
transfers and the grid hierarchy mg_setup builds, on the CPU."""
import numpy as np
import jax  # noqa: F401  (conftest pins JAX to the CPU with x64 on)
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.models.operators import nodal_laplacian_matrix as lap_ref
from mgtpu.setup.transfers import fw_interp_1d as fw_ref

import mgtpu_torch as mt
from mgtpu_torch.models.operators import nodal_laplacian_matrix as lap_port
from mgtpu_torch.setup.transfers import fw_interp_1d as fw_port


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


@pytest.mark.parametrize("dims", [[7, 5], [4, 6, 3]])
def test_mesh_and_laplacian_bitwise(dims):
    dom = [0.0, 1.0] * len(dims)
    Mr, Mp = mgtpu.get_regular_mesh(dom, dims), mt.get_regular_mesh(dom, dims)
    assert (Mr.n, Mr.domain, Mr.h) == (Mp.n, Mp.domain, Mp.h)
    assert Mr.num_nodes == Mp.num_nodes
    Lr, Lp = lap_ref(Mr), lap_port(Mp)
    assert Lr.shape == Lp.shape
    assert (Lr != Lp).nnz == 0


@pytest.mark.parametrize("n", [2, 3, 8, 9, 17])
@pytest.mark.parametrize("geometric", [False, True])
def test_fw_interp_1d_bitwise(n, geometric):
    Pr, ncr = fw_ref(n, geometric)
    Pp, ncp = fw_port(n, geometric)
    assert ncr == ncp and Pr.shape == Pp.shape
    assert np.array_equal(Pr.toarray(), Pp.toarray())


def test_fw_interp_tensor_product_bitwise():
    from mgtpu.setup.transfers import fw_interp as fwn_ref
    from mgtpu_torch.setup.transfers import fw_interp as fwn_port
    Pr, ncr = fwn_ref([9, 6, 5])
    Pp, ncp = fwn_port([9, 6, 5])
    assert np.array_equal(ncr, ncp)
    assert (Pr != Pp).nnz == 0


def _problem(dims):
    M = mgtpu.get_regular_mesh([0.0, 1.0] * len(dims), dims)
    L = lap_ref(M)
    L = (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])).tocsr()
    return dims, L


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("dims,levels", [([32, 32], 4), ([16, 16, 16], 3),
                                         ([16, 17], 3)])
@pytest.mark.parametrize("relax", ["jacobi", "chebyshev"])
def test_mg_setup_matches_reference(dims, levels, relax):
    """[16, 17] cells: an even node count takes the triple-product RAP."""
    dims, L = _problem(dims)
    kw = dict(levels=levels, relax_type=relax, relax_param=0.8, nu_pre=1,
              nu_post=1, dtype=np.float32)
    cfg_r, rp_r = mgtpu.get_mg_param(**kw)
    cfg_p, rp_p = mt.get_mg_param(**kw)
    st_r = mgtpu.mg_setup(L, mgtpu.get_regular_mesh([0.0, 1.0] * len(dims),
                                                    dims), cfg_r, rp_r)
    st_p = mt.mg_setup(L, mt.get_regular_mesh([0.0, 1.0] * len(dims), dims),
                       cfg_p, rp_p, device="cpu")
    hr, hp = st_r.hier, st_p.hier
    assert len(hr.levels) == len(hp.levels) == levels
    for lr, lp in zip(hr.levels, hp.levels):
        Ar, Ap = lr.A, lp.A
        assert type(Ar).__name__ == type(Ap).__name__
        assert tuple(Ar.offsets) == tuple(Ap.offsets)
        assert tuple(Ar.grid) == tuple(Ap.grid)
        if hasattr(Ar, "const"):
            assert _rel(Ap.const, Ar.const) < 1e-6
            assert tuple(Ar.boxes) == tuple(Ap.boxes)
            assert len(Ar.strips) == len(Ap.strips)
            for sr, sp_ in zip(Ar.strips, Ap.strips):
                assert _rel(sp_, sr) < 1e-6
        else:
            assert _rel(Ap.coeff, Ar.coeff) < 1e-6
        if lr.d is None:
            assert lp.d is None and lp.P1 is None
            continue
        assert _rel(lp.d, lr.d) < 1e-6
        assert len(lr.P1) == len(lp.P1)
        for pr, pp in zip(lr.P1, lp.P1):
            assert _rel(pp, pr) < 1e-6
        if relax == "chebyshev":
            assert abs(lp.lam - lr.lam) <= 1e-6 * abs(lr.lam)
        else:
            assert lp.lam is None and lr.lam is None
    assert _rel(hp.coarse.inv, hr.coarse.inv) < 1e-6
    assert tuple(hp.coarse.grid) == tuple(hr.coarse.grid)
    # the original-precision operator is kept for certified refinement
    assert st_p.A_input.dtype == np.float64
    assert (st_p.A_input != st_r.A_input).nnz == 0


@pytest.mark.parametrize("kw", [
    dict(relax_type="hybridKaczmarzNodal"),
    dict(dtype=np.complex128, relax_type="LineJac"),
])
def test_unported_options_raise(kw):
    """Options that raised until they were ported set up as mgtpu's:
    complex128 line relaxation (the grid engine, complex128 Thomas factors
    bit for bit), the hybrid Kaczmarz smoother (the flat engine, the same
    tables)."""
    dims, L = _problem([8, 8])
    cfg, rp = mt.get_mg_param(levels=2, **kw)
    Mp = mt.get_regular_mesh([0.0, 1.0] * 2, dims)
    if "dtype" in kw:
        st = mt.mg_setup(L, Mp, cfg, rp, device="cpu")
        st_r = mgtpu.mg_setup(L, mgtpu.get_regular_mesh([0.0, 1.0] * 2, dims),
                              mgtpu.get_mg_param(levels=2, **kw)[0], rp)
        assert type(st.hier).__name__ == "GridHierarchy"
        lr, lr_r = st.hier.levels[0].line, st_r.hier.levels[0].d
        assert lr.axis == lr_r.axis
        for k in ("alpha", "pivot", "cprime"):
            got, want = _np(getattr(lr, k)), np.asarray(getattr(lr_r, k))
            assert got.dtype == want.dtype == np.complex128
            assert np.array_equal(got, want), k
        return
    from mgtpu.dd.indices import nodal_indices_of_box as box_ref
    from mgtpu_torch.dd.indices import nodal_indices_of_box
    opts = {"num_domains": [2, 2], "omega": 0.8, "num_it": 1}
    st = mt.mg_setup(L, Mp, cfg, dict(opts, index_fn=nodal_indices_of_box),
                     device="cpu")
    cfg_r, _ = mgtpu.get_mg_param(levels=2, **kw)
    st_r = mgtpu.mg_setup(L, mgtpu.get_regular_mesh([0.0, 1.0] * 2, dims),
                          cfg_r, dict(opts, index_fn=box_ref))
    assert type(st.hier).__name__ == type(st_r.hier).__name__ == "Hierarchy"
    kz, kz_r = st.hier.levels[0].relax, st_r.hier.levels[0].relax
    for k in ("arr", "mask", "invd", "ell_idx", "ell_val"):
        assert np.array_equal(_np(getattr(kz, k)), np.asarray(getattr(kz_r,
                                                                      k)))


@pytest.mark.parametrize("kw", [
    dict(relax_type="VankaFaces", transfer_type="SystemsFacesMixedLinear"),
    dict(relax_type="EconVankaFaces", relax_param=2.0,
         transfer_type="SystemsFacesMixedLinear"),
    dict(transfer_type="SystemsFacesLinear"),
    dict(transfer_type="SystemsFacesMixedLinear", relax_type="jacobi",
         relax_param=0.5),
])
def test_staggered_options_set_up_as_reference(kw):
    """The reference spellings of the Vanka smoothers and the staggered
    transfers set up the systems engine on an elasticity operator (16^2,
    mixed where a pressure block is asked for), with mgtpu's hierarchy:
    the same level operators bit for bit and one V-cycle within 1e-9."""
    import jax.numpy as jnp
    from mgtpu.cycle.cycle import recursive_cycle as cycle_ref
    from mgtpu.models import operators as ops_ref
    from mgtpu_torch.cycle.cycle import recursive_cycle as cycle_port
    mixed = kw["transfer_type"] == "SystemsFacesMixedLinear"
    M = mgtpu.get_regular_mesh([0.0, 1.0] * 2, [16, 16])
    mu = np.ones(M.num_cells)
    A = (ops_ref.linear_elasticity_operator_mixed if mixed
         else ops_ref.linear_elasticity_operator)(M, mu, mu)
    A = (A + 1e-3 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    kw = dict(dict(relax_param=0.75), **kw)
    cfg_r, rp = mgtpu.get_mg_param(levels=3, nu_pre=1, nu_post=1, **kw)
    cfg_p, _ = mt.get_mg_param(levels=3, nu_pre=1, nu_post=1, **kw)
    assert (cfg_p.relax_type, cfg_p.transfer_type, cfg_p.mixed) == \
        (cfg_r.relax_type, cfg_r.transfer_type, cfg_r.mixed)
    st_r = mgtpu.mg_setup(A, M, cfg_r, rp)
    st_p = mt.mg_setup(A, mt.get_regular_mesh([0.0, 1.0] * 2, [16, 16]),
                       cfg_p, rp, device="cpu")
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__ == \
        "SystemsGridHierarchy"
    for a, b in zip(st_r.As, st_p.As):
        assert (a != b).nnz == 0
    b = np.random.RandomState(0).rand(A.shape[0], 1)
    y_r = cycle_ref(cfg_r, st_r.hier, jnp.asarray(b),
                    jnp.zeros_like(jnp.asarray(b)))
    y_p = cycle_port(cfg_p, st_p.hier, torch.tensor(b),
                     torch.zeros(b.shape, dtype=torch.float64))
    assert _rel(y_p, y_r) < 1e-9


def test_anisotropy_aliases_set_up():
    """The reference spellings of semicoarsening and line Jacobi set up a
    line-smoothed hierarchy with a non-coarsened axis or a line state."""
    dims, L = _problem([8, 8])
    cfg, rp = mt.get_mg_param(levels=2, transfer_type="SemiCoarsening",
                              relax_type="LineJac", relax_param=0.9)
    assert (cfg.transfer_type, cfg.relax_type) == ("semicoarsening",
                                                   "line-jacobi")
    st = mt.mg_setup(L, mt.get_regular_mesh([0.0, 1.0] * 2, dims), cfg, rp,
                     device="cpu")
    lv = st.hier.levels[0]
    assert lv.d is None and lv.line.omega == 0.9


def test_get_mg_param_aliases_match_reference():
    kw = dict(levels=4, relax_type="Cheb", transfer_type="FullWeighting",
              coarse_solve="NoMUMPS", nu_pre=lambda l: l + 1, nu_post=[1, 2, 3, 4])
    cr, _ = mgtpu.get_mg_param(**kw)
    cp, _ = mt.get_mg_param(**kw)
    for f in ("levels", "relax_type", "transfer_type", "coarse_solve",
              "nu_pre", "nu_post", "cycle_type", "cheby_degree"):
        assert getattr(cr, f) == getattr(cp, f), f
