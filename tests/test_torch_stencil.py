"""Kernel D's plain versions and the variable-coefficient operators of the
PyTorch port against mgtpu, on the CPU: the slab apply against
stencil_matvec_pallas (interpret mode), the grid apply against mgtpu's
GridStencil.matvec on Galerkin-coarsened DivSigGrad levels, the DivSigGrad
operator and cell grid, the slab extraction, and the rule that sends every
level of a rough-sigma hierarchy through kernel D's wrapper."""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.models.mesh import get_cell_centered_grid as ccg_ref
from mgtpu.models.operators import nodal_div_sig_grad_matrix as dsg_ref
from mgtpu.models.operators import nodal_laplacian_matrix as lap_ref
from mgtpu.ops.grid_stencil import grid_stencil_from_csr as gs_from_csr_ref
from mgtpu.ops.grid_stencil import structured_fw_rap as rap_ref
from mgtpu.ops.pallas.stencil_kernel import stencil_matvec_pallas
from mgtpu.parallel.stencil import stencil_from_banded as banded_ref

import mgtpu_torch as mt
from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix as dsg
from mgtpu_torch.ops.cuda import stencil
from mgtpu_torch.ops.grid_stencil import GridStencil
from mgtpu_torch.parallel.stencil import stencil_from_banded


def _sigma(M, seed=3):
    return np.exp(np.random.RandomState(seed).randn(M.num_cells))


# the three operators of tests/test_pallas.py
PALLAS_CASES = {
    "2d_5pt": ([32, 32], lambda M: lap_ref(M)),
    "2d_variable_coeff": ([24, 40], lambda M: dsg_ref(M, _sigma(M))),
    "3d_27pt": ([8, 8, 8], lambda M: dsg_ref(M, _sigma(M))),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_slab_apply_matches_pallas_interpret(case):
    """stencil_matvec (CPU tensor: the plain version) against mgtpu's K8 in
    interpret mode, f64, rtol 1e-12, on the slab form of each operator."""
    dims, make = PALLAS_CASES[case]
    M = mgtpu.get_regular_mesh([0.0, 1.0] * len(dims), dims)
    A = make(M)
    nodes = [d + 1 for d in dims]
    st_r = banded_ref(A, nodes, 0.8, dtype=np.float64)
    st = stencil_from_banded(A, nodes, 0.8, dtype=np.float64)
    assert (st.di, st.dj, st.shape) == (st_r.di, st_r.dj, st_r.shape)
    assert np.array_equal(st.coeff, np.asarray(st_r.coeff))
    assert np.array_equal(st.d, np.asarray(st_r.d))
    NJ, NI = st.shape
    x = np.random.RandomState(len(dims)).rand(NJ, NI)
    want = np.asarray(stencil_matvec_pallas(jnp.asarray(st_r.coeff), st_r.di,
                                            st_r.dj, jnp.asarray(x),
                                            interpret=True))
    n0 = stencil.PLAIN_CALLS["float64"]
    got = stencil.stencil_matvec(torch.from_numpy(st.coeff), st.di, st.dj,
                                 torch.from_numpy(x))
    # on the CPU the wrapper took the plain version (and counted it)
    assert stencil.PLAIN_CALLS["float64"] == n0 + 1
    assert got.dtype == torch.float64 and tuple(got.shape) == (NJ, NI)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    ref = (A @ x.reshape(-1)).reshape(NJ, NI)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def _galerkin_levels(dims, dtype):
    """mgtpu's fine DivSigGrad grid stencil and two structured Galerkin
    coarsenings (9/27-point), host form."""
    M = mgtpu.get_regular_mesh([0.0, 1.0] * len(dims), dims)
    A = dsg_ref(M, _sigma(M))
    gs = gs_from_csr_ref(A, [d + 1 for d in dims], dtype=dtype)
    out = [gs]
    for _ in range(2):
        out.append(rap_ref(out[-1]))
    return out


@pytest.mark.parametrize("dims", [[32, 32], [16, 16, 16]])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [1, 3])
def test_grid_apply_matches_reference_galerkin_levels(dims, dtype, m):
    """GridStencil.matvec (kernel D's wrapper on the CPU) against mgtpu's
    GridStencil.matvec on the fine and Galerkin levels: f64 1e-12, f32
    2e-5 relative."""
    tol = 1e-12 if dtype == np.float64 else 2e-5
    key = np.dtype(dtype).name
    for gs_r in _galerkin_levels(dims, dtype):
        coeff = np.array(gs_r.coeff)
        A_r = mgtpu.ops.grid_stencil.GridStencil(jnp.asarray(coeff),
                                                 gs_r.offsets, gs_r.grid)
        A_p = GridStencil(torch.from_numpy(coeff), gs_r.offsets, gs_r.grid)
        x = np.random.RandomState(m).rand(m, *gs_r.grid).astype(dtype)
        want = np.asarray(A_r.matvec(jnp.asarray(x)))
        n0 = stencil.PLAIN_CALLS[key]
        got = A_p.matvec(torch.from_numpy(x)).numpy()
        assert stencil.PLAIN_CALLS[key] == n0 + 1
        assert got.dtype == dtype and got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < tol, (len(gs_r.offsets), err)


def test_flat_matvec_goes_through_the_wrapper():
    """A flat (n,) vector reaches the same dispatch as a grid field."""
    gs_r = _galerkin_levels([16, 16], np.float64)[1]
    A_p = GridStencil(torch.from_numpy(np.array(gs_r.coeff)),
                      gs_r.offsets, gs_r.grid)
    x = np.random.RandomState(0).rand(int(np.prod(gs_r.grid)))
    n0 = stencil.PLAIN_CALLS["float64"]
    y = A_p.matvec(torch.from_numpy(x)).numpy()
    assert stencil.PLAIN_CALLS["float64"] == n0 + 1
    np.testing.assert_allclose(y, gs_r.to_scipy() @ x, rtol=1e-12,
                               atol=1e-12)


def test_dispatch_rule():
    """Stencils of 1D-3D grids with any per-axis shifts applied to
    float32/float64 x take kernel D's wrapper (which raises on a CUDA x
    whose dtype is not the coefficients', or for more than MAX_TAPS taps);
    another dtype takes the plain version.  On the CPU the wrapper runs the
    plain version.  Every plain call is counted under x's dtype."""
    off2 = ((0, -1), (0, 0), (0, 1))
    assert stencil.supports_stencil(off2, (5, 6), torch.float32)
    assert stencil.supports_stencil(off2, (5, 6), torch.float64)
    assert stencil.supports_stencil(((0,), (1,)), (7,), torch.float64)
    assert stencil.supports_stencil(((0, 2), (0, 0)), (5, 6), torch.float32)
    assert stencil.supports_stencil(((-3, 5), (0, 0)), (5, 6), torch.float64)
    assert stencil.MAX_TAPS == 256
    assert not stencil.supports_stencil(off2, (5, 6), torch.float16)
    assert not stencil.supports_stencil(off2, (5, 6), torch.complex128)
    A = GridStencil(torch.ones((3, 5, 6), dtype=torch.float64), off2, (5, 6))
    n0 = dict(stencil.PLAIN_CALLS)
    y = A.matvec(torch.ones((1, 5, 6), dtype=torch.float32))
    assert stencil.PLAIN_CALLS["float32"] == n0["float32"] + 1
    assert stencil.PLAIN_CALLS["float64"] == n0["float64"]
    assert float(y[0, 2, 2]) == 3.0
    A2 = GridStencil(torch.ones((2, 5, 6)), ((0, 0), (0, 2)), (5, 6))
    y = A2.matvec(torch.ones((1, 5, 6)))
    assert stencil.PLAIN_CALLS["float32"] == n0["float32"] + 2
    assert float(y[0, 2, 2]) == 2.0 and float(y[0, 2, 4]) == 1.0


@pytest.mark.parametrize("dims", [[7, 5], [4, 6, 3]])
def test_div_sig_grad_and_cell_grid_bitwise(dims):
    dom = [0.0, 1.0] * len(dims)
    Mr, Mp = mgtpu.get_regular_mesh(dom, dims), mt.get_regular_mesh(dom, dims)
    assert Mr.num_cells == Mp.num_cells
    assert np.array_equal(ccg_ref(Mr), mt.get_cell_centered_grid(Mp))
    sig = _sigma(Mr, seed=len(dims))
    Ar, Ap = dsg_ref(Mr, sig), dsg(Mp, sig)
    assert Ar.shape == Ap.shape and (Ar != Ap).nnz == 0
    with pytest.raises(ValueError):
        dsg(Mp, sig[:-1])


@pytest.mark.parametrize("dims", [[32, 32], [8, 8, 8]])
def test_rough_sigma_levels_are_grid_stencils_through_kernel_d(dims):
    """Every level of a rough-sigma DivSigGrad hierarchy is a variable
    GridStencil in both packages (so on the card each apply runs kernel D),
    with the reference's coefficients; each level's apply goes through
    kernel D's wrapper."""
    M = mgtpu.get_regular_mesh([0.0, 1.0] * len(dims), dims)
    A = dsg_ref(M, _sigma(M))
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    kw = dict(levels=3, relax_type="jacobi", relax_param=0.8, nu_pre=1,
              nu_post=1, dtype=np.float32)
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(A, mt.get_regular_mesh([0.0, 1.0] * len(dims), dims),
                       *mt.get_mg_param(**kw), device="cpu")
    for lr, lp in zip(st_r.hier.levels, st_p.hier.levels, strict=True):
        assert type(lr.A).__name__ == type(lp.A).__name__ == "GridStencil"
        assert tuple(lr.A.offsets) == tuple(lp.A.offsets)
        assert np.array_equal(np.asarray(lr.A.coeff), lp.A.coeff.numpy())
        assert stencil.supports_stencil(lp.A.offsets, lp.A.grid,
                                        lp.A.coeff.dtype)
        n0 = stencil.PLAIN_CALLS["float32"]
        lp.A.matvec(torch.ones((1,) + lp.A.grid))
        assert stencil.PLAIN_CALLS["float32"] == n0 + 1


# ---------------------------------------------------------------------------
# kernel D's launch plan (ops/cuda/stencil.py::stencil_plan)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 3, 8, 9])
@pytest.mark.parametrize("nd", [1, 8, 9, 37, 97, 179, 256])
def test_stencil_plan_covers_every_tap_once(nd, m):
    """At every split and in every form, the slices' groups take taps
    0..nd-1 once each, in order, at most `group` a group (8 taps for one
    or two right-hand sides, 16 / mb x-loads a tap beyond); the blocks
    cover the output nodes; the plan fits its own launch."""
    box = (1, 40, 41)
    for split in (1, 2, 4, 8, 16):
        for form in stencil.FORMS:
            plan = stencil.stencil_plan(box, nd, m, torch.float64, form,
                                        split=split)
            # the kernel's loops: slice s takes [s per_slice, ...) in groups
            groups = []
            for s in range(plan.split):
                k0 = min(nd, s * plan.per_slice)
                k1 = min(nd, k0 + plan.per_slice)
                groups += [range(kb, min(kb + plan.group, k1))
                           for kb in range(k0, k1, plan.group)]
            assert [k for g in groups for k in g] == list(range(nd))
            assert all(0 < len(g) <= plan.group for g in groups)
            assert plan.mb == min(8, 1 << (m - 1).bit_length())
            assert plan.group == (8 if plan.mb <= 2 else 16 // plan.mb)
            nb = stencil.THREADS // split
            assert (plan.blocks - 1) * nb < 40 * 41 <= plan.blocks * nb
            assert stencil.plan_fits(plan, box, nd, m, torch.float64, form)
            assert plan.schedule == ("stream" if split == 1 else "split")


# (box, taps, split) at PERF.md's kernel-D shapes: the fine levels of (f)
# and (h), SA-s level 0 and SA-f's DIA level fill the card and stream; the
# small and wide levels split
PLAN_SHAPES = [
    ((1, 1025, 1025), 5, 1), ((129, 129, 129), 7, 1), ((1, 513, 513), 5, 1),
    ((1, 1, 263169), 5, 1), ((65, 65, 65), 27, 1), ((1, 257, 257), 13, 4),
    ((1, 129, 129), 37, 8), ((1, 65, 65), 97, 16), ((33, 33, 33), 7, 2),
    ((33, 33, 33), 27, 4), ((17, 17, 17), 33, 8), ((17, 17, 17), 27, 8),
    ((9, 9, 9), 179, 16), ((9, 9, 9), 27, 8), ((1, 33, 33), 9, 2),
]


@pytest.mark.parametrize("box,nd,split", PLAN_SHAPES)
def test_stencil_plan_schedule_at_the_measured_shapes(box, nd, split):
    for dtype in (torch.float32, torch.float64):
        plan = stencil.stencil_plan(box, nd, 1, dtype)
        assert plan.split == split, plan
        assert plan.schedule == ("stream" if split == 1 else "split")
        # a split slice keeps MIN_SLICE taps or more
        assert split == 1 or -(-nd // split) >= stencil.MIN_SLICE


def test_stencil_plan_stream_split_boundary():
    """Below FILL nodes a wide stencil splits; at FILL it streams; a
    narrow one (two slices would take fewer than MIN_SLICE taps each)
    never splits."""
    F = stencil.FILL
    assert stencil.stencil_plan((1, 1, F - 1), 97, 1, torch.float32).split \
        == 2
    assert stencil.stencil_plan((1, 1, F), 97, 1, torch.float32).split == 1
    assert stencil.stencil_plan((1, 9, 9), 6, 1, torch.float32).split == 1
    assert stencil.stencil_plan((1, 9, 9), 7, 1, torch.float32).split == 2


def test_stencil_plan_refuses_a_plan_that_does_not_fit():
    """Every field of a good plan off by one, a split that is not a power
    of two or above MAX_SPLIT, or a plan made for another form, precision
    or m: refused (the C entry's plan_ok applies the same rule)."""
    box, nd, m = (1, 65, 65), 97, 3
    for form in stencil.FORMS:
        good = stencil.stencil_plan(box, nd, m, torch.float32, form)
        assert stencil.plan_fits(good, box, nd, m, torch.float32, form)
        for k in range(len(good)):
            bad = list(good)
            bad[k] += 1
            assert not stencil.plan_fits(bad, box, nd, m, torch.float32,
                                         form), (form, k)
        for split in (0, 3, 32):
            bad = good._replace(split=split)
            assert not stencil.plan_fits(bad, box, nd, m, torch.float32,
                                         form)
        assert not stencil.plan_fits(good, box, nd, m, torch.float64, form)
        assert not stencil.plan_fits(good, box, nd, 9, torch.float32, form)
        assert not stencil.plan_fits(good, box, nd + 16, m, torch.float32,
                                     form)
    assert not stencil.plan_fits(
        stencil.stencil_plan(box, nd, m, torch.float32, "apply"), box, nd,
        m, torch.float32, "restrict")
