"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips with a reason when there is none.  On the card:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""
import itertools
import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytestmark = pytest.mark.gpu

# mesh dims; node grids 17^3, (19, 25, 31), and three at kernel A's plan
# edges: (16, 17, 33) has X = 16 planes, one x-run, and y, z one node past
# the (16, 32) tile; (12, 41, 71) fewer planes than one run, ragged tiles;
# (17, 33, 35) the same with odd extents, so that it has a Galerkin level;
# (16, 23, 100), (12, 19, 131) and (17, 25, 125) take the wide (4, 128)
# tile at the narrowest and widest interiors it takes, ragged in y
DIMS = [(16, 16, 16), (18, 24, 30), (32, 16, 15), (70, 40, 11),
        (34, 32, 16), (99, 22, 15), (130, 18, 11), (124, 24, 16)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")


def _shifted_laplacian(dims):
    """The shifted nodal Laplacian (float32 CSR) and its node extents."""
    import mgtpu_torch as mt
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    M = mt.get_regular_mesh([0.0, 1.0] * 3, list(dims))
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])
         ).tocsr().astype(np.float32)
    return L, [d + 1 for d in dims]


def _operators(dims):
    """The shifted nodal Laplacian (nd=7) and, where every node extent is
    odd, its Galerkin coarsening (nd=27) on the card."""
    from mgtpu_torch.ops.grid_stencil import (compress_grid_stencil,
                                              grid_stencil_from_csr,
                                              make_grid_stencil,
                                              structured_fw_rap)
    L, nodes = _shifted_laplacian(dims)
    A7 = make_grid_stencil(L, nodes, device="cuda")
    if any(n % 2 == 0 for n in nodes):
        return [A7]
    A27 = compress_grid_stencil(structured_fw_rap(
        grid_stencil_from_csr(L, nodes)), device="cuda")
    return [A7, A27]


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("dims", DIMS)
def test_kernels_match_plain_versions(dims, m):
    _need_card()
    from mgtpu_torch.ops.cuda import const3d, fused3d
    for A in _operators(dims):
        rng = np.random.RandomState(m)
        x, b, p = (torch.tensor(rng.rand(m, *A.grid).astype(np.float32),
                                device="cuda") for _ in range(3))
        d = torch.tensor(rng.rand(*A.grid).astype(np.float32), device="cuda")
        for mode in const3d.MODES:
            n0 = const3d.LAUNCHES[mode]
            y = const3d.stencil3d_apply(A, mode, x, b=b, d=d, p=p)
            ref = const3d.apply_plain(A, mode, x, b=b, d=d, p=p)
            torch.cuda.synchronize()
            assert const3d.LAUNCHES[mode] == n0 + 1
            assert float((y - ref).abs().max() / ref.abs().max()) < 2e-5
        x1, r1 = fused3d.jacobi_residual3d(A, d, b, x)
        x1p, r1p = fused3d.jacobi_residual_plain(A, d, b, x)
        torch.cuda.synchronize()
        assert float((x1 - x1p).abs().max() / x1p.abs().max()) < 2e-5
        assert float((r1 - r1p).abs().max() / r1p.abs().max()) < 1e-4


def _reversed_taps(dims):
    """The shifted nodal Laplacian with its taps listed in reverse order, on
    the card: not the sorted 7-point set, so the kernels take their tap
    offsets from the stencil description."""
    from mgtpu_torch.ops.grid_stencil import (GridStencil,
                                              compress_grid_stencil,
                                              grid_stencil_from_csr)
    gs = grid_stencil_from_csr(*_shifted_laplacian(dims))
    rev = GridStencil(np.ascontiguousarray(np.asarray(gs.coeff)[::-1]),
                      tuple(reversed(gs.offsets)), gs.grid)
    A = compress_grid_stencil(rev, device="cuda")
    assert A.offsets[0] == (1, 0, 0)
    return A


@pytest.mark.parametrize("dims", [(16, 16, 16), (124, 24, 16)])
def test_kernel_a_any_tap_order(dims):
    """Kernel A on the reversed-tap operators, narrow and wide tiles."""
    _need_card()
    from mgtpu_torch.ops.cuda import const3d
    A = _reversed_taps(dims)
    rng = np.random.RandomState(5)
    x, b, p = (torch.tensor(rng.rand(2, *A.grid).astype(np.float32),
                            device="cuda") for _ in range(3))
    d = torch.tensor(rng.rand(*A.grid).astype(np.float32), device="cuda")
    for mode in const3d.MODES:
        y = const3d.stencil3d_apply(A, mode, x, b=b, d=d, p=p)
        ref = const3d.apply_plain(A, mode, x, b=b, d=d, p=p)
        torch.cuda.synchronize()
        assert float((y - ref).abs().max() / ref.abs().max()) < 2e-5, mode


def _check_kernel_b(A, m, seed):
    """Kernel B on A, with the default x-runs and with one and three runs
    (the default is one-plane runs on small grids),
    equals kernel A's jacobi followed by its residual bit for bit (the same
    fmaf chain and elementwise expressions node by node), and its plain
    version within 2e-5 (x') / 1e-4 (r')."""
    from mgtpu_torch.ops.cuda import const3d, fused3d
    rng = np.random.RandomState(seed)
    x, b = (torch.tensor(rng.rand(m, *A.grid).astype(np.float32),
                         device="cuda") for _ in range(2))
    d = torch.tensor(rng.rand(*A.grid).astype(np.float32), device="cuda")
    xa = const3d.stencil3d_apply(A, "jacobi", x, b=b, d=d)
    ra = const3d.stencil3d_apply(A, "residual", xa, b=b)
    x1p, r1p = fused3d.jacobi_residual_plain(A, d, b, x)
    for nruns in (None, 1, 3):
        plan = fused3d._plan_array(tuple(A.grid), A.boxes, nruns)
        n0 = fused3d.LAUNCHES["jacobi_residual3d"]
        x1, r1 = fused3d._launch(A, d, b, x, plan)
        torch.cuda.synchronize()
        assert fused3d.LAUNCHES["jacobi_residual3d"] == n0 + 1
        form = (tuple(plan), m)
        assert torch.equal(x1, xa), form
        assert torch.equal(r1, ra), form
        assert float((x1 - x1p).abs().max() / x1p.abs().max()) < 2e-5, form
        assert float((r1 - r1p).abs().max() / r1p.abs().max()) < 1e-4, form


@pytest.mark.parametrize("dims", DIMS + [(5, 16, 16)])
def test_kernel_b_is_kernel_a_jacobi_then_residual(dims):
    """Kernel B on the plan-edge grids and on 6 x 17 x 17 nodes (a
    two-plane interior: no core plane), m = 1, 3."""
    _need_card()
    for A in _operators(dims):
        for m in (1, 3):
            _check_kernel_b(A, m, seed=m)


@pytest.mark.parametrize("dims", [(2, 8, 40), (14, 15, 16)])
def test_kernel_b_band_width_one(dims):
    """Kernel B on one-node bands (w = 1: the x ring's two-node halo
    reaches past the grid): 3 x 9 x 41 nodes has X < 2w + 2, a one-plane
    interior and no core plane."""
    _need_card()
    from mgtpu_torch.ops.grid_stencil import (compress_grid_stencil,
                                              grid_stencil_from_csr)
    L, nodes = _shifted_laplacian(dims)
    A = compress_grid_stencil(grid_stencil_from_csr(L, nodes), width=1,
                              device="cuda")
    assert A.boxes[0][1][0] == 1
    for m in (1, 2):
        _check_kernel_b(A, m, seed=m)


@pytest.mark.parametrize("dims", [(16, 16, 16), (124, 24, 16)])
def test_kernel_b_any_tap_order(dims):
    """Kernel B on the reversed-tap operators."""
    _need_card()
    _check_kernel_b(_reversed_taps(dims), 2, seed=5)


def test_kernel_b_refuses_a_plan_that_does_not_fit():
    """The C entry of kernel B recomputes its plan: any field off by one is
    refused; so is a float64 x."""
    _need_card()
    from mgtpu_torch.ops.cuda import const3d, fused3d
    A, _ = _operators((8, 8, 8))
    x = torch.zeros((1,) + A.grid, device="cuda")
    with pytest.raises(TypeError):
        fused3d.jacobi_residual3d(A, x[0], x.double(), x.double())
    lib = fused3d._lib()
    x1, r1 = torch.empty_like(x), torch.empty_like(x)
    meta = const3d.kernel_meta(A.offsets, A.grid, A.boxes)
    good = np.asarray(fused3d._plan_array(tuple(A.grid), A.boxes))
    for k in range(len(good)):
        bad = good.copy()
        bad[k] += 1
        rc = lib.mgt_jacobi_residual3d(
            meta.ctypes.data, 1, A.const.data_ptr(), A.band.data_ptr(),
            x.data_ptr(), x.data_ptr(), x[0].data_ptr(), x1.data_ptr(),
            r1.data_ptr(), torch.cuda.current_stream().cuda_stream,
            bad.ctypes.data)
        assert rc != 0, bad


def test_wrappers_reject_what_kernels_do_not_take():
    _need_card()
    from mgtpu_torch.ops.cuda import const3d
    A, _ = _operators((8, 8, 8))  # 9^3 nodes: both operators
    x = torch.zeros((1,) + A.grid, device="cuda")
    with pytest.raises(TypeError):
        const3d.stencil3d_apply(A, "matvec", x.double())
    with pytest.raises(ValueError):
        const3d.stencil3d_apply(A, "matvec", x.transpose(1, 3))
    with pytest.raises(ValueError):
        const3d.stencil3d_apply(A, "residual", x, b=x[:, :-1])
    # the C entry refuses a launch plan that does not fit the grid
    lib = const3d._lib()
    out = torch.empty_like(x)
    meta = const3d.kernel_meta(A.offsets, A.grid, A.boxes)
    good = np.asarray(const3d._plan_array(tuple(A.grid), A.boxes,
                                         "matvec"))
    for k in range(len(good)):
        bad = good.copy()
        bad[k] += 1
        rc = lib.mgt_stencil3d_apply(
            0, meta.ctypes.data, 1, A.const.data_ptr(), A.band.data_ptr(),
            x.data_ptr(), None, None, None, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream, bad.ctypes.data)
        assert rc != 0, k


def test_small_solve_runs_through_the_kernels():
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    from mgtpu_torch.ops.cuda import const3d, fused3d
    M = mt.get_regular_mesh([0.0, 1.0] * 3, [32, 32, 32])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])).tocsr()
    b = L @ np.random.RandomState(0).rand(L.shape[0])
    b /= np.linalg.norm(b)
    cfg, rp = mt.get_mg_param(levels=4, relax_type="jacobi", relax_param=0.8,
                              nu_pre=1, nu_post=1, dtype=np.float32)
    st = mt.mg_setup(L, M, cfg, rp)
    before = (dict(const3d.LAUNCHES), dict(fused3d.LAUNCHES),
              dict(const3d.PLAIN_CALLS), dict(fused3d.PLAIN_CALLS))
    x, info = mt.solve_mg_refined(st, b, tol=1e-8, max_iter=40)
    xh = x.cpu().numpy()
    assert np.linalg.norm(b - L @ xh) < 1e-8
    assert const3d.LAUNCHES["residual"] > before[0]["residual"]
    assert const3d.LAUNCHES["jacobi_corr"] > before[0]["jacobi_corr"]
    assert const3d.PLAIN_CALLS == before[2]
    assert fused3d.PLAIN_CALLS == before[3]


def _line_states(dims, dtype):
    """line_prec states on every grid axis of an anisotropic operator."""
    import mgtpu_torch as mt
    from mgtpu_torch.cycle.grid_cycle import line_state_to
    from mgtpu_torch.setup.smoothers import line_prec
    Ts = [sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(d + 1, d + 1))
          * (d ** 2) for d in reversed(dims)]
    A = 0
    for k in range(len(dims)):
        mats = [sp.identity(d + 1) for d in reversed(dims)]
        mats[k] = (20.0 if k == 0 else 1.0) * Ts[k]
        term = mats[0]
        for mm in mats[1:]:
            term = sp.kron(term, mm)
        A = A + term
    M = mt.get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    return [line_state_to(line_prec(sp.csr_matrix(A), M, 0.8, dtype=dtype,
                                    axis=a), tdt, "cuda")
            for a in range(len(dims))]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dims", [(18, 24, 30), (64, 64), (40, 40, 40)])
def test_tridiag_matches_plain_on_every_axis(dims, dtype):
    _need_card()
    from mgtpu_torch.ops.cuda import tridiag
    tol = 2e-4 if dtype == np.float32 else 1e-10
    for lr in _line_states(dims, dtype):
        for m in (1, 2):
            rng = np.random.RandomState(m)
            r, x = (torch.tensor(rng.rand(m, *lr.alpha.shape).astype(dtype),
                                 device="cuda") for _ in range(2))
            args = (lr.alpha, lr.pivot, lr.cprime, lr.axis)
            for mode, kw in (("solve", {}),
                             ("correct", dict(x=x, omega=lr.omega))):
                n0 = tridiag.LAUNCHES[mode]
                y = tridiag.line_apply(mode, *args, r, **kw)
                ref = tridiag.line_plain(mode, *args, r, **kw)
                torch.cuda.synchronize()
                assert tridiag.LAUNCHES[mode] == n0 + 1
                assert y.dtype == r.dtype and y.shape == r.shape
                err = float((y - ref).abs().max() / ref.abs().max())
                assert err < tol, (mode, lr.axis, m, err)


def _thomas(grid, axis, dtype, seed=0):
    """Thomas coefficients of a random diagonally dominant tridiagonal
    operator along `axis` of `grid` (line_prec's form: alpha zero at line
    starts, cprime zero at line ends), as tensors on the card."""
    rng = np.random.RandomState(seed)
    sub = -rng.uniform(0.5, 1.0, grid)
    sup = -rng.uniform(0.5, 1.0, grid)
    diag = 2.5 + rng.rand(*grid)
    sub, sup, diag = (np.moveaxis(v, axis, 0) for v in (sub, sup, diag))
    sub[0] = 0.0
    sup[-1] = 0.0
    piv = np.empty_like(diag)
    cp = np.empty_like(diag)
    for i in range(diag.shape[0]):
        prev = cp[i - 1] if i else 0.0
        piv[i] = 1.0 / (diag[i] - sub[i] * prev)
        cp[i] = sup[i] * piv[i]
    alpha = -piv * sub
    return [torch.tensor(np.ascontiguousarray(np.moveaxis(v, 0, axis)),
                         dtype=dtype, device="cuda")
            for v in (alpha, piv, cp)]


# (grid, axis, dtype): each side of the staged tile's limits (a strided
# f32 tile fits up to n = 1610 in solve mode and 1288 in correct mode, a
# contiguous f32 line up to 14496 and 11596 nodes, f64 half as many), 2-
# and 3-node lines, an inner extent that is not a multiple of the tile,
# and the long lines of a (4097, 40) grid
VARIANT_CASES = [
    ((1288, 9), 0, torch.float32), ((1289, 9), 0, torch.float32),
    ((1610, 9), 0, torch.float32), ((1611, 9), 0, torch.float32),
    ((2, 11596), 1, torch.float32), ((2, 11597), 1, torch.float32),
    ((2, 14496), 1, torch.float32), ((2, 14497), 1, torch.float32),
    ((2, 5798), 1, torch.float64), ((2, 5799), 1, torch.float64),
    ((2, 7248), 1, torch.float64), ((2, 7249), 1, torch.float64),
    ((2, 37), 0, torch.float32), ((3, 37), 0, torch.float64),
    ((37, 2), 1, torch.float32), ((37, 3), 1, torch.float64),
    ((4097, 40), 0, torch.float32), ((4097, 40), 1, torch.float32),
    ((4097, 40), 0, torch.float64), ((40, 8193), 1, torch.float32),
    ((40, 8193), 1, torch.float64), ((9, 11, 13), 1, torch.float64),
]


def test_variant_cases_reach_both_variants_in_both_modes():
    """The cases above hold each variant of kernel C in each mode (a plan
    is computed on the host, so this runs without a card)."""
    from mgtpu_torch.ops.cuda import tridiag
    seen = set()
    for grid, axis, dtype in VARIANT_CASES:
        inner = int(np.prod(grid[axis + 1:], dtype=np.int64))
        for mode in tridiag.MODES:
            p = tridiag.line_plan(int(np.prod(grid[:axis], dtype=np.int64)),
                                  grid[axis], inner,
                                  torch.tensor([], dtype=dtype).element_size(),
                                  mode)
            seen.add((mode, p.variant))
    assert seen == {(m, v) for m in tridiag.MODES
                    for v in ("staged", "streamed")}


@pytest.mark.parametrize("case", VARIANT_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{str(c[2])[6:]}")
def test_tridiag_variant_boundaries(case):
    """Both variants of kernel C on each side of the plan's boundary, at
    m = 1 and m = 3 (coefficients repeated over the right-hand sides)."""
    _need_card()
    from mgtpu_torch.ops.cuda import tridiag
    grid, axis, dtype = case
    inner = int(np.prod(grid[axis + 1:], dtype=np.int64))
    n = grid[axis]
    tol = 2e-4 if dtype == torch.float32 else 1e-10
    alpha, piv, cp = _thomas(grid, axis, dtype)
    for m in (1, 3):
        rng = np.random.RandomState(m)
        r, x = (torch.tensor(rng.rand(m, *grid), dtype=dtype, device="cuda")
                for _ in range(2))
        for mode, kw in (("solve", dict(omega=0.8)),
                         ("correct", dict(x=x, omega=0.8))):
            plan = tridiag.line_plan(m * alpha.numel() // (n * inner), n,
                                     inner, alpha.element_size(), mode)
            row = (5 if mode == "correct" else 4) * alpha.element_size() * (
                32 // alpha.element_size() + 1 if inner > 1 else 1)
            assert plan.variant == ("staged" if n * row <= tridiag.MAX_SMEM
                                    else "streamed")
            n0 = tridiag.LAUNCHES[mode]
            y = tridiag.line_apply(mode, alpha, piv, cp, axis, r, **kw)
            ref = tridiag.line_plain(mode, alpha, piv, cp, axis, r, **kw)
            torch.cuda.synchronize()
            assert tridiag.LAUNCHES[mode] == n0 + 1
            err = float((y - ref).abs().max() / ref.abs().max())
            assert err < tol, (mode, m, plan.variant, err)


def test_tridiag_rejects_what_the_kernel_does_not_take():
    _need_card()
    from mgtpu_torch.ops.cuda import tridiag
    lr = _line_states((8, 8), np.float32)[1]
    args = (lr.alpha, lr.pivot, lr.cprime, lr.axis)
    r = torch.zeros((1, 9, 9), device="cuda")
    with pytest.raises(TypeError):
        tridiag.line_apply("solve", *args, r.double())
    with pytest.raises(TypeError):
        tridiag.line_apply("solve", *args, r.half())
    with pytest.raises(ValueError):
        tridiag.line_apply("solve", *args, r.transpose(1, 2))
    with pytest.raises(ValueError):
        tridiag.line_apply("correct", *args, r, x=r[:, :-1], omega=0.8)
    # the C entry refuses a launch plan that does not fit the shape
    lib = tridiag._lib()
    out = torch.empty_like(r)
    good = np.asarray(tridiag._plan_array(9, 9, 1, 4, "solve"))
    for k in range(len(good)):
        bad = good.copy()
        bad[k] += 1
        rc = lib.mgt_tridiag(0, 0, 9, 9, 9, 1, lr.alpha.data_ptr(),
                             lr.pivot.data_ptr(), lr.cprime.data_ptr(),
                             r.data_ptr(), None, 1.0, out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream,
                             bad.ctypes.data)
        assert rc != 0, k


def _divsig_stencils(dims, dtype):
    """The rough-sigma DivSigGrad operator (5 or 7 taps) and its Galerkin
    coarsening (9 or 27 taps) as GridStencils on the card."""
    import mgtpu_torch as mt
    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    from mgtpu_torch.ops.grid_stencil import (grid_stencil_from_csr,
                                              structured_fw_rap)
    M = mt.get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    sig = np.exp(np.random.RandomState(3).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    gs = grid_stencil_from_csr(A, [d + 1 for d in dims], dtype=dtype)
    return A, [gs.to("cuda"), structured_fw_rap(gs).to("cuda")]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dims", [(24, 40), (18, 24, 30)])
def test_stencil_kernel_matches_plain(dims, dtype):
    _need_card()
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import grid_stencil_matvec
    tol = 2e-5 if dtype == np.float32 else 1e-12
    key = np.dtype(dtype).name
    _, ops = _divsig_stencils(dims, dtype)
    for A in ops:
        for m in (1, 2, 3, 4, 9):
            x = torch.tensor(np.random.RandomState(m).rand(m, *A.grid),
                             dtype=A.coeff.dtype, device="cuda")
            n0, p0 = stencil.LAUNCHES[key], stencil.PLAIN_CALLS[key]
            y = A.matvec(x)
            ref = grid_stencil_matvec(A.coeff, A.offsets, x)
            torch.cuda.synchronize()
            assert stencil.LAUNCHES[key] == n0 + 1
            assert stencil.PLAIN_CALLS[key] == p0
            assert y.dtype == x.dtype and y.shape == x.shape
            err = float((y - ref).abs().max() / ref.abs().max())
            assert err < tol, (len(A.offsets), m, err)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stencil_slab_form_matches_plain(dtype):
    """The slab entry (stencil_matvec, K8's counterpart) on a 3D operator
    whose two fast axes fold into NI."""
    _need_card()
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.parallel.stencil import stencil_from_banded
    A, _ = _divsig_stencils((8, 8, 8), dtype)
    st = stencil_from_banded(A, [9, 9, 9], 0.8, dtype=dtype)
    coeff = torch.tensor(st.coeff, device="cuda")
    x = torch.tensor(np.random.RandomState(0).rand(*st.shape).astype(dtype),
                     device="cuda")
    y = stencil.stencil_matvec(coeff, st.di, st.dj, x)
    ref = stencil.stencil_matvec_plain(coeff, st.di, st.dj, x)
    want = (A @ x.cpu().numpy().astype(np.float64).reshape(-1)).reshape(
        st.shape)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == np.float32 else 1e-12
    assert float((y - ref).abs().max() / ref.abs().max()) < tol
    assert np.abs(y.cpu().numpy() - want).max() / np.abs(want).max() < tol


def test_stencil_rejects_what_the_kernel_does_not_take():
    _need_card()
    from mgtpu_torch.ops.cuda import stencil
    _, (A, _) = _divsig_stencils((8, 8), np.float32)
    x = torch.zeros((1,) + A.grid, device="cuda")
    with pytest.raises(TypeError):
        stencil.grid_apply(A.coeff, A.offsets, x.double())
    with pytest.raises(TypeError):
        stencil.grid_apply(A.coeff.half(), A.offsets, x.half())
    with pytest.raises(ValueError):
        stencil.grid_apply(A.coeff, A.offsets, x.transpose(1, 2))
    with pytest.raises(ValueError):
        stencil.grid_apply(A.coeff, A.offsets, x[:, :-1])
    with pytest.raises(ValueError):
        stencil.grid_apply(A.coeff, A.offsets[:-1], x)
    coeff, offsets = _wide_stencil(257, 2, A.grid, np.float32)
    with pytest.raises(ValueError, match="256"):
        stencil.grid_apply(coeff, offsets, x)


def test_grid_stencil_dispatch_on_the_card():
    """On the card, GridStencil.matvec raises on a mixed pair (f32
    coefficients, f64 x) and on more than 256 taps; a radius-2 stencil
    launches kernel D; a float16 field takes the plain version, counted."""
    _need_card()
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import GridStencil
    _, (A, _) = _divsig_stencils((8, 8), np.float32)
    x = torch.ones((1,) + A.grid, device="cuda")
    with pytest.raises(TypeError):
        A.matvec(x.double())
    p0, n0 = dict(stencil.PLAIN_CALLS), dict(stencil.LAUNCHES)
    A2 = GridStencil(torch.ones((2, 5, 6), device="cuda"),
                     ((0, 0), (0, 2)), (5, 6))
    y = A2.matvec(torch.ones((1, 5, 6), device="cuda"))
    torch.cuda.synchronize()
    assert stencil.LAUNCHES["float32"] == n0["float32"] + 1
    assert stencil.PLAIN_CALLS["float32"] == p0["float32"]
    assert float(y[0, 2, 2]) == 2.0 and float(y[0, 2, 4]) == 1.0
    coeff, offsets = _wide_stencil(257, 2, A.grid, np.float32)
    with pytest.raises(ValueError, match="256"):
        GridStencil(coeff, offsets, A.grid).matvec(x)
    GridStencil(A.coeff.half(), A.offsets, A.grid).matvec(x.half())
    assert stencil.PLAIN_CALLS.get("float16", 0) == p0.get("float16", 0) + 1


def _wide_stencil(ntaps, dim, grid, dtype, seed=0):
    """Random coefficients (on the card) of a stencil whose taps are the
    `ntaps` offsets nearest the centre of a radius-8 box (ties in order)."""
    r = range(-8, 9)
    offs = sorted(itertools.product(*[r] * dim),
                  key=lambda o: (sum(d * d for d in o), o))[:ntaps]
    coeff = np.random.RandomState(seed).rand(ntaps, *grid).astype(dtype)
    return torch.tensor(coeff, device="cuda"), tuple(offs)


@pytest.mark.parametrize("ntaps,dim", [(13, 2), (37, 2), (97, 2), (179, 3),
                                       (256, 3)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stencil_kernel_wide_stencils(ntaps, dim, dtype):
    """Kernel D at the smoothed-aggregation stencils' widths (13 / 37 / 97
    taps in 2D, 179 in 3D) and at its cap of 256, against its plain
    version: 2e-5 (f32) / 1e-12 (f64), m = 1 and 3."""
    _need_card()
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import grid_stencil_matvec
    grid = (37, 41) if dim == 2 else (13, 15, 17)
    coeff, offsets = _wide_stencil(ntaps, dim, grid, dtype)
    key = np.dtype(dtype).name
    tol = 2e-5 if dtype == np.float32 else 1e-12
    for m in (1, 3):
        x = torch.tensor(np.random.RandomState(m).rand(m, *grid),
                         dtype=coeff.dtype, device="cuda")
        n0, p0 = stencil.LAUNCHES[key], stencil.PLAIN_CALLS[key]
        y = stencil.grid_apply(coeff, offsets, x)
        ref = grid_stencil_matvec(coeff, offsets, x)
        torch.cuda.synchronize()
        assert stencil.LAUNCHES[key] == n0 + 1
        assert stencil.PLAIN_CALLS[key] == p0
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err < tol, (ntaps, m, err)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stencil_kernel_dia_form(dtype):
    """Kernel D on a (1, 1, n) box: the DIA form of the 2D 5-point
    operator on a 33 x 41 grid (offsets +-1 and +-41, beyond a grid row)
    and a diagonal past the matrix (always masked), against dia_apply_plain
    and scipy, m = 1 and 3."""
    _need_card()
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.dia import dia_from_scipy
    T = lambda k: sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    A = (sp.kron(sp.identity(33), T(41)) + sp.kron(T(33), sp.identity(41))
         ).tocsr()
    D = dia_from_scipy(A, dtype=dtype, device="cuda")
    assert D.offsets == (-41, -1, 0, 1, 41)
    n = A.shape[0]
    offsets = D.offsets + (n + 5,)
    data = torch.cat([D.data, torch.ones_like(D.data[:1])])
    key = np.dtype(dtype).name
    tol = 2e-5 if dtype == np.float32 else 1e-12
    for m in (1, 3):
        xh = np.random.RandomState(m).rand(n, m)
        x = torch.tensor(xh, dtype=D.data.dtype, device="cuda")
        n0 = stencil.LAUNCHES[key]
        y = stencil.dia_apply(data, offsets, x[:, 0] if m == 1 else x)
        ref = stencil.dia_apply_plain(data, offsets, x)
        torch.cuda.synchronize()
        assert stencil.LAUNCHES[key] == n0 + 1
        y2 = y[:, None] if m == 1 else y
        assert float((y2 - ref).abs().max() / ref.abs().max()) < tol
        want = A @ x.cpu().numpy().astype(np.float64)
        assert np.abs(y2.cpu().numpy() - want).max() / np.abs(want).max() \
            < tol


@pytest.mark.parametrize("split", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stencil_schedules_match_plain(split, dtype):
    """Kernel D with its schedule forced (split 1: "stream"; 2-16:
    "split") at the plan's edges — 1 tap, 9 (one past a group), 97 and
    256 — on 2D and 3D grids, m = 1, 3, 8 and 9, against its plain
    version: 2e-5 (f32) / 1e-12 (f64)."""
    _need_card()
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import grid_stencil_matvec
    tol = 2e-5 if dtype == np.float32 else 1e-12
    for ntaps, dim in ((1, 2), (9, 2), (97, 2), (256, 3)):
        grid = (37, 41) if dim == 2 else (13, 15, 17)
        coeff, offsets = _wide_stencil(ntaps, dim, grid, dtype)
        box = (1,) * (3 - dim) + grid
        taps = tuple((0,) * (3 - dim) + o for o in offsets)
        for m in (1, 3, 8, 9):
            x = torch.tensor(np.random.RandomState(m).rand(m, *grid),
                             dtype=coeff.dtype, device="cuda")
            plan = stencil.stencil_plan(box, ntaps, m, x.dtype, split=split)
            y = stencil._launch(coeff, box, taps, x, plan=plan)
            ref = grid_stencil_matvec(coeff, offsets, x)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max() / ref.abs().max())
            assert err < tol, (ntaps, m, split, err)


def test_stencil_masked_taps_read_nothing():
    """A tap that leaves the grid loads nothing: x holds inf on the first
    column and NaN on the first row, every coefficient is 1, and each node
    whose taps stay off those lines is finite and equals the plain
    version (a masked load multiplied by zero would give NaN)."""
    _need_card()
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import grid_stencil_matvec
    offsets = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
    for split in (1, 4):
        coeff = torch.ones((5, 9, 10), device="cuda")
        x = torch.rand((1, 9, 10), device="cuda")
        x[0, :, 0] = float("inf")
        x[0, 0, :] = float("nan")
        plan = stencil.stencil_plan((1, 9, 10), 5, 1, x.dtype, split=split)
        y = stencil._launch(coeff, (1, 9, 10),
                            tuple((0,) + o for o in offsets), x, plan=plan)
        ref = grid_stencil_matvec(coeff, offsets, x)
        torch.cuda.synchronize()
        inner = (slice(None), slice(2, None), slice(2, None))
        assert bool(torch.isfinite(y[inner]).all()), split
        assert float((y[inner] - ref[inner]).abs().max()) < 1e-5


def test_stencil_refuses_a_plan_that_does_not_fit():
    """The C entry of kernel D checks its plan: any field off by one is
    refused, in each form; so is an apply whose boxes differ."""
    _need_card()
    from mgtpu_torch.ops.cuda import stencil
    lib = stencil._lib()
    box, nd, m = (1, 65, 65), 97, 3
    coeff = torch.zeros((nd,) + box[1:], device="cuda")
    x = torch.zeros((m,) + box[1:], device="cuda")
    y = torch.empty_like(x)
    taps = stencil._taps(tuple((0, 0, k) for k in range(nd)))
    ptab = torch.zeros((nd, 8, 4), dtype=torch.int32, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    for f, form in enumerate(stencil.FORMS):
        good = np.asarray(stencil.stencil_plan(box, nd, m, torch.float32,
                                               form), dtype=np.int32)
        for k in range(len(good)):
            bad = good.copy()
            bad[k] += 1
            rc = lib.mgt_stencil(0, f, nd, nd, taps.ctypes.data, *box, *box,
                                 m, coeff.data_ptr(), x.data_ptr(),
                                 y.data_ptr(), ptab.data_ptr(),
                                 bad.ctypes.data, st)
            assert rc != 0, (form, k)
    good = np.asarray(stencil.stencil_plan(box, nd, m, torch.float32),
                      dtype=np.int32)
    rc = lib.mgt_stencil(0, 0, nd, nd, taps.ctypes.data, *box, 1, 65, 64, m,
                         coeff.data_ptr(), x.data_ptr(), y.data_ptr(), None,
                         good.ctypes.data, st)
    assert rc != 0


def _random_stride2(fine, seed):
    """A random stride-2 prolongation on a fine node grid onto
    ceil(fine / 2): entries at f = 2c + d for a random half of the offsets
    d in [-3, 3]^dim (tests/test_torch_amg.py builds the same)."""
    rng = np.random.RandomState(seed)
    coarse = tuple((f + 1) // 2 for f in fine)
    offs = [d for d in itertools.product(range(-3, 4), repeat=len(fine))
            if rng.rand() < 0.5]
    rows, cols = [], []
    for c in itertools.product(*map(range, coarse)):
        for d in offs:
            f = tuple(2 * ci + di for ci, di in zip(c, d))
            if all(0 <= fi < F for fi, F in zip(f, fine)):
                rows.append(np.ravel_multi_index(f, fine))
                cols.append(np.ravel_multi_index(c, coarse))
    P = sp.csr_matrix((rng.rand(len(rows)) + 0.5, (rows, cols)),
                      shape=(int(np.prod(fine)), int(np.prod(coarse))))
    return P, coarse


@pytest.mark.parametrize("fine", [(9, 11), (10, 12), (7, 8, 9), (6, 5, 4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_packed_stride2_transfers_match_p(fine, dtype):
    """The parity-form prolong and the even-node restrict of kernel D, on
    odd and even extents in 2D and 3D, at the default plan and at splits
    2 and 16, equal P @ x and P^T @ r (2e-5 f32 / 1e-12 f64), m = 1 and 3;
    each apply is one launch."""
    _need_card()
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import stride2_transfer_from_scipy
    P, coarse = _random_stride2(fine, seed=len(fine) + fine[0])
    T = stride2_transfer_from_scipy(P, list(reversed(fine)),
                                    list(reversed(coarse)), dtype=dtype,
                                    device="cuda")
    key = np.dtype(dtype).name
    tol = 2e-5 if dtype == np.float32 else 1e-12
    fbox, cbox = ((1,) * (3 - len(fine)) + g for g in (fine, coarse))
    taps = tuple((0,) * (3 - len(fine)) + o for o in T.offsets)
    for m in (1, 3):
        rng = np.random.RandomState(m)
        xc, r = rng.rand(P.shape[1], m), rng.rand(P.shape[0], m)
        xd = torch.tensor(xc.T.reshape((m,) + coarse), dtype=T.dtype,
                          device="cuda").contiguous()
        rd = torch.tensor(r.T.reshape((m,) + fine), dtype=T.dtype,
                          device="cuda").contiguous()
        n0 = stencil.LAUNCHES[key]
        outs = [(T.prolong(xd), P @ xc), (T.restrict(rd), P.T @ r)]
        assert stencil.LAUNCHES[key] == n0 + 2
        for split in (2, 16):
            pp = stencil.stencil_plan(fbox, T.pcoeff.shape[0], m, xd.dtype,
                                      "prolong", split=split)
            pr = stencil.stencil_plan(cbox, len(taps), m, xd.dtype,
                                      "restrict", split=split)
            outs.append((stencil._launch(
                T.pcoeff, fbox, taps, xd, form="prolong", in_box=cbox,
                in_space=coarse, ptab=T.ptab, plan=pp), P @ xc))
            outs.append((stencil._launch(
                T.rcoeff, cbox, taps, rd, form="restrict", in_box=fbox,
                in_space=fine, plan=pr), P.T @ r))
        torch.cuda.synchronize()
        for i, (got, want) in enumerate(outs):
            got = got.cpu().numpy().reshape(m, -1).T
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err < tol, (m, i, err)


def _rough_sigma(n, dim=2, shift=1e-8, seed=3):
    import mgtpu_torch as mt
    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    M = mt.get_regular_mesh([0.0, 1.0] * dim, [n] * dim)
    sig = np.exp(np.random.RandomState(seed).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + shift * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    return M, A


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stride2_transfers_through_kernel_d(dtype):
    """Both applies of every Stride2Transfer of a structured SA hierarchy
    (64^2 rough sigma) launch kernel D and equal P @ x / P^T @ r of the
    assembled matrices."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import Stride2Transfer
    M, A = _rough_sigma(64)
    cfg, rp = mt.get_mg_param(levels=4, relax_type="spai", dtype=dtype)
    st = mt.sa_amg_setup(A, cfg, rp, mesh=M)
    key = np.dtype(dtype).name
    tol = 2e-5 if dtype == np.float32 else 1e-12
    for l, lv in enumerate(st.hier.levels[:-1]):
        T = lv.P1
        assert isinstance(T, Stride2Transfer)
        P = st.Ps[l].astype(np.float64)
        for m in (1, 3):
            rng = np.random.RandomState(m)
            xc = rng.rand(P.shape[1], m)
            r = rng.rand(P.shape[0], m)
            n0 = stencil.LAUNCHES[key]
            y = T.prolong(torch.tensor(xc.T.reshape((m,) + T.coarse_grid),
                                       dtype=T.dtype, device="cuda"))
            rc = T.restrict(torch.tensor(r.T.reshape((m,) + T.fine_grid),
                                         dtype=T.dtype, device="cuda"))
            torch.cuda.synchronize()
            assert stencil.LAUNCHES[key] == n0 + 2
            for got, want in ((y, P @ xc), (rc, P.T @ r)):
                got = got.cpu().numpy().reshape(m, -1).T
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err < tol, (l, m, err)


def test_device_built_coarsest_inverse():
    """The dense inverse of a 65^2 (4225-dof) coarsest built on the card:
    A inv is the identity to 10 eps * cond_1(A) in float32 and float64."""
    _need_card()
    from mgtpu_torch.cycle.grid_cycle import grid_dense_inverse_from_scipy
    _, A = _rough_sigma(64, shift=1e-2)
    Ad = A.toarray()
    cond = np.linalg.cond(Ad, 1)
    for dtype in (np.float32, np.float64):
        D = grid_dense_inverse_from_scipy(A, (65, 65), dtype, "cuda")
        err = np.abs(Ad @ D.inv.double().cpu().numpy() - np.eye(65 * 65))
        assert err.max() < 10 * np.finfo(dtype).eps * cond, (dtype, err.max())


def test_small_amg_solves_run_through_kernel_d():
    """64^2 rough-sigma SA on the card — structured (grid engine), its
    K-cycle form, and greedy (flat engine, DIA fine level) — to a true
    relres of 1e-8: kernel D runs in float32 and float64 in each solve and
    its plain version never does."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.ops.cuda import stencil
    M, A = _rough_sigma(64)
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b /= np.linalg.norm(b)
    for kw, mesh in ((dict(relax_type="spai"), M),
                     (dict(relax_type="jac-gmres", relax_param=1.0,
                           nu_pre=1, nu_post=1, cycle_type="K"), M),
                     (dict(relax_type="spai"), None)):
        cfg, rp = mt.get_mg_param(levels=4, dtype=np.float32, **kw)
        st = mt.sa_amg_setup(A, cfg, rp, mesh=mesh)
        before = (dict(stencil.LAUNCHES), dict(stencil.PLAIN_CALLS))
        x, info = mt.solve_mg_refined(st, b, tol=1e-8, max_iter=80)
        assert np.linalg.norm(b - A @ x.cpu().numpy()) < 1e-8, info["iters"]
        assert stencil.LAUNCHES["float32"] > before[0]["float32"]
        assert stencil.LAUNCHES["float64"] > before[0]["float64"]
        assert stencil.PLAIN_CALLS == before[1]


def test_small_krylov_solve_runs_through_kernel_d():
    """A 64^2 rough-sigma CG and K-cycle GMRES solve on the card: f32
    cycles and the f64 outer operator both launch kernel D, its plain
    version never runs, and the true residual reaches 1e-8."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.ops.cuda import stencil
    A, _ = _divsig_stencils((64, 64), np.float64)
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [64, 64])
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b /= np.linalg.norm(b)
    for kw, solve in ((dict(relax_type="jacobi", relax_param=0.8),
                       mt.solve_cg_mg),
                      (dict(relax_type="jac-gmres", relax_param=1.0,
                            cycle_type="K"), mt.solve_gmres_mg)):
        cfg, rp = mt.get_mg_param(levels=4, max_outer_iter=100,
                                  relative_tol=1e-8, nu_pre=1, nu_post=1,
                                  dtype=np.float32, **kw)
        st = mt.mg_setup(A, M, cfg, rp)
        before = (dict(stencil.LAUNCHES), dict(stencil.PLAIN_CALLS))
        x, _ = solve(st, b)
        assert np.linalg.norm(b - A @ x.cpu().numpy()) < 1e-8
        assert stencil.LAUNCHES["float32"] > before[0]["float32"]
        assert stencil.LAUNCHES["float64"] > before[0]["float64"]
        assert stencil.PLAIN_CALLS == before[1]


@pytest.mark.parametrize("dim", [2, 3])
def test_device_setup_on_the_card_equals_cpu(dim):
    """MIS-2 aggregation (hops 1 and 2) and PMIS coloring on the card give
    their CPU results on every level of an SA hierarchy (64^2 / 16^3 rough
    sigma; the coarse levels' wider K) and on the classical strength."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.setup import classical_amg, device_agg, sa_amg
    _, A = _rough_sigma(64 if dim == 2 else 16, dim=dim, shift=1e-4, seed=0)
    cfg, rp = mt.get_mg_param(levels=4, relax_type="spai", dtype=np.float32)
    st = mt.classical_amg_setup(A, cfg, rp, device="cpu")
    for A_l in st.As[:-1]:
        S = sa_amg.strength_matrix(A_l, 0.4)
        for hops in (1, 2):
            assert np.array_equal(
                device_agg.device_aggregation(S, hops=hops),
                device_agg.device_aggregation(S, hops=hops, device="cpu"))
        Sc = classical_amg.strength_matrix_classical(A_l, 0.25)
        assert np.array_equal(device_agg.pmis_coloring(Sc),
                              device_agg.pmis_coloring(Sc, device="cpu"))


@pytest.mark.parametrize("coarsening", ["common-c", "pmis"])
def test_small_classical_solve_runs_through_kernel_d(coarsening):
    """64^2 rough-sigma classical AMG set up on the card (f32, 4 levels,
    SPAI V(2,2)) equals its CPU hierarchy and solves to a true relres of
    1e-8: kernel D runs in float32 and float64 and no plain version does;
    the common-C levels run the C++ coloring."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.setup import native
    _, A = _rough_sigma(64, seed=5)
    b = A @ np.random.RandomState(6).rand(A.shape[0])
    b /= np.linalg.norm(b)
    cfg, rp = mt.get_mg_param(levels=4, relax_type="spai", dtype=np.float32)
    calls = dict(native.CALLS)
    st = mt.classical_amg_setup(A, cfg, rp, coarsening=coarsening)
    st_cpu = mt.classical_amg_setup(A, cfg, rp, coarsening=coarsening,
                                    device="cpu")
    assert native.CALLS["cf_coloring"] - calls["cf_coloring"] == (
        2 * (st.num_levels - 1) if coarsening == "common-c" else 0)
    for a, a_cpu in zip(st.As, st_cpu.As):
        assert (a != a_cpu).nnz == 0
    assert type(st.hier.levels[0].A).__name__ == "DIA"
    before = (dict(stencil.LAUNCHES), dict(stencil.PLAIN_CALLS),
              dict(native.PLAIN_CALLS))
    x, info = mt.solve_mg_refined(st, b, tol=1e-8, max_iter=60)
    assert np.linalg.norm(b - A @ x.cpu().numpy()) < 1e-8, info["iters"]
    assert stencil.LAUNCHES["float32"] > before[0]["float32"]
    assert stencil.LAUNCHES["float64"] > before[0]["float64"]
    assert stencil.PLAIN_CALLS == before[1]
    assert native.PLAIN_CALLS == before[2]


# ---------------------------------------------------------------------------
# recorded programs (cycle/capture.py): CUDA graphs against the eager runs
# ---------------------------------------------------------------------------

def _capture_case(name):
    """(state, operator, f64 right-hand side) of a small configuration on
    the card: 3D Jacobi V(1,1) and SPAI V(2,2) at 32^3 (kernels A and B),
    2D line Jacobi at 64^2 (kernel C), rough-sigma DivSigGrad at 64^2
    (kernel D), its greedy SA on the flat engine (D on the DIA level, ELL
    levels, DenseLU) and its structured SA K-cycles (D, the projection's
    solve_ex)."""
    import mgtpu_torch as mt
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    if name in ("jacobi3d", "spai3d"):
        M = mt.get_regular_mesh([0.0, 1.0] * 3, [32, 32, 32])
        A = nodal_laplacian_matrix(M)
        A = (A + 1e-4 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
        kw = (dict(relax_type="jacobi", relax_param=0.8, nu_pre=1, nu_post=1)
              if name == "jacobi3d" else dict(relax_type="spai"))
    elif name == "line":
        n = 64
        T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n + 1, n + 1))
        I = sp.identity(n + 1)
        A = (sp.kron(I, 100.0 * T) + sp.kron(T, I)).tocsr() * n * n
        A = (A + 1e-4 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
        M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
        kw = dict(relax_type="line-jacobi", relax_param=0.8, nu_pre=1,
                  nu_post=1)
    else:
        M, A = _rough_sigma(64)
        kw = dict(relax_type="jacobi", relax_param=0.8, nu_pre=1, nu_post=1)
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b /= np.linalg.norm(b)
    if name == "sa-flat":
        cfg, rp = mt.get_mg_param(levels=4, relax_type="spai",
                                  dtype=np.float32)
        return mt.sa_amg_setup(A, cfg, rp), A, b
    if name == "sa-k":
        cfg, rp = mt.get_mg_param(levels=4, relax_type="jac-gmres",
                                  relax_param=1.0, nu_pre=1, nu_post=1,
                                  cycle_type="K", dtype=np.float32)
        return mt.sa_amg_setup(A, cfg, rp, mesh=M), A, b
    cfg, rp = mt.get_mg_param(levels=4, max_outer_iter=100,
                              relative_tol=1e-8, dtype=np.float32, **kw)
    return mt.mg_setup(A, M, cfg, rp), A, b


CAPTURE_CASES = ["jacobi3d", "spai3d", "line", "divsig", "sa-flat", "sa-k"]


def _counts():
    from mgtpu_torch.cycle.capture import kernel_counters
    return [dict(d) for d in kernel_counters()]


def _since(before):
    """Counter increments since `before` (launches and plain calls)."""
    from mgtpu_torch.cycle.capture import kernel_counters
    return [{k: v - b.get(k, 0) for k, v in d.items() if v != b.get(k, 0)}
            for d, b in zip(kernel_counters(), before)]


def _plain_calls(delta):
    from mgtpu_torch.cycle.capture import kernel_counters
    from mgtpu_torch.ops.cuda import const3d, fused3d, stencil, tridiag
    plain = [const3d.PLAIN_CALLS, fused3d.PLAIN_CALLS, tridiag.PLAIN_CALLS,
             stencil.PLAIN_CALLS]
    return sum(sum(inc.values()) for d, inc in zip(kernel_counters(), delta)
               if any(d is p for p in plain))


@pytest.mark.parametrize("name", CAPTURE_CASES)
def test_captured_cycle_replays_the_eager_cycle(name):
    """grid_cycle_jit / cycle_jit: the first call records, every call's x
    equals the eager cycle's bit for bit, and each replay counts the eager
    cycle's launches (three replays three times), no plain version."""
    _need_card()
    import torch
    from mgtpu_torch.cycle.cycle import make_cycle_fn, recursive_cycle
    from mgtpu_torch.cycle.grid_cycle import (GridHierarchy, grid_cycle,
                                              grid_cycle_jit)
    st, _, b = _capture_case(name)
    cfg, h = st.config, st.hier
    rng = np.random.RandomState(1)
    if isinstance(h, GridHierarchy):
        bg = torch.tensor(rng.rand(2, *h.fine_grid), dtype=torch.float32,
                          device="cuda")
        eager = lambda x, xz: grid_cycle(cfg, h, bg, x, x_zero=xz)
        rec = lambda x, xz: grid_cycle_jit(cfg, h, bg, x, xz)
    else:
        bg = torch.tensor(rng.rand(b.shape[0], 2), dtype=torch.float32,
                          device="cuda")
        eager = lambda x, xz: recursive_cycle(cfg, h, bg, x, x_zero=xz)
        rec = lambda x, xz: make_cycle_fn(cfg)(h, bg, x, xz)
    for xz in (True, False):
        x0 = torch.zeros_like(bg) if xz else torch.rand_like(bg)
        c0 = _counts()
        want = eager(x0, xz)
        torch.cuda.synchronize()
        per_cycle = _since(c0)
        assert sum(sum(d.values()) for d in per_cycle) > 0
        assert torch.equal(rec(x0, xz), want)           # records
        c1 = _counts()
        for _ in range(3):
            assert torch.equal(rec(x0, xz), want)       # replays
        torch.cuda.synchronize()
        got = _since(c1)
        assert got == [{k: 3 * v for k, v in d.items()} for d in per_cycle]
        assert _plain_calls(got) == 0


def _spans_of_a_call(solve):
    """solve()'s result and the names of the spans it opened."""
    from mgtpu_torch import spans
    spans.drain()
    spans.enable()
    try:
        out = solve()
    finally:
        spans.disable()
    return out, [r[0] for r in spans.drain()]


def _loop_forms(owner):
    """The forms the recorded loops of `owner` took: "while" or
    "chunks"."""
    from mgtpu_torch.cycle import capture
    return [("chunks" if p.chunked else "while")
            for p in capture.programs(owner).table.values()
            if isinstance(p, capture.Loop)]


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("name", CAPTURE_CASES)
def test_captured_refined_loop_is_the_eager_loop(name, chunk, monkeypatch):
    """solve_mg_refined's device loop against the eager loop on the card:
    count, residual history and x bit for bit, at the recording and at a
    replay.  Every engine's loop takes the while form (one graph, one
    `program.device_loop` span a call; CHUNK changes nothing there): the
    flat engine's DenseLU coarsest records no library workspace."""
    _need_card()
    import torch
    import mgtpu_torch as mt
    monkeypatch.setattr(mt.krylov._loop, "CHUNK", chunk)
    st, A, b = _capture_case(name)
    x1, i1 = mt.solve_mg_refined(st, b, tol=1e-8, max_iter=80)
    (x1b, i1b), names = _spans_of_a_call(
        lambda: mt.solve_mg_refined(st, b, tol=1e-8, max_iter=80))
    x0, i0 = mt.solve_mg_refined(st, b, tol=1e-8, max_iter=80,
                                 device_loop=False)
    assert i1["iters"] == i1b["iters"] == i0["iters"]
    assert np.array_equal(i1["resvec"], i0["resvec"])
    assert np.array_equal(i1b["resvec"], i0["resvec"])
    assert torch.equal(x1, x0) and torch.equal(x1b, x0)
    assert _loop_forms(st.hier) == ["while"]
    assert names.count("program.device_loop") == 1
    assert names.count("program.replay") == 1
    assert "program.record" not in names
    assert np.linalg.norm(b - A @ x1.cpu().numpy()) < 1e-8


@pytest.mark.parametrize("method", ["cg", "bicgstab", "block-cg", "gmres"])
def test_captured_krylov_is_the_eager_loop(method):
    """The Krylov solves' recorded loops (CG, BiCGSTAB, block CG: the
    while form, one `program.device_loop` span a call; GMRES: a program a
    restart) against their eager loops on the 64^2 rough-sigma problem,
    f64 outer iteration over an f32 hierarchy: count, history and x bit
    for bit, at the recording and at a replay; each loop counts one
    set_cond launch more than its iterations."""
    _need_card()
    import torch
    import mgtpu_torch as mt
    from mgtpu_torch.ops.cuda import device_loop
    st, A, b = _capture_case("divsig")
    B = (np.random.RandomState(4).rand(A.shape[0], 4)
         if method == "block-cg" else b)
    solve = {"cg": mt.solve_cg_mg, "block-cg": mt.solve_cg_mg,
             "bicgstab": mt.solve_bicgstab_mg,
             "gmres": mt.solve_gmres_mg}[method]
    kw = dict(block=True) if method == "block-cg" else {}
    x1, i1 = solve(st, B, **kw)
    before = device_loop.LAUNCHES["set_cond"]
    (x2, i2), names = _spans_of_a_call(lambda: solve(st, B, **kw))
    x0, i0 = solve(st, B, device_loop=False, **kw)
    k = int(i0["iters"])
    assert int(i1["iters"]) == int(i2["iters"]) == k
    r1, r2, r0 = (np.asarray(torch.as_tensor(i["resvec"]).cpu())
                  for i in (i1, i2, i0))
    assert np.array_equal(r1, r0) and np.array_equal(r2, r0)
    assert torch.equal(x1, x0) and torch.equal(x2, x0)
    loops = 0 if method == "gmres" else 1
    assert _loop_forms(st.hier) == ["while"] * loops
    assert names.count("program.device_loop") == loops
    assert device_loop.LAUNCHES["set_cond"] - before == loops * (k + 1)
    rr = np.linalg.norm(B - A @ x1.cpu().numpy(), axis=0)
    assert np.all(rr < 1e-8 * np.linalg.norm(B, axis=0))


@pytest.mark.parametrize("case", ["max_iter", "divergence"])
def test_while_form_stops_where_the_eager_loop_stops(case):
    """The while form stops on the eager loop's iteration: at a max_iter
    short of convergence (refined, CG) and, over-relaxed Jacobi (omega
    2.6), at the first residual above 1e3 ||b|| (refined); count, history
    and x bit for bit, one `program.device_loop` a call."""
    _need_card()
    import torch
    import mgtpu_torch as mt
    if case == "max_iter":
        st, A, b = _capture_case("divsig")
        solves = [lambda **kw: mt.solve_mg_refined(st, b, tol=1e-14,
                                                   max_iter=7, **kw)]
        st.config = __import__("dataclasses").replace(st.config,
                                                      max_outer_iter=5)
        solves.append(lambda **kw: mt.solve_cg_mg(st, b, **kw))
        want = [7, 5]
    else:
        from mgtpu_torch.models.operators import nodal_laplacian_matrix
        M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [32, 32])
        A = nodal_laplacian_matrix(M)
        A = (A + 1e-4 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
        b = A @ np.random.RandomState(0).rand(A.shape[0])
        b /= np.linalg.norm(b)
        cfg, rp = mt.get_mg_param(levels=3, relax_type="jacobi",
                                  relax_param=2.6, nu_pre=2, nu_post=2,
                                  dtype=np.float32)
        st = mt.mg_setup(A, M, cfg, rp)
        solves = [lambda **kw: mt.solve_mg_refined(st, b, tol=1e-8,
                                                   max_iter=60, **kw)]
        want = [None]
    for solve, k in zip(solves, want):
        solve()                                         # records
        (x1, i1), names = _spans_of_a_call(solve)
        x0, i0 = solve(device_loop=False)
        assert int(i1["iters"]) == int(i0["iters"])
        if k is not None:
            assert int(i0["iters"]) == k
        else:
            assert int(i0["iters"]) < 60 and i0["resvec"][-1] >= 1e3
        r1, r0 = (np.asarray(torch.as_tensor(i["resvec"]).cpu())
                  for i in (i1, i0))
        assert np.array_equal(r1, r0) and torch.equal(x1, x0)
        assert names.count("program.device_loop") == 1


@pytest.mark.parametrize("ctype,segments", [("V", 2), ("W", 3)])
@pytest.mark.parametrize("engine", ["grid", "flat"])
def test_sparse_lu_cycle_records_in_segments(engine, ctype, segments,
                                             monkeypatch):
    """A host SuperLU coarsest splits the recorded cycle: a V-cycle in two
    graphs around one host step, a W-cycle of three levels in three; the
    replayed cycle equals the eager one bit for bit.  The refined loop
    around it stays on chunks (a program of CHUNK iterations a chunk, no
    `program.device_loop`)."""
    _need_card()
    import torch
    import mgtpu_torch as mt
    from mgtpu_torch.cycle import capture
    from mgtpu_torch.cycle import grid_cycle as gc
    from mgtpu_torch.cycle.cycle import cycle_jit, recursive_cycle
    monkeypatch.setattr(gc, "HOST_INV_MAX", 16)
    monkeypatch.setattr(gc, "DENSE_LU_MAX", 16)
    M, A = _rough_sigma(64)
    cfg, rp = mt.get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                              nu_pre=1, nu_post=1, cycle_type=ctype,
                              engine=engine, dtype=np.float32)
    st = mt.mg_setup(A, M, cfg, rp)
    assert type(st.hier.coarse).__name__ in ("GridSparseLU", "SparseLUCoarse")
    bf = torch.tensor(np.random.RandomState(2).rand(A.shape[0], 1),
                      dtype=torch.float32, device="cuda")
    x0 = torch.zeros_like(bf)
    want = recursive_cycle(cfg, st.hier, bf, x0, x_zero=True)
    for _ in range(2):
        assert torch.equal(cycle_jit(cfg, st.hier, bf, x0, True), want)
    table = capture.programs(st.hier).table
    assert [c.segments for c in table.values()] == [segments]
    x1, i1 = mt.solve_mg_refined(st, A @ np.ones(A.shape[0]), tol=1e-8,
                                 max_iter=60)
    (x1b, _), names = _spans_of_a_call(
        lambda: mt.solve_mg_refined(st, A @ np.ones(A.shape[0]), tol=1e-8,
                                    max_iter=60))
    x0r, i0 = mt.solve_mg_refined(st, A @ np.ones(A.shape[0]), tol=1e-8,
                                  max_iter=60, device_loop=False)
    assert i1["iters"] == i0["iters"] and torch.equal(x1, x0r)
    assert torch.equal(x1b, x0r)
    # a host step keeps the refined loop on chunks: no while form
    assert _loop_forms(st.hier) == ["chunks"]
    assert "program.device_loop" not in names
    assert names.count("program.replay") == math.ceil(
        i0["iters"] / mt.krylov._loop.CHUNK)


@pytest.mark.parametrize("host_lu", [False, True])
def test_program_spans_across_a_record_and_two_replays(host_lu, monkeypatch):
    """mgtpu_torch.spans on the card: a recorded cycle's first call
    records once and replays, two more calls replay; each replay runs its
    graphs (two around a host SuperLU step).  A refined and a CG solve
    after their recordings (the while form): one graph a call, 4 and 1
    host reads (the count, and the refined solve's residuals and
    history), no recording."""
    _need_card()
    from collections import Counter

    import torch
    import mgtpu_torch as mt
    from mgtpu_torch import spans
    from mgtpu_torch.cycle import grid_cycle as gc
    from mgtpu_torch.krylov import _loop
    if host_lu:
        monkeypatch.setattr(gc, "HOST_INV_MAX", 16)
        monkeypatch.setattr(gc, "DENSE_LU_MAX", 16)
    M, A = _rough_sigma(64)
    cfg, rp = mt.get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                              nu_pre=1, nu_post=1, relative_tol=1e-8,
                              max_outer_iter=100, dtype=np.float32)
    st = mt.mg_setup(A, M, cfg, rp)
    seg = 2 if host_lu else 1
    bf = torch.tensor(np.random.RandomState(2).rand(1, *st.hier.fine_grid),
                      dtype=torch.float32, device="cuda")
    x0 = torch.zeros_like(bf)
    names = ("program.record", "program.replay", "program.host_step",
             "host_read")

    def counted():
        c = Counter(r[0] for r in spans.drain())
        return tuple(c[n] for n in names)

    spans.drain()
    spans.enable()
    try:
        gc.grid_cycle_jit(cfg, st.hier, bf, x0, True)
        assert counted() == (1, 1, seg - 1, 0)
        for _ in range(2):
            gc.grid_cycle_jit(cfg, st.hier, bf, x0, True)
        torch.cuda.synchronize()
        assert counted() == (0, 2, 2 * (seg - 1), 0)
        if host_lu:
            return
        b = A @ np.random.RandomState(4).rand(A.shape[0])
        b /= np.linalg.norm(b)
        for solve, reads in ((mt.solve_mg_refined, 4), (mt.solve_cg_mg, 1)):
            solve(st, b)                                # records
            spans.drain()
            x, info = solve(st, b)
            assert int(info["iters"]) > _loop.CHUNK
            assert counted() == (0, 1, 0, reads)
    finally:
        spans.disable()
        spans.drain()


def test_capture_failure_raises():
    """A function that reads the card's memory on the host cannot be
    recorded: the program raises with torch's message instead of running
    eagerly, the card stays usable, and the owner's next program
    records."""
    _need_card()
    import torch
    from mgtpu_torch.cycle import capture

    def reads_back(ctx, x):
        return x * float(x.sum())

    class Owner:
        pass

    x = torch.ones(8, device="cuda")
    for owner in (None, Owner()):
        with pytest.raises(RuntimeError, match="captur"):
            capture.run(owner, "bad", reads_back, None, x)
        assert float((x + 1).sum()) == 16.0
        # the owner's next program records (in a new pool)
        y = capture.run(owner, "good", lambda ctx, v: v * 2, None, x)
        assert torch.equal(y, 2 * x)


def test_new_tolerance_replays_the_recorded_loop():
    """tol and max_iter's bound are device scalars: a solve to a new
    tolerance replays the loop recorded for the old one (no recording, one
    `program.device_loop`), and stops where the eager loop does."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.cycle import capture
    st, A, b = _capture_case("divsig")
    _, i1 = mt.solve_mg_refined(st, b, tol=1e-6, max_iter=80)
    keys = set(capture.programs(st.hier).table)
    (_, i2), names = _spans_of_a_call(
        lambda: mt.solve_mg_refined(st, b, tol=1e-9, max_iter=80))
    _, i0 = mt.solve_mg_refined(st, b, tol=1e-9, max_iter=80,
                                device_loop=False)
    assert set(capture.programs(st.hier).table) == keys
    assert "program.record" not in names
    assert names.count("program.device_loop") == 1
    assert i2["iters"] > i1["iters"] and i2["relres"] < 1e-9
    assert i2["iters"] == i0["iters"]
    assert np.array_equal(i2["resvec"], i0["resvec"])


class _CountingFactor:
    """A SuperLU factor that counts its solves."""

    def __init__(self, factor):
        self.factor, self.calls = factor, 0

    def solve(self, *args, **kwargs):
        self.calls += 1
        return self.factor.solve(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.factor, name)


@pytest.mark.parametrize("engine", ["grid", "flat"])
def test_masked_iterations_skip_the_host_solve(engine, monkeypatch):
    """Past the stop, a recorded chunk's masked iterations skip their host
    SuperLU solves: a replayed refined solve and a replayed CG solve call
    the factor as often as their eager loops (chunks of 16, counts that
    are no multiple of 16)."""
    _need_card()
    import torch
    import mgtpu_torch as mt
    from mgtpu_torch.cycle import grid_cycle as gc
    monkeypatch.setattr(gc, "HOST_INV_MAX", 16)
    monkeypatch.setattr(gc, "DENSE_LU_MAX", 16)
    monkeypatch.setattr(mt.krylov._loop, "CHUNK", 16)
    M, A = _rough_sigma(64)
    cfg, rp = mt.get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                              nu_pre=1, nu_post=1, engine=engine,
                              max_outer_iter=100, relative_tol=1e-8,
                              dtype=np.float32)
    st = mt.mg_setup(A, M, cfg, rp)
    counting = _CountingFactor(st.hier.coarse.factor)
    object.__setattr__(st.hier.coarse, "factor", counting)
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b /= np.linalg.norm(b)
    for solve in (lambda **kw: mt.solve_mg_refined(st, b, tol=1e-8,
                                                   max_iter=60, **kw),
                  lambda **kw: mt.solve_cg_mg(st, b, **kw)):
        solve()                                 # records
        calls = []
        for mode in (True, False):
            counting.calls = 0
            x, info = solve(device_loop=mode)
            torch.cuda.synchronize()
            calls.append(counting.calls)
        assert int(info["iters"]) % 16 != 0
        assert calls[0] == calls[1] > 0, calls


# ---------------------------------------------------------------------------
# the staggered-systems engine: kernel D's cross apply and kernel E
# ---------------------------------------------------------------------------

def _elasticity_csr(dims, mixed):
    import mgtpu_torch as mt
    from mgtpu_torch.models.operators import (
        linear_elasticity_operator, linear_elasticity_operator_mixed)
    M = mt.get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    mu = np.ones(M.num_cells)
    A = (linear_elasticity_operator_mixed if mixed
         else linear_elasticity_operator)(M, mu, mu)
    A = (A + 1e-3 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    return M, A


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dims", [(24, 17), (9, 12, 7)])
def test_cross_apply_matches_plain(dims, dtype):
    """Every block of a mixed elasticity operator (square and cross) on
    kernel D against its plain version, m = 1, 2, 5; the square blocks
    bitwise grid_apply."""
    _need_card()
    from mgtpu_torch.cycle.systems_grid import block_operator_from_csr
    from mgtpu_torch.ops.cuda import stencil
    tol = 2e-5 if dtype == np.float32 else 1e-12
    key = np.dtype(dtype).name
    _, A = _elasticity_csr(dims, True)
    op = block_operator_from_csr(A, list(dims), True, dtype=dtype,
                                 device="cuda")
    assert any(s.in_grid != s.out_grid for s in op.stencils)
    for S in op.stencils:
        for m in (1, 2, 5):
            x = torch.tensor(np.random.RandomState(m).rand(m, *S.in_grid),
                             dtype=S.coeff.dtype, device="cuda")
            n0, p0 = stencil.LAUNCHES[key], stencil.PLAIN_CALLS[key]
            y = S.matvec(x)
            torch.cuda.synchronize()
            assert stencil.LAUNCHES[key] == n0 + 1
            assert stencil.PLAIN_CALLS[key] == p0
            ref = stencil.cross_apply_plain(S.coeff, S.offsets, S.in_grid, x)
            assert y.shape == (m,) + S.out_grid
            err = float((y - ref).abs().max() / ref.abs().max())
            assert err < tol, (S.offsets, m, err)
            if S.in_grid == S.out_grid:
                assert torch.equal(y, stencil.grid_apply(S.coeff, S.offsets,
                                                         x))
    xs = tuple(torch.rand((2,) + g, dtype=op.dtype, device="cuda")
               for g in op.grids)
    from mgtpu_torch.cycle.systems_grid import fields_to_block
    got = fields_to_block(op.matvec(xs)).cpu().numpy()
    want = A @ fields_to_block(xs).cpu().numpy().astype(np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < tol * 10


def _block_fields(grids, m, dt, seed):
    rng = np.random.RandomState(seed)
    return tuple(_crand(rng, (m,) + tuple(g), dt) if dt.is_complex else
                 torch.tensor(rng.rand(m, *g), dtype=dt, device="cuda")
                 for g in grids)


def _per_block_path(op, xs, bs, apply):
    """What a block operator's residual was before the block form: one
    launch of `apply(coeff, taps, in_grid, x)` a block (cross_apply or
    halo_apply), torch's adds in block order, torch's subtraction."""
    g = len(op.grids[0])
    ys = [None] * len(op.grids)
    for (ci, cj), coeff, offs in zip(op.pairs, op.block_coeffs,
                                     op.block_offsets):
        t = apply(coeff, offs, tuple(xs[cj].shape[-g:]), xs[cj])
        ys[ci] = t if ys[ci] is None else ys[ci] + t
    ys = tuple(xs[0].new_zeros((xs[0].shape[0],) + tuple(gr)) if y is None
               else y for y, gr in zip(ys, op.grids))
    return ys, tuple(b - y for b, y in zip(bs, ys))


def _check_block_form(op, xs, bs, apply, tol):
    """op's block apply and residual: one launch each, counted in
    BLOCK_LAUNCHES and not in CROSS_LAUNCHES or HALO_LAUNCHES, bitwise
    the per-block path, within `tol` of the plain version."""
    from mgtpu_torch.ops.cuda import stencil
    key = str(xs[0].dtype).rsplit(".", 1)[-1]
    before = [dict(d) for d in (stencil.LAUNCHES, stencil.BLOCK_LAUNCHES,
                                stencil.CROSS_LAUNCHES,
                                stencil.HALO_LAUNCHES, stencil.PLAIN_CALLS)]
    y = stencil.block_apply(op, xs)
    r = stencil.block_apply(op, xs, bs)
    torch.cuda.synchronize()
    after = (stencil.LAUNCHES, stencil.BLOCK_LAUNCHES, stencil.CROSS_LAUNCHES,
             stencil.HALO_LAUNCHES, stencil.PLAIN_CALLS)
    assert [a[key] - b[key] for a, b in zip(after, before)] == [2, 2, 0, 0,
                                                                0]
    y_old, r_old = _per_block_path(op, xs, bs, apply)
    y_pl, r_pl = (stencil.block_apply_plain(op, xs, v) for v in (None, bs))
    torch.cuda.synchronize()
    for a, b in zip(y + r, y_old + r_old):
        assert torch.equal(a, b)
    for a, b in zip(y + r, y_pl + r_pl):
        assert float((a - b).abs().max() / b.abs().max()) < tol


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
@pytest.mark.parametrize("dims,mixed", [((32, 32), True), ((32, 32), False),
                                        ((8, 8, 8), True)])
def test_block_form_matches_per_block_path(dims, mixed, dtype):
    """Kernel D's block form on every level of a systems hierarchy set up
    on the card (the Galerkin levels' 9-36 taps take splits 2-8): its
    apply and residual, m = 1, 2, 5, one launch each, bitwise the per-block
    cross applies, adds and subtraction; within 2e-5 / 1e-12 of the
    plain version."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.config import torch_dtype
    from mgtpu_torch.ops.cuda import stencil
    M, A = _elasticity_csr(dims, mixed)
    if np.dtype(dtype).kind == "c":
        A = (A + 1e-3j * abs(A).sum(0).max() * sp.identity(A.shape[0])
             ).tocsr()
    cfg, rp = mt.get_mg_param(
        levels=3, relax_type="VankaFaces" if mixed else "SPAI",
        relax_param=0.75, dtype=dtype, transfer_type=(
            "SystemsFacesMixedLinear" if mixed else "SystemsFacesLinear"))
    st = mt.mg_setup(A, M, cfg, rp)
    dt = torch_dtype(dtype)
    tol = 2e-5 if dt in (torch.float32, torch.complex64) else 1e-12
    splits = set()
    for l, lv in enumerate(st.hier.levels):
        op = lv.A
        splits |= set(stencil.block_table_parts(op.block_table)[1][:, 5])
        for m in (1, 2, 5):
            _check_block_form(op, _block_fields(op.grids, m, dt, l + m),
                              _block_fields(op.grids, m, dt, 10 + l + m),
                              stencil.cross_apply, tol)
    assert max(splits) > 1


@pytest.mark.parametrize("dtype,low", [(np.float64, torch.float32),
                                       (np.complex128, torch.complex64)])
def test_block_form_of_a_cast_copy(dtype, low):
    """A cast_hierarchy copy (what solve_mg_refined(cycle_dtype=low)
    cycles on) applies its own coefficients: its block residual on every
    level is bitwise its own per-block path and within 2e-5 of its plain
    version, and the original's block residual is unchanged."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.config import torch_dtype
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.solvers.mg_solver import cast_hierarchy
    M, A = _elasticity_csr((32, 32), True)
    if np.dtype(dtype).kind == "c":
        A = (A + 1e-3j * abs(A).sum(0).max() * sp.identity(A.shape[0])
             ).tocsr()
    cfg, rp = mt.get_mg_param(levels=3, relax_type="VankaFaces",
                              relax_param=0.75, dtype=dtype,
                              transfer_type="SystemsFacesMixedLinear")
    hi = mt.mg_setup(A, M, cfg, rp).hier
    dt = torch_dtype(dtype)
    for lv in hi.levels:
        lv.A.block_table            # made before the copy, as in a solve
    lo = cast_hierarchy(hi, low)
    for l, (lh, ll) in enumerate(zip(hi.levels, lo.levels)):
        assert ll.A.block_coeffs[0].dtype == low
        _check_block_form(ll.A, _block_fields(ll.A.grids, 2, low, l),
                          _block_fields(ll.A.grids, 2, low, 10 + l),
                          stencil.cross_apply, 2e-5)
        _check_block_form(lh.A, _block_fields(lh.A.grids, 2, dt, l),
                          _block_fields(lh.A.grids, 2, dt, 10 + l),
                          stencil.cross_apply, 1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [1, 3])
def test_lex_sweep_kernel_matches_plain(dtype, m, monkeypatch):
    """Kernel E (one launch, two sweeps) against its plain per-cell loop on
    a 16^2 mixed problem's vanka-lex tables."""
    _need_card()
    from mgtpu_torch.ops.cuda import vanka as vk
    from mgtpu_torch.setup.smoothers import setup_vanka
    M, A = _elasticity_csr((16, 16), True)
    vr = setup_vanka(A, M, 0.75, True, "vanka-lex", dtype=dtype).to(
        torch.float64 if dtype == np.float64 else torch.float32, "cuda")
    rng = np.random.RandomState(m)
    x = torch.tensor(rng.rand(A.shape[0], m), dtype=vr.rows_val.dtype,
                     device="cuda")
    b = torch.tensor(rng.rand(A.shape[0], m), dtype=x.dtype, device="cuda")
    args = (vr.idx[0], vr.dinv[0], vr.rows_idx[0], vr.rows_val[0], 2)
    key = np.dtype(dtype).name
    n0, p0 = vk.LAUNCHES[key], vk.PLAIN_CALLS[key]
    f0 = dict(vk.FORMS)
    y = vk.lex_sweep(x, b, *args)
    torch.cuda.synchronize()
    assert vk.LAUNCHES[key] == n0 + 1 and vk.PLAIN_CALLS[key] == p0
    assert vk.FORMS["smem_b"] == f0["smem_b"] + 1  # x and b fit at 16^2
    ref = vk.lex_sweep_plain(x, b, *args)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert float((y - ref).abs().max() / ref.abs().max()) < tol
    assert not torch.equal(y, x)
    _lex_forms_agree(x, b, args, y, monkeypatch)
    with pytest.raises(ValueError):
        vk.lex_sweep(x, b, vr.idx[0].long(), *args[1:])


def _lex_forms_agree(x, b, args, y, monkeypatch):
    """b gathered a cell at a time ("smem") and x left in global memory
    ("global"), taken where they fit once shared memory is capped at what
    that form needs, do the arithmetic of y bit for bit."""
    from mgtpu_torch.ops.cuda import vanka as vk
    (L, bs), K = args[0].shape, args[2].shape[-1]
    n, m = x.shape
    ditem = 8 if x.dtype.is_complex else 4
    for form in ("smem", "global"):
        need = vk.smem_bytes(bs, K, m, n, x.element_size(), ditem, form)
        if need > vk.MAX_SHARED:
            continue
        monkeypatch.setattr(vk, "MAX_SHARED", need)
        f0 = vk.FORMS[form]
        assert torch.equal(vk.lex_sweep(x, b, *args), y), form
        assert vk.FORMS[form] == f0 + 1
        monkeypatch.undo()


@pytest.mark.parametrize("dims,m", [((16, 16), 7), ((16, 16), 13),
                                    ((6, 6, 6), 5)])
def test_lex_sweep_splits_right_hand_sides(dims, m):
    """More right-hand sides than one warp walks a cell with (bs * m > 32:
    2D bs 5 at m 7 and 13, 3D bs 7 at m 5) run as launches of at most
    32 // bs columns each, and match the plain loop (1e-12) and the
    single-column launches bit for bit."""
    _need_card()
    from mgtpu_torch.ops.cuda import vanka as vk
    from mgtpu_torch.setup.smoothers import setup_vanka
    M, A = _elasticity_csr(dims, True)
    vr = setup_vanka(A, M, 0.75, True, "vanka-lex").to(torch.float64,
                                                        "cuda")
    bs = vr.idx.shape[-1]
    assert bs * m > 32
    rng = np.random.RandomState(m)
    x, b = (torch.tensor(rng.rand(A.shape[0], m), device="cuda")
            for _ in range(2))
    args = (vr.idx[0], vr.dinv[0], vr.rows_idx[0], vr.rows_val[0], 2)
    n0 = vk.LAUNCHES["float64"]
    y = vk.lex_sweep(x, b, *args, cells=vr.cells)
    torch.cuda.synchronize()
    assert vk.LAUNCHES["float64"] == n0 + -(-m // (32 // bs))
    ref = vk.lex_sweep_plain(x, b, *args)
    assert float((y - ref).abs().max() / ref.abs().max()) < 1e-12
    for r in (0, m - 1):
        assert torch.equal(y[:, r:r + 1], vk.lex_sweep(
            x[:, r:r + 1], b[:, r:r + 1], *args, cells=vr.cells))


@pytest.mark.parametrize("kind,dtype,low", [
    ("vanka-lex", np.float64, torch.float32),
    ("vanka-lex", np.complex128, torch.complex64),
    ("kaczmarz", np.float64, torch.float32),
    ("kaczmarz", np.complex128, torch.complex64)])
def test_cast_smoother_sweeps_with_its_own_records(kind, dtype, low):
    """cast_hierarchy's copy of a kernel E or F state (what the cycles of
    solve_mg_refined(cycle_dtype=low) run on) carries records of its own
    values: its sweep on the card matches the plain sweep of the cast
    tables (1e-5 / 2e-5), and the original state's records refuse the cast
    values."""
    _need_card()
    from mgtpu_torch.config import torch_dtype
    from mgtpu_torch.solvers.mg_solver import cast_hierarchy
    dt = torch_dtype(dtype)
    rng = np.random.RandomState(7)
    cplx = np.dtype(dtype).kind == "c"
    draw = (lambda n: _crand(rng, (n, 2), low)) if cplx else (
        lambda n: torch.tensor(rng.rand(n, 2), dtype=low, device="cuda"))
    if kind == "vanka-lex":
        import mgtpu_torch as mt
        from mgtpu_torch.cycle.vanka import vanka_sweep
        from mgtpu_torch.ops.cuda import vanka as vk
        from mgtpu_torch.setup.smoothers import setup_vanka
        if cplx:
            A = _rest_script().elasticity(16, True)
            M = mt.get_regular_mesh([0.0, 1.0] * 2, [16, 16])
        else:
            M, A = _elasticity_csr((16, 16), True)
        hi = setup_vanka(A, M, 0.75, True, "vanka-lex", dtype=dtype).to(
            dt, "cuda")
        lo = cast_hierarchy(hi, low)
        tabs = (lo.idx[0], lo.dinv[0], lo.rows_idx[0], lo.rows_val[0])
        assert lo.rows_val.dtype == low and lo.cells is not hi.cells
        assert lo.cells.of(*tabs) and not hi.cells.of(*tabs)
        x, b = draw(A.shape[0]), draw(A.shape[0])
        n0 = vk.LAUNCHES[str(low).rsplit(".", 1)[-1]]
        y = vanka_sweep(x, b, lo, 2)
        assert vk.LAUNCHES[str(low).rsplit(".", 1)[-1]] == n0 + 1
        ref = vk.lex_sweep_plain(x, b, *tabs, 2)
        tol = 1e-5
        with pytest.raises(ValueError):
            vk.lex_sweep(x, b, *tabs, 2, cells=hi.cells)
    else:
        from mgtpu_torch.cycle.kaczmarz import (kaczmarz_sweep,
                                                setup_hybrid_kaczmarz)
        from mgtpu_torch.dd.indices import nodal_indices_of_box
        from mgtpu_torch.ops.cuda import kaczmarz as kf
        if cplx:
            M, A = _helmholtz([37, 37], 0.25)
            hi = setup_hybrid_kaczmarz(A, M, [3, 2], nodal_indices_of_box,
                                       0.8, 2, dtype=dtype)
        else:
            A, hi = _kaczmarz_state(37, [3, 2], dtype)
        hi = hi.to(dt, "cuda")
        lo = cast_hierarchy(hi, low)
        assert lo.ell_val.dtype == low and lo.records is not hi.records
        assert lo.records.of(lo.plan, lo.ell_val, lo.invd)
        assert not hi.records.of(lo.plan, lo.ell_val, lo.invd)
        x, b = draw(A.shape[0]), draw(A.shape[0])
        n0 = kf.LAUNCHES[str(low).rsplit(".", 1)[-1]]
        y = kaczmarz_sweep(x, b, lo, 2)
        assert kf.LAUNCHES[str(low).rsplit(".", 1)[-1]] == n0 + 1
        ref = kf.kaczmarz_sweep_plain(x, b, lo.arr, lo.mask, lo.invd,
                                      lo.ell_idx, lo.ell_val, 2)
        tol = 2e-5
        with pytest.raises(ValueError):
            kf.kaczmarz_sweep_kernel(x, b, lo.arr, lo.mask, lo.invd,
                                     lo.ell_idx, lo.ell_val, lo.link, 2,
                                     plan=lo.plan, records=hi.records)
    torch.cuda.synchronize()
    assert float((y - ref).abs().max() / ref.abs().max()) < tol


@pytest.mark.parametrize("relax,mixed", [("vanka", True), ("spai", False),
                                         ("vanka-lex", True),
                                         ("vanka-add", True),
                                         ("kaczmarz-vanka", True)])
def test_small_systems_solves_on_the_card(relax, mixed):
    """32^2 refined solves on the card take the CPU's count; the systems
    engine's blocks run on kernel D in f32 and f64 (the flat engine's ELL
    levels in plain torch, the lex smoother on kernel E), with no plain
    call of a kernel; recorded = eager bit for bit."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.cuda import vanka as vk
    # cell Kaczmarz as chip_smoke.py runs it: 64^2, 4 levels, 0.9 V(2,2)
    # (at 32^2 it does not reach 1e-8 in 60 refined iterations)
    kacz = relax == "kaczmarz-vanka"
    M, A = _elasticity_csr((64, 64) if kacz else (32, 32), mixed)
    nu = 2 if kacz else 1
    cfg, rp = mt.get_mg_param(
        levels=4 if kacz else 3, relax_type=relax,
        relax_param=0.9 if kacz else 0.75, nu_pre=nu, nu_post=nu,
        transfer_type="systems-faces-mixed" if mixed else "systems-faces",
        dtype=np.float32, max_outer_iter=60)
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b /= np.linalg.norm(b)
    counts = {}
    for dev in ("cpu", "cuda"):
        st = mt.mg_setup(A, M, cfg, rp, device=dev)
        before = (dict(stencil.LAUNCHES), dict(stencil.PLAIN_CALLS),
                  dict(vk.LAUNCHES), dict(vk.PLAIN_CALLS))
        x, info = mt.solve_mg_refined(st, b, tol=1e-8, max_iter=60)
        counts[dev] = info["iters"]
        xh = x.cpu().numpy()
        assert np.linalg.norm(b - A @ xh) / np.linalg.norm(b) < 1e-8
    assert abs(counts["cuda"] - counts["cpu"]) <= 1
    assert stencil.PLAIN_CALLS == before[1] and vk.PLAIN_CALLS == before[3]
    d = {k: stencil.LAUNCHES[k] - before[0][k] for k in stencil.LAUNCHES}
    systems = relax in ("vanka", "spai", "vanka-add")   # else flat ELL
    assert (d["float32"] > 0 and d["float64"] > 0) == systems
    if relax == "vanka-lex":
        assert vk.LAUNCHES["float32"] > before[2]["float32"]
    xe, info_e = mt.solve_mg_refined(st, b, tol=1e-8, max_iter=60,
                                     device_loop=False)
    assert info_e["iters"] == info["iters"] and torch.equal(xe, x)


# ---------------------------------------------------------------------------
# kernel F (hybrid Kaczmarz), the direct tier
# ---------------------------------------------------------------------------

def _kaczmarz_state(n, ndom, dtype):
    import mgtpu_torch as mt
    from mgtpu_torch.cycle.kaczmarz import setup_hybrid_kaczmarz
    from mgtpu_torch.dd.indices import nodal_indices_of_box
    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    A = nodal_div_sig_grad_matrix(
        M, np.exp(np.random.RandomState(3).randn(M.num_cells)))
    A = (A + 1e-4 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    return A, setup_hybrid_kaczmarz(A, M, ndom, nodal_indices_of_box, 0.8,
                                    2, dtype=dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [1, 3])
def test_kaczmarz_kernel_matches_plain(dtype, m):
    """Kernel F against its plain version (f32 2e-5, f64 1e-12), on ragged
    domains ((3, 2) boxes of a 37^2 mesh: padded steps); a second launch
    is bitwise the first; it refuses what it does not take, records of
    other values included."""
    _need_card()
    from mgtpu_torch.cycle.kaczmarz import kaczmarz_sweep
    from mgtpu_torch.ops.cuda import kaczmarz as kf
    A, kz = _kaczmarz_state(37, [3, 2], dtype)
    assert (kz.mask == 0).any()
    dt = torch.float32 if dtype == np.float32 else torch.float64
    kd = kz.to(dt, "cuda")
    rng = np.random.RandomState(m)
    x = torch.tensor(rng.rand(A.shape[0], m), dtype=dt, device="cuda")
    b = torch.tensor(rng.rand(A.shape[0], m), dtype=dt, device="cuda")
    before = kf.LAUNCHES[str(dt).rsplit(".", 1)[-1]]
    y = kaczmarz_sweep(x, b, kd, 2)
    y2 = kaczmarz_sweep(x, b, kd, 2)
    torch.cuda.synchronize()
    assert kf.LAUNCHES[str(dt).rsplit(".", 1)[-1]] == before + 2
    assert torch.equal(y, y2)
    ref = kf.kaczmarz_sweep_plain(x, b, kd.arr, kd.mask, kd.invd,
                                  kd.ell_idx, kd.ell_val, 2)
    tol = 2e-5 if dtype == np.float32 else 1e-12
    assert float((y - ref).abs().max() / ref.abs().max()) < tol
    _kaczmarz_refuses_other_values(kd, x, b)
    with pytest.raises(ValueError):
        kaczmarz_sweep(torch.zeros((A.shape[0], 5), dtype=dt, device="cuda"),
                       torch.zeros((A.shape[0], 5), dtype=dt, device="cuda"),
                       kd)


def _kaczmarz_refuses_other_values(kd, x, b):
    """Kernel F given the state's records beside other values raises."""
    from mgtpu_torch.ops.cuda import kaczmarz as kf
    with pytest.raises(ValueError):
        kf.kaczmarz_sweep_kernel(x, b, kd.arr, kd.mask, kd.invd, kd.ell_idx,
                                 kd.ell_val.clone(), kd.link, 2,
                                 plan=kd.plan, records=kd.records)


def test_hybrid_kaczmarz_solve_runs_through_kernel_f():
    """A small hybrid-Kaczmarz hierarchy on the card: solve_mg through the
    recorded cycle launches kernel F and no plain version, with the count
    of the same solve on the CPU."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.dd.indices import nodal_indices_of_box
    from mgtpu_torch.ops.cuda import kaczmarz as kf
    A, _ = _kaczmarz_state(32, [4, 4], np.float64)
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [32, 32])
    cfg, _ = mt.get_mg_param(levels=3, relax_type="hybridKaczmarzNodal",
                             nu_pre=1, nu_post=1, relative_tol=1e-8,
                             max_outer_iter=40)
    rp = {"num_domains": [4, 4], "omega": 0.8, "num_it": 2,
          "index_fn": nodal_indices_of_box}
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b /= np.linalg.norm(b)
    x_c, info_c = mt.solve_mg(mt.mg_setup(A, M, cfg, rp, device="cpu"), b)
    st = mt.mg_setup(A, M, cfg, rp)
    l0, p0 = kf.LAUNCHES["float64"], kf.PLAIN_CALLS["float64"]
    x, info = mt.solve_mg(st, b)
    assert kf.LAUNCHES["float64"] > l0 and kf.PLAIN_CALLS["float64"] == p0
    assert info["iters"] == info_c["iters"]
    # the kernel sums a column's adds in another order than index_add
    assert float((x.cpu() - x_c).abs().max() / x_c.abs().max()) < 1e-9


def test_hybrid_kaczmarz_bfloat16_cycles_on_the_card():
    """bfloat16 cycles on a hybrid-Kaczmarz hierarchy on the card: the
    sweeps take kernel F's counted plain version (the kernel takes float32
    and float64 only) and launch no kernel F; the refined solve reaches
    1e-8 within one iteration of the same solve on the CPU."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.dd.indices import nodal_indices_of_box
    from mgtpu_torch.ops.cuda import kaczmarz as kf
    A, _ = _kaczmarz_state(32, [4, 4], np.float64)
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [32, 32])
    cfg, _ = mt.get_mg_param(levels=3, relax_type="hybridKaczmarzNodal",
                             nu_pre=1, nu_post=1)
    rp = {"num_domains": [4, 4], "omega": 0.8, "num_it": 2,
          "index_fn": nodal_indices_of_box}
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b /= np.linalg.norm(b)
    kw = dict(tol=1e-8, max_iter=60, cycle_dtype=torch.bfloat16)
    x_c, info_c = mt.solve_mg_refined(
        mt.mg_setup(A, M, cfg, rp, device="cpu"), b, **kw)
    st = mt.mg_setup(A, M, cfg, rp)
    l0, p0 = dict(kf.LAUNCHES), kf.PLAIN_CALLS.get("bfloat16", 0)
    x, info = mt.solve_mg_refined(st, b, **kw)
    torch.cuda.synchronize()
    assert kf.LAUNCHES == l0 and kf.PLAIN_CALLS["bfloat16"] > p0
    assert abs(info["iters"] - info_c["iters"]) <= 1
    assert np.linalg.norm(A @ x.cpu().numpy() - b) < 1e-8


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-8),
                                       (np.float32, 1e-4),
                                       (np.complex128, 1e-8),
                                       (np.complex64, 1e-4)])
def test_direct_solver_on_the_card(dtype, tol):
    """The dense DirectSolver factors and solves on the card (A and A^H,
    1 and 5 right-hand sides) to test_solvers.py's tolerances."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [20, 23])
    A = nodal_laplacian_matrix(M)
    A = (A + 1e-1 * abs(A).sum(0).max() * sp.identity(A.shape[0]))
    if np.issubdtype(dtype, np.complexfloating):
        P = sp.random(*A.shape, density=0.001, random_state=2)
        A = A + 1j * 0.1 * abs(A).sum() / A.nnz * (P - P.T)
    A = A.tocsr().astype(dtype)
    ds = mt.DirectSolver("dense", dtype=dtype)
    for nrhs in (1, 5):
        bb = (A @ np.random.RandomState(nrhs).rand(A.shape[0], nrhs)
              ).astype(dtype)
        bb = bb[:, 0] if nrhs == 1 else bb
        x = ds.solve_linear_system(A, bb)
        assert x.is_cuda
        xh = x.cpu().numpy()
        assert np.abs(A @ xh - bb).max() / np.abs(bb).max() < tol
        xt = ds.solve(bb, transpose=True).cpu().numpy()
        assert np.abs(A.conj().T @ xt - bb).max() / np.abs(bb).max() < tol
    assert ds.n_fac == 1 and ds.n_solve == 4


# ---------------------------------------------------------------------------
# complex hierarchies: kernels D and F in complex64 / complex128
# ---------------------------------------------------------------------------

def _helmholtz(dims, kh=0.125):
    """L - (1 - 0.5i) diag(k^2), k = (kh / h) / c, c = exp(0.2 randn)."""
    import mgtpu_torch as mt
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    M = mt.get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    L = nodal_laplacian_matrix(M)
    c = np.exp(0.2 * np.random.RandomState(3).randn(L.shape[0]))
    return M, (L - (1 - 0.5j) * sp.diags((kh * dims[0] / c) ** 2)).tocsr()


def _crand(rng, shape, dt):
    return torch.tensor(rng.rand(*shape) + 1j * rng.rand(*shape),
                        dtype=dt, device="cuda")


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("dims", [(64, 64), (16, 16, 16)])
def test_complex_stencil_forms_match_plain(dims, dtype):
    """Kernel D's complex instantiations against the plain versions
    (complex64 1e-5, complex128 1e-12 relative to the largest entry):
    apply at 1, 2 and 5 right-hand sides, a coarse level's apply, the
    stride-2 prolong and restrict of a structured SA hierarchy (restrict =
    P^H), and the DIA form of a flat one; every call one launch."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.config import torch_dtype
    from mgtpu_torch.ops.cuda import stencil as sk
    dt = torch_dtype(dtype)
    key = str(dt).rsplit(".", 1)[-1]
    tol = 1e-5 if dtype == np.complex64 else 1e-12
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    M, A = _helmholtz(list(dims))
    rng = np.random.RandomState(2)
    cfg, rp = mt.get_mg_param(levels=3, relax_type="jacobi",
                              relax_param=0.8, nu_pre=1, nu_post=1,
                              dtype=dtype)
    st = mt.mg_setup(A, M, cfg, rp)
    for lvl in st.hier.levels:
        for m in (1, 2, 5):
            x = _crand(rng, (m,) + lvl.A.grid, dt)
            n0 = sk.LAUNCHES[key]
            y = lvl.A.matvec(x)
            torch.cuda.synchronize()
            assert sk.LAUNCHES[key] == n0 + 1
            assert rel(y, sk.grid_apply_plain(lvl.A.coeff, lvl.A.offsets,
                                              x)) < tol
    cfg, _ = mt.get_mg_param(levels=3, relax_type="spai", dtype=dtype)
    sa = mt.sa_amg_setup(A, cfg, 1.0, mesh=M)
    T = sa.hier.levels[0].P1
    xc = _crand(rng, (2,) + T.coarse_grid, dt)
    rf = _crand(rng, (2,) + T.fine_grid, dt)
    assert rel(T.prolong(xc), sk.stride2_prolong_plain(T, xc)) < tol
    assert rel(T.restrict(rf), sk.stride2_restrict_plain(T, rf)) < tol
    Pd = torch.tensor(sa.Ps[0].toarray(), dtype=torch.complex128,
                      device="cuda")
    want = (Pd.conj().T @ rf.reshape(2, -1).T.to(torch.complex128)).T
    assert rel(T.restrict(rf).reshape(2, -1).to(torch.complex128),
               want) < max(tol, 1e-11)
    flat = mt.sa_amg_setup(A, cfg, 1.0)
    D = flat.hier.levels[0].A
    assert type(D).__name__ == "DIA"
    x = _crand(rng, (D.shape[0], 3), dt)
    assert rel(D.matvec(x), sk.dia_apply_plain(D.data, D.offsets, x)) < tol


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("m", [1, 3])
def test_complex_kaczmarz_kernel_matches_plain(dtype, m):
    """Kernel F's complex instantiations (real row norms and mask, the
    conjugated update) against the plain version on ragged domains
    (complex64 2e-5, complex128 1e-12); a second launch is bitwise the
    first."""
    _need_card()
    from mgtpu_torch.config import torch_dtype
    from mgtpu_torch.cycle.kaczmarz import (kaczmarz_sweep,
                                            setup_hybrid_kaczmarz)
    from mgtpu_torch.dd.indices import nodal_indices_of_box
    from mgtpu_torch.ops.cuda import kaczmarz as kf
    M, A = _helmholtz([37, 37], 0.25)
    dt = torch_dtype(dtype)
    kd = setup_hybrid_kaczmarz(A, M, [3, 2], nodal_indices_of_box, 0.8, 2,
                               dtype=dtype).to(dt, "cuda")
    assert kd.mask.dtype == kd.invd.dtype == dt.to_real()
    rng = np.random.RandomState(m)
    x, b = (_crand(rng, (A.shape[0], m), dt) for _ in range(2))
    key = str(dt).rsplit(".", 1)[-1]
    before = kf.LAUNCHES[key]
    y = kaczmarz_sweep(x, b, kd, 2)
    y2 = kaczmarz_sweep(x, b, kd, 2)
    torch.cuda.synchronize()
    assert kf.LAUNCHES[key] == before + 2 and torch.equal(y, y2)
    ref = kf.kaczmarz_sweep_plain(x, b, kd.arr, kd.mask, kd.invd,
                                  kd.ell_idx, kd.ell_val, 2)
    tol = 2e-5 if dtype == np.complex64 else 1e-12
    assert float((y - ref).abs().max() / ref.abs().max()) < tol
    _kaczmarz_refuses_other_values(kd, x, b)


def test_complex_refined_solve_records_as_eager():
    """A complex64 Helmholtz hierarchy on the card: the recorded refined
    solve (complex128 outer) is its eager run bit for bit, launches kernel
    D in both types and no complex plain version, and certifies 1e-8 at
    the count of the same solve on the CPU."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.ops.cuda import stencil as sk
    M, A = _helmholtz([64, 64])
    cfg, rp = mt.get_mg_param(levels=3, relax_type="jacobi",
                              relax_param=0.8, nu_pre=1, nu_post=1,
                              dtype=np.complex64)
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b /= np.linalg.norm(b)
    _, info_c = mt.solve_mg_refined(mt.mg_setup(A, M, cfg, rp,
                                                device="cpu"), b)
    st = mt.mg_setup(A, M, cfg, rp)
    l0, p0 = dict(sk.LAUNCHES), dict(sk.PLAIN_CALLS)
    x1, i1 = mt.solve_mg_refined(st, b, tol=1e-8, max_iter=60)
    torch.cuda.synchronize()
    for k in ("complex64", "complex128"):
        assert sk.LAUNCHES[k] > l0[k] and sk.PLAIN_CALLS[k] == p0[k]
    x0, i0 = mt.solve_mg_refined(st, b, tol=1e-8, max_iter=60,
                                 device_loop=False)
    assert i1["iters"] == i0["iters"] and abs(i1["iters"]
                                              - info_c["iters"]) <= 1
    assert np.array_equal(i1["resvec"], i0["resvec"])
    assert torch.equal(x1, x0) and x1.dtype == torch.complex128
    assert np.linalg.norm(b - A @ x1.cpu().numpy()) < 1e-8


# ---------------------------------------------------------------------------
# the rest of complex: kernel C, kernel D's cross form and kernel E in
# complex64 / complex128, and the solves that run them
# ---------------------------------------------------------------------------

def _rest_script():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "complex_rest_reference", os.path.join(
            os.path.dirname(__file__), "..", "scripts",
            "complex_rest_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("dims", [(64, 64), (18, 24, 30), (1024, 1024),
                                  (128, 128, 128)])
def test_complex_tridiag_matches_plain_on_every_axis(dims, dtype):
    """Kernel C's complex instantiations against the plain version on
    every line axis of a shifted anisotropic operator (the contracts'
    1025^2 and 129^3 grids among them; the strided 1025^2 complex128
    correct streams), both modes, m = 1, 2; complex64 2e-4, complex128
    1e-10 relative, as the real types; one launch a call, counted under
    the value type."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.config import torch_dtype
    from mgtpu_torch.cycle.grid_cycle import line_state_to
    from mgtpu_torch.ops.cuda import tridiag
    from mgtpu_torch.setup.smoothers import line_prec
    rest = _rest_script()
    A = (rest.aniso2d(dims[0], 100.0) if len(dims) == 2
         else rest.aniso3d(list(dims), 0))
    A = rest.shift(A, 0.125, dims[0])
    M = mt.get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    dt = torch_dtype(dtype)
    key = np.dtype(dtype).name
    tol = 2e-4 if dtype == np.complex64 else 1e-10
    for a in range(len(dims)):
        lr = line_state_to(line_prec(A, M, 0.8, dtype=dtype, axis=a), dt,
                           "cuda")
        for m in (1, 2):
            rng = np.random.RandomState(m)
            r, x = (_crand(rng, (m,) + tuple(lr.alpha.shape), dt)
                    for _ in range(2))
            args = (lr.alpha, lr.pivot, lr.cprime, lr.axis)
            for mode, kw in (("solve", {}),
                             ("correct", dict(x=x, omega=lr.omega))):
                n0, p0 = tridiag.LAUNCHES[key], tridiag.PLAIN_CALLS[key]
                y = tridiag.line_apply(mode, *args, r, **kw)
                torch.cuda.synchronize()
                assert tridiag.LAUNCHES[key] == n0 + 1
                assert tridiag.PLAIN_CALLS[key] == p0
                ref = tridiag.line_plain(mode, *args, r, **kw)
                assert y.dtype == dt and y.shape == r.shape
                err = float((y - ref).abs().max() / ref.abs().max())
                assert err < tol, (mode, a, m, err)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("dims", [(24, 17), (9, 12, 7), (1024, 1024)])
def test_complex_cross_apply_matches_plain(dims, dtype):
    """Every block of a complex-shifted mixed elasticity operator (CV-2d's
    at 1024^2) on kernel D's cross form against its plain version,
    m = 1, 2 (complex64 2e-5, complex128 1e-12); the cross blocks counted
    in CROSS_LAUNCHES, the square ones bitwise grid_apply; the operator
    against scipy."""
    _need_card()
    from mgtpu_torch.config import torch_dtype
    from mgtpu_torch.cycle.systems_grid import (block_operator_from_csr,
                                                fields_to_block)
    from mgtpu_torch.ops.cuda import stencil
    rest = _rest_script()
    tol = 2e-5 if dtype == np.complex64 else 1e-12
    key = np.dtype(dtype).name
    if dims == (1024, 1024):
        A = rest.elasticity(1024, True)
    else:
        _, A = _elasticity_csr(dims, True)
        A = (A + 1e-3j * abs(A).sum(0).max() * sp.identity(A.shape[0])
             ).tocsr()
    op = block_operator_from_csr(A, list(dims), True, dtype=dtype,
                                 device="cuda")
    dt = torch_dtype(dtype)
    assert any(s.in_grid != s.out_grid for s in op.stencils)
    rng = np.random.RandomState(0)
    for S in op.stencils:
        for m in (1, 2):
            x = _crand(rng, (m,) + S.in_grid, dt)
            n0, p0 = stencil.LAUNCHES[key], stencil.PLAIN_CALLS[key]
            c0 = stencil.CROSS_LAUNCHES[key]
            y = S.matvec(x)
            torch.cuda.synchronize()
            assert stencil.LAUNCHES[key] == n0 + 1
            assert stencil.PLAIN_CALLS[key] == p0
            assert stencil.CROSS_LAUNCHES[key] == c0 + (S.in_grid
                                                       != S.out_grid)
            ref = stencil.cross_apply_plain(S.coeff, S.offsets, S.in_grid, x)
            err = float((y - ref).abs().max() / ref.abs().max())
            assert err < tol, (S.offsets, m, err)
            if S.in_grid == S.out_grid:
                assert torch.equal(y, stencil.grid_apply(S.coeff, S.offsets,
                                                         x))
    xs = tuple(_crand(rng, (1,) + g, dt) for g in op.grids)
    got = fields_to_block(op.matvec(xs)).cpu().numpy()[:, 0]
    want = A @ fields_to_block(xs).cpu().numpy()[:, 0].astype(np.complex128)
    assert np.abs(got - want).max() / np.abs(want).max() < tol * 10


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("cells,m", [(16, 1), (16, 3), (64, 1)])
def test_complex_lex_sweep_kernel_matches_plain(dtype, cells, m,
                                                monkeypatch):
    """Kernel E's complex instantiations (one launch, two sweeps; complex64
    block inverses raised to x's type) against the plain per-cell loop on
    the complex-shifted mixed problem's vanka-lex tables (C-lex's 64^2
    fine level among them); complex64 1e-5, complex128 1e-12."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.config import torch_dtype
    from mgtpu_torch.ops.cuda import vanka as vk
    from mgtpu_torch.setup.smoothers import setup_vanka
    rest = _rest_script()
    A = rest.elasticity(cells, True)
    M = mt.get_regular_mesh([0.0, 1.0] * 2, [cells, cells])
    dt = torch_dtype(dtype)
    vr = setup_vanka(A, M, 0.75, True, "vanka-lex", dtype=dtype).to(dt,
                                                                    "cuda")
    assert vr.dinv.dtype == torch.complex64
    rng = np.random.RandomState(m)
    x, b = (_crand(rng, (A.shape[0], m), dt) for _ in range(2))
    args = (vr.idx[0], vr.dinv[0], vr.rows_idx[0], vr.rows_val[0], 2)
    key = np.dtype(dtype).name
    n0, p0 = vk.LAUNCHES[key], vk.PLAIN_CALLS[key]
    y = vk.lex_sweep(x, b, *args)
    torch.cuda.synchronize()
    assert vk.LAUNCHES[key] == n0 + 1 and vk.PLAIN_CALLS[key] == p0
    ref = vk.lex_sweep_plain(x, b, *args)
    tol = 1e-5 if dtype == np.complex64 else 1e-12
    assert float((y - ref).abs().max() / ref.abs().max()) < tol
    _lex_forms_agree(x, b, args, y, monkeypatch)
    with pytest.raises(ValueError):
        vk.lex_sweep(x, b, args[0], args[1].to(torch.float32), *args[2:])


@pytest.mark.parametrize("row", ["CL-2d", "CS-2d", "CV-2d", "CE-2d",
                                 "C-lex", "C-kacz", "Z-dev", "H-cd"])
def test_complex_rest_solves_record_as_eager(row, monkeypatch):
    """scripts/complex_rest_reference.py's rows at 64^2 on the card: the
    recorded refined solve takes the CPU's count, is its eager run bit for
    bit, certifies 1e-8, and launches kernels C (line rows), D (all but
    the flat Vanka rows) and E (C-lex) in complex with no plain call of
    any of them."""
    _need_card()
    import mgtpu_torch as mt
    from mgtpu_torch.ops.cuda import stencil, tridiag
    from mgtpu_torch.ops.cuda import vanka as vk
    rest = _rest_script()
    A, dims, kw, seed, solve_kw = rest.problem(row, 64, 16)
    b = rest.rhs(A, seed)
    kw = dict(dtype=np.complex64, max_outer_iter=60) | kw
    if row == "Z-dev":
        monkeypatch.setenv("MGTPU_AGG", "device")
    cfg, rp = mt.get_mg_param(**kw)

    def setup(dev):
        if row == "Z-dev":
            return mt.sa_amg_setup(A, cfg, rp, device=dev)
        return mt.mg_setup(A, mt.get_regular_mesh([0.0, 1.0] * len(dims),
                                                  dims), cfg, rp, device=dev)
    solve_kw = {"max_iter": 60} | solve_kw
    _, info_c = mt.solve_mg_refined(setup("cpu"), b, **solve_kw)
    st = setup("cuda")
    counters = (tridiag.LAUNCHES, tridiag.PLAIN_CALLS, stencil.LAUNCHES,
                stencil.PLAIN_CALLS, vk.LAUNCHES, vk.PLAIN_CALLS)
    before = [dict(c) for c in counters]
    x1, i1 = mt.solve_mg_refined(st, b, **solve_kw)
    torch.cuda.synchronize()
    after = [dict(c) for c in counters]
    for k in ("complex64", "complex128"):
        for j in (1, 3, 5):
            assert after[j][k] == before[j][k], (row, j, k)
    ran = {name: sum(after[j][k] - before[j][k]
                     for k in ("complex64", "complex128"))
           for name, j in (("C", 0), ("D", 2), ("E", 4))}
    # the flat engine's ELL levels run plain torch (C-lex, C-kacz)
    assert (ran["D"] > 0) == (row not in ("C-lex", "C-kacz"))
    assert (ran["C"] > 0) == row.startswith(("CL", "CS"))
    assert (ran["E"] > 0) == (row == "C-lex")
    x0, i0 = mt.solve_mg_refined(st, b, device_loop=False, **solve_kw)
    assert i1["iters"] == i0["iters"]
    assert abs(i1["iters"] - info_c["iters"]) <= 1
    assert torch.equal(x1, x0) and x1.dtype == torch.complex128
    assert rest.relres(A, b, x1) < 1e-8


# ---------------------------------------------------------------------------
# the multi-device tier: kernel D's halo apply (one rank, in-process)
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    """A one-rank NCCL process group from a file store, and its RankGrid."""
    import torch.distributed as dist
    from mgtpu_torch.parallel.comm import RankGrid
    _need_card()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield RankGrid(None, "nccl")
    finally:
        dist.destroy_process_group()


def _slab_problem(dims, dtype):
    """The DivSigGrad operator's slab stencil (J the slowest axis)."""
    from mgtpu_torch.parallel.stencil import stencil_from_banded
    A, _ = _divsig_stencils(dims, dtype)
    st = stencil_from_banded(A, [d + 1 for d in dims], 0.8, dtype=dtype)
    return torch.tensor(st.coeff, device="cuda"), st.di, st.dj


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dims", [(1024, 256), (64, 64, 64)])
def test_halo_apply_matches_plain(dims, dtype, one_rank):
    """The slab rows from a halo-extended slab (S + 2 planes in, S out):
    kernel D's cross form against its plain version; the overlapped apply
    (kernel D's halo form: the interior, then both edge rows, under the
    whole slab's plan) bitwise the fused one."""
    from mgtpu_torch.ops.cuda import stencil as sk
    from mgtpu_torch.parallel import stencil as ps
    coeff, di, dj = _slab_problem(dims, dtype)
    S, NI = coeff.shape[1:]
    tol = 2e-5 if dtype == np.float32 else 1e-12
    key = np.dtype(dtype).name
    for m in (1, 2):
        x = torch.tensor(np.random.RandomState(m).rand(m, S, NI),
                         dtype=coeff.dtype, device="cuda")
        xh = ps.exchange_halo(x, one_rank)
        n0, h0 = sk.LAUNCHES[key], sk.HALO_LAUNCHES[key]
        c0 = sk.CROSS_LAUNCHES[key]
        y = ps.stencil_matvec_local(coeff, di, dj, xh)
        ref = sk.cross_apply_plain(coeff, tuple((j + 1, i)
                                                for i, j in zip(di, dj)),
                                   (S + 2, NI), xh)
        over = ps.stencil_matvec_overlapped(coeff, di, dj, x, one_rank)
        torch.cuda.synchronize()
        # the fused apply one cross-form launch, the overlapped two of the
        # halo form
        assert sk.LAUNCHES[key] == n0 + 3 and sk.HALO_LAUNCHES[key] == h0 + 2
        assert sk.CROSS_LAUNCHES[key] == c0 + 1
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err < tol, (dims, m, err)
        assert torch.equal(over, y)


def _halo_old_path(coeff, taps, own, left, right, axis, r, b=None,
                   d=None):
    """What the multi-device paths ran before the halo form: the planes
    catted to the block (zero planes for a missing neighbour), kernel D's
    cross form on the extended block (taps shifted by r along `axis`),
    torch's b - y or x + d * (b - y)."""
    from mgtpu_torch.ops.cuda import stencil as sk
    dim = own.ndim - (coeff.ndim - 1) + axis
    zero = lambda t: (torch.zeros_like(own.narrow(dim, 0, r)) if t is None
                      else t)
    xe = torch.cat([zero(left), own, zero(right)], dim=dim)
    ext = tuple(tuple(v + (r if a == axis else 0) for a, v in enumerate(o))
                for o in taps)
    y = sk.halo_apply(coeff, ext, tuple(xe.shape[own.ndim - coeff.ndim
                                                 + 1:]), xe)
    if b is None:
        return y
    return b - y if d is None else own + d * (b - y)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dims", [(1024, 256), (64, 64, 64)])
def test_halo_form_matches_old_path(dims, dtype, one_rank):
    """Kernel D's halo form on a slab (csrc/halo_stencil.cu): apply,
    residual and Jacobi update, with live neighbour planes and with none
    (an end of the axis), whole and as the overlapped slab's two launches
    (interior rows, then both edge rows into the same tensor): bit for bit the cat, kernel D's cross form and torch's
    subtraction or update, and within 2e-5 / 1e-12 of the plain version;
    the slab GMG's overlapped residual and sweep on one NCCL rank
    likewise; each launch counted once, by form."""
    from mgtpu_torch.ops.cuda import stencil as sk
    from mgtpu_torch.parallel import stencil as ps
    coeff, di, dj = _slab_problem(dims, dtype)
    S, NI = coeff.shape[1:]
    taps = tuple(zip(dj, di))
    tol = 2e-5 if dtype == np.float32 else 1e-12
    key = np.dtype(dtype).name
    rng = np.random.RandomState(7)
    t = lambda *shape: torch.tensor(rng.rand(*shape), dtype=coeff.dtype,
                                    device="cuda")
    d = t(S, NI)
    for m in (1, 2, 5):
        x, b = t(m, S, NI), t(m, S, NI)
        for live in (True, False):
            left, right = (t(m, 1, NI), t(m, 1, NI)) if live else (None,
                                                                   None)
            for bb, dd in ((None, None), (b, None), (b, d)):
                form = ("apply" if bb is None else "residual" if dd is None
                        else "jacobi")
                h0 = sk.HALO_FORM_LAUNCHES[f"{form}.{key}"]
                old = _halo_old_path(coeff, taps, x, left, right, 0, 1,
                                     bb, dd)
                new = sk.halo_stencil(coeff, taps, x, left, right, 0, b=bb,
                                      d=dd)
                part = sk.halo_stencil(coeff, taps, x, None, None, 0, b=bb,
                                       d=dd, rows=(1, S - 1, S - 1, S - 1))
                part = sk.halo_stencil(coeff, taps, x, left, right, 0, b=bb,
                                       d=dd, rows=(0, 1, S - 1, S),
                                       out=part)
                plain = sk.halo_stencil_plain(coeff, taps, x, left, right, 0,
                                              b=bb, d=dd)
                torch.cuda.synchronize()
                assert sk.HALO_FORM_LAUNCHES[f"{form}.{key}"] == h0 + 3
                assert torch.equal(new, old), (dims, m, live, form)
                assert torch.equal(part, old), (dims, m, live, form)
                err = float((new - plain).abs().max() / plain.abs().max())
                assert err < tol, (dims, m, live, form, err)
        y = ps.stencil_matvec_local(coeff, di, dj, ps.exchange_halo(x,
                                                                    one_rank))
        assert torch.equal(ps.stencil_matvec_overlapped(
            coeff, di, dj, x, one_rank, b=b), b - y)
        assert torch.equal(ps.stencil_matvec_overlapped(
            coeff, di, dj, x, one_rank, b=b, d=d), x + d * (b - y))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sharded_residual_matches_old_path(dtype, one_rank):
    """ShardedGridStencil.residual and matvec on one NCCL rank, slab and
    pencil, every DivSigGrad level: one halo-form launch each, bitwise the
    extended block, kernel D's cross form and torch's subtraction; the
    pencil's first phase catted, its second read in place."""
    from mgtpu_torch.ops.cuda import stencil as sk
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.grid_sharded import ShardedGridStencil
    pencil = RankGrid((1, 1), "nccl")
    key = np.dtype(dtype).name
    for dims in [(64, 32), (32, 16, 24)]:
        _, ops = _divsig_stencils(dims, dtype)
        for A in ops:
            for comm, shard, radius in ((one_rank, ((0, 0),), (1,)),
                                        (pencil, ((0, 0), (1, 1)), (1, 1))):
                sh = ShardedGridStencil(A.coeff, A.offsets, A.grid, comm,
                                        shard, radius)
                rng = np.random.RandomState(len(A.offsets))
                x, b = (torch.tensor(rng.rand(2, *A.grid), dtype=A.dtype,
                                     device="cuda") for _ in range(2))
                h0 = sk.HALO_LAUNCHES[key]
                r, y = sh.residual(b, x), sh.matvec(x)
                xe = x
                for ga, _ in shard:
                    xe = comm.exchange_halo(xe, ga, 1, dim=1 + ga)
                ext = tuple(tuple(v + (1 if a < len(shard) else 0)
                                  for a, v in enumerate(o))
                            for o in A.offsets)
                old = sk.halo_apply(A.coeff, ext, tuple(xe.shape[1:]), xe)
                torch.cuda.synchronize()
                assert sk.HALO_LAUNCHES[key] == h0 + 2
                assert torch.equal(y, old) and torch.equal(r, b - old), \
                    (dims, len(A.offsets), len(shard))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_halo_form_matches_old_path(dtype, one_rank):
    """The halo form's complex apply and residual bitwise the old path
    (live and missing planes); its Jacobi update takes real types only."""
    from mgtpu_torch.ops.cuda import stencil as sk
    _need_card()
    rng = np.random.RandomState(3)
    c = lambda *shape: torch.tensor(rng.rand(*shape) + 1j * rng.rand(*shape),
                                    dtype=dtype, device="cuda")
    taps = tuple((i, j) for i in (-1, 0, 1) for j in (-1, 0, 1))
    coeff = c(9, 40, 33)
    for m in (1, 2):
        x, b = c(m, 40, 33), c(m, 40, 33)
        for left, right in ((c(m, 1, 33), c(m, 1, 33)), (None, c(m, 1, 33))):
            for bb in (None, b):
                old = _halo_old_path(coeff, taps, x, left, right, 0, 1, bb)
                new = sk.halo_stencil(coeff, taps, x, left, right, 0, b=bb)
                torch.cuda.synchronize()
                assert torch.equal(new, old), (m, bb is None)
    with pytest.raises(TypeError):
        sk.halo_stencil(coeff, taps, x, None, None, 0, b=b,
                        d=c(40, 33))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grid_sharded_block_apply_matches_plain(dtype, one_rank):
    """A sharded level's block apply (halo of the stencil's radius, kernel
    D's halo apply) against the plain grid apply of the whole stencil."""
    from mgtpu_torch.ops.grid_stencil import grid_stencil_matvec
    from mgtpu_torch.parallel.grid_sharded import ShardedGridStencil
    tol = 2e-5 if dtype == np.float32 else 1e-12
    for dims in [(64, 32), (32, 16, 24)]:
        _, ops = _divsig_stencils(dims, dtype)
        for A in ops:
            sh = ShardedGridStencil(A.coeff, A.offsets, A.grid, one_rank,
                                    ((0, 0),), (1,))
            x = torch.tensor(np.random.RandomState(0).rand(2, *A.grid),
                             dtype=A.coeff.dtype, device="cuda")
            y = sh.matvec(x)
            ref = grid_stencil_matvec(A.coeff, A.offsets, x)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max() / ref.abs().max())
            assert err < tol, (dims, len(A.offsets), err)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grid_sharded_pencil_block_apply_matches_plain(dtype, one_rank):
    """A pencil level's block apply (halos on both leading axes, exchanged
    in two phases, so the 9- and 27-point stencils read the corners)
    against the plain grid apply of the whole stencil."""
    from mgtpu_torch.ops.grid_stencil import grid_stencil_matvec
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.grid_sharded import ShardedGridStencil
    pencil = RankGrid((1, 1), "nccl")
    tol = 2e-5 if dtype == np.float32 else 1e-12
    for dims in [(64, 32), (32, 16, 24)]:
        _, ops = _divsig_stencils(dims, dtype)
        for A in ops:
            sh = ShardedGridStencil(A.coeff, A.offsets, A.grid, pencil,
                                    ((0, 0), (1, 1)), (1, 1))
            x = torch.tensor(np.random.RandomState(0).rand(2, *A.grid),
                             dtype=A.coeff.dtype, device="cuda")
            y = sh.matvec(x)
            ref = grid_stencil_matvec(A.coeff, A.offsets, x)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max() / ref.abs().max())
            assert err < tol, (dims, len(A.offsets), err)


class _RankOf:
    """The layout questions a RankGrid answers for rank k of D (no process
    group): what one rank of the systems tier builds its blocks from."""

    def __init__(self, D, k):
        self.shape, self._k = (D,), k

    def axis_size(self, axis=0):
        return self.shape[0]

    def axis_index(self, axis=0):
        return self._k


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dims", [(48, 40), (12, 10, 16)])
def test_staggered_halo_apply_matches_plain(dims, dtype, one_rank):
    """The systems tier's block applies (parallel/systems_sharded.py):
    every block of a mixed elasticity operator as rank 1 of 4 builds it
    (padded, cell-aligned blocks, the input's owned planes with the halo
    of its radius, the taps shifted by it; the axis-0 face component one
    plane more than the cells, so in_grid != out_grid) on kernel D's halo
    apply against its plain version; on one NCCL rank the sharded block
    operator against the single-device one."""
    from mgtpu_torch.cycle.systems_grid import block_operator_from_csr
    from mgtpu_torch.ops.cuda import stencil as sk
    from mgtpu_torch.parallel.systems_sharded import (pad_block_operator,
                                                      padded_grids,
                                                      shard_block_operator)
    _, A = _elasticity_csr(dims, True)
    op = block_operator_from_csr(A, list(dims), True, dtype=dtype,
                                 device="cuda")
    tol = 2e-5 if dtype == np.float32 else 1e-12
    key = np.dtype(dtype).name
    sop = shard_block_operator(pad_block_operator(
        op, padded_grids(op.grids, 4)), _RankOf(4, 1), "cuda")
    staggered = 0
    for (ci, cj), coeff, offs in zip(sop.pairs, sop.coeffs, sop.offsets):
        r = sop.radius[cj]
        taps = tuple((o[0] + r,) + tuple(o[1:]) for o in offs)
        g = sop.grids[cj]
        in_grid = ((sop.layout.owned[cj] + 2 * r,) + tuple(g[1:]) if r
                   else tuple(g))
        staggered += in_grid[0] != coeff.shape[1] + 2 * r
        for m in (1, 2):
            x = torch.tensor(np.random.RandomState(m).rand(m, *in_grid),
                             dtype=coeff.dtype, device="cuda")
            h0 = sk.CROSS_LAUNCHES[key]
            y = sk.halo_apply(coeff, taps, in_grid, x)
            ref = sk.cross_apply_plain(coeff, taps, in_grid, x)
            torch.cuda.synchronize()
            assert sk.CROSS_LAUNCHES[key] == h0 + 1
            err = float((y - ref).abs().max() / ref.abs().max())
            assert err < tol, ((ci, cj), m, err)
    assert staggered > 0
    # the block form on every rank's blocks of 4, and of 1: one launch
    # bitwise the per-block halo applies, adds and subtraction
    for D in (1, 4):
        for k in range(D):
            sop = shard_block_operator(pad_block_operator(
                op, padded_grids(op.grids, D)), _RankOf(D, k), "cuda")
            for m in (1, 2, 5):
                _check_block_form(
                    sop, _block_fields(sop.in_grids, m, op.dtype, k + m),
                    _block_fields(sop.grids, m, op.dtype, 10 + k + m),
                    sk.halo_apply, tol)
    one = shard_block_operator(pad_block_operator(
        op, padded_grids(op.grids, 1)), one_rank, "cuda")
    xs = tuple(torch.tensor(np.random.RandomState(c).rand(2, *g),
                            dtype=op.dtype, device="cuda")
               for c, g in enumerate(op.grids))
    for y, ref in zip(one.matvec(xs), op.matvec(xs)):
        torch.cuda.synchronize()
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err < tol, err


def test_loop_step_write_back_at_the_cells_shapes():
    """_loop_step's write-back on the card at the benchmark cells' state
    shapes (CG's f64 vectors of 18,513 nodes and its scalars, block CG's
    8 x 18,513 fields and 8 x 8 Gram blocks, the refined loop's 257^3 f64
    fields): every entry as `copy_` writes it, in one iteration of a
    recorded loop body run eagerly."""
    _need_card()
    import torch
    from mgtpu_torch.cycle import capture
    g = torch.Generator(device="cuda").manual_seed(3)
    shapes = [((18513, 1), torch.float64), ((), torch.int64),
              ((20, 1), torch.float64), ((18513, 8), torch.float64),
              ((8, 8), torch.float64), ((), torch.bool),
              ((257,) * 3, torch.float64)]
    new = tuple((torch.rand(sh, generator=g, device="cuda",
                            dtype=torch.float64) > 0.5) if dt == torch.bool
                else torch.rand(sh, generator=g, device="cuda",
                                dtype=torch.float64).to(dt)
                for sh, dt in shapes)
    state = tuple(torch.zeros_like(t) for t in new)
    go = capture._loop_step(lambda ctx, args, s: new + (torch.tensor(
        True, device="cuda"),), None, (), state)
    torch.cuda.synchronize()
    assert bool(go)
    for s_, n in zip(state, new):
        assert torch.equal(s_, n)


def test_profiled_loop_replays_its_recordings_from_the_host():
    """While torch.profiler records (under its CUDA tracing, launches of
    the loop graph faulted), a recorded loop replays its start's and its
    iteration's graphs from the host: x and the count bit for bit the
    eager loop's, 1 + k graphs, no `program.device_loop`, no recording and
    no set_cond launch in a profiled call.  Outside the profile the loop
    graph runs (one `program.device_loop` a call), also for a loop whose
    first call, its recording, was profiled."""
    _need_card()
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mgtpu_torch as mt
    from mgtpu_torch.ops.cuda import device_loop
    st, A, b = _capture_case("divsig")
    x0, i0 = mt.solve_cg_mg(st, b, device_loop=False)
    k = int(i0["iters"])

    def profiled(solve):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            out = _spans_of_a_call(solve)
            torch.cuda.synchronize()
        return out

    (x1, i1), names = profiled(lambda: mt.solve_cg_mg(st, b))   # records
    assert torch.equal(x1, x0) and int(i1["iters"]) == k
    assert "program.record" in names
    assert "program.device_loop" not in names
    for _ in range(2):
        before = device_loop.LAUNCHES["set_cond"]
        (x2, i2), names = profiled(lambda: mt.solve_cg_mg(st, b))
        assert torch.equal(x2, x0) and int(i2["iters"]) == k
        assert "program.record" not in names
        assert "program.device_loop" not in names
        assert names.count("program.replay") == k + 1
        assert device_loop.LAUNCHES["set_cond"] == before
        (x3, i3), names = _spans_of_a_call(lambda: mt.solve_cg_mg(st, b))
        torch.cuda.synchronize()
        assert torch.equal(x3, x0) and int(i3["iters"]) == k
        assert names.count("program.device_loop") == 1
        assert device_loop.LAUNCHES["set_cond"] == before + k + 1
    assert _loop_forms(st.hier) == ["while"]
