"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips with a reason when there is none.  On the card:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""
import itertools

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
