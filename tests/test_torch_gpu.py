"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips with a reason when there is none.  On the card:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytestmark = pytest.mark.gpu

DIMS = [(16, 16, 16), (18, 24, 30)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")


def _operators(dims):
    """The shifted nodal Laplacian (nd=7) and its Galerkin coarsening
    (nd=27) on the card."""
    import mgtpu_torch as mt
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    from mgtpu_torch.ops.grid_stencil import (compress_grid_stencil,
                                              grid_stencil_from_csr,
                                              make_grid_stencil,
                                              structured_fw_rap)
    M = mt.get_regular_mesh([0.0, 1.0] * 3, list(dims))
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])
         ).tocsr().astype(np.float32)
    nodes = [d + 1 for d in dims]
    A7 = make_grid_stencil(L, nodes, device="cuda")
    A27 = compress_grid_stencil(structured_fw_rap(
        grid_stencil_from_csr(L, nodes)), device="cuda")
    return A7, A27


@pytest.mark.parametrize("m", [1, 2])
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


def test_wrappers_reject_what_kernels_do_not_take():
    _need_card()
    from mgtpu_torch.ops.cuda import const3d
    A, _ = _operators((8, 8, 8))
    x = torch.zeros((1,) + A.grid, device="cuda")
    with pytest.raises(TypeError):
        const3d.stencil3d_apply(A, "matvec", x.double())
    with pytest.raises(ValueError):
        const3d.stencil3d_apply(A, "matvec", x.transpose(1, 3))
    with pytest.raises(ValueError):
        const3d.stencil3d_apply(A, "residual", x, b=x[:, :-1])


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
