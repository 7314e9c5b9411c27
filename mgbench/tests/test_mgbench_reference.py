"""The plain reference against a direct SciPy solve and an assembled
Galerkin product at tiny sizes, with nothing of the program."""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from mgbench.reference import check, divsig, hpgmg, nodal


def _dense(op) -> np.ndarray:
    eye = torch.eye(op.n, dtype=torch.float64)
    return op.apply(eye).numpy()


def _interp_1d(nf: int) -> np.ndarray:
    nc = (nf - 1) // 2 + 1
    P = np.zeros((nf, nc))
    for i in range(nc):
        P[2 * i, i] = 1.0
        if 2 * i + 1 < nf:
            P[2 * i + 1, i] = 0.5
        if 2 * i - 1 >= 0:
            P[2 * i - 1, i] = 0.5
    return P


HPGMG_BETA = {"min": 1.0, "max": 10.0, "sharpness": 10.0, "radius": 0.25,
              "centre": [0.5, 0.5, 0.5]}


@pytest.mark.parametrize("mod,cells", [(hpgmg, [4, 6, 2]),
                                       (divsig, [4, 2, 6])])
def test_reference_solve_matches_direct(mod, cells):
    cfg = {"cells": cells, "shift_rel": 1e-4, "sigma_seed": 2 ** 33 + 1,
           "beta": HPGMG_BETA}
    op = mod.operator(cfg, mod.inputs(cfg, 2 ** 33 + 1), "cpu")
    A = _dense(op)
    assert np.allclose(A, A.T, rtol=0, atol=1e-10 * np.abs(A).max())
    b = np.random.default_rng(0).uniform(-1, 1, op.n)
    x = spla.spsolve(sp.csr_matrix(A), b)
    rr = check.relres(op, torch.tensor(b), torch.tensor(x))
    assert rr.shape == (1,) and rr[0] < 1e-12
    # a wrong answer reads high
    assert check.relres(op, torch.tensor(b), torch.tensor(0.5 * x))[0] > 0.1
    # shift = shift_rel * largest absolute row sum of the unshifted rows
    rows = np.abs(A - op.shift * np.eye(op.n)).sum(axis=1)
    assert op.shift == pytest.approx(1e-4 * rows.max(), rel=1e-12)


def test_laplacian_stencil_values():
    A = _dense(nodal.NodalOperator([4, 4, 4], None, 0.0, "cpu"))
    i = 2 + 5 * (2 + 5 * 2)                 # the centre node
    assert A[i, i] == pytest.approx(6 * 16.0)
    assert sorted(A[i][A[i] != 0])[:6] == [-16.0] * 6


def test_divsig_sigma_is_the_configurations_model():
    cfg = {"cells": [3, 4, 5], "shift_rel": 1e-8, "sigma_seed": 2 ** 40}
    a = divsig.inputs(cfg, 1)["sigma"]
    assert a.shape == (5, 4, 3) and (a > 0).all()
    # every run seed gets the same model; another model seed another
    assert np.array_equal(a, divsig.inputs(cfg, 2 ** 35)["sigma"])
    other = dict(cfg, sigma_seed=2 ** 40 + 1)
    assert not np.array_equal(a, divsig.inputs(other, 1)["sigma"])


def test_hpgmg_beta_is_the_configurations_profile():
    cfg = {"cells": [8, 8, 8], "beta": HPGMG_BETA}
    b = hpgmg.inputs(cfg, 1)["sigma"]
    assert b.shape == (8, 8, 8)
    assert np.array_equal(b, hpgmg.inputs(cfg, 2 ** 35)["sigma"])
    # 5.5 + 4.5 tanh(10 (r - 0.25)) at the cell centres: low inside the
    # ball of radius 0.25, high outside, symmetric about the centre
    r = np.sqrt(3 * (0.5 / 8) ** 2)                 # a centre-most cell
    assert b[4, 4, 4] == pytest.approx(5.5 + 4.5 * np.tanh(10 * (r - 0.25)))
    assert 1.0 < b.min() < 2.0 and 9.0 < b.max() < 10.0
    assert np.allclose(b, b[::-1, ::-1, ::-1]) and np.allclose(b, b.T)


def test_galerkin_apply_matches_assembled_rap():
    cfg = {"cells": [8, 4, 8], "shift_rel": 1e-8, "sigma_seed": 5}
    op = divsig.operator(cfg, divsig.inputs(cfg, 5), "cpu")
    A = _dense(op)
    P = np.ones((1, 1))
    for nf in op.grid:                      # slowest axis first
        P = np.kron(P, _interp_1d(nf))
    R = 0.125 * P.T
    Ac = R @ A @ P
    v = np.random.default_rng(1).uniform(-1, 1, Ac.shape[0])
    got = op.galerkin_apply(1, torch.tensor(v).reshape(op.level_grid(1)))
    assert np.allclose(got.reshape(-1).numpy(), Ac @ v, rtol=1e-12,
                       atol=1e-12 * np.abs(Ac @ v).max())


def test_level_errors_read_the_coefficients():
    from mgbench.reference.grid import stencil_apply
    op = nodal.NodalOperator([4, 4, 4], None, 1e-4, "cpu")
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1)]
    # the level-0 operator as per-node coefficients, read off by probing
    A = _dense(op)
    coeff = np.zeros((27,) + op.grid)
    for idx in np.ndindex(*op.grid):
        i = np.ravel_multi_index(idx, op.grid)
        for k, o in enumerate(offs):
            j = tuple(p + q for p, q in zip(idx, o))
            if all(0 <= t < n for t, n in zip(j, op.grid)):
                coeff[(k,) + idx] = A[i, np.ravel_multi_index(j, op.grid)]
    c = torch.tensor(coeff)
    v = torch.rand(op.grid, dtype=torch.float64)
    assert torch.allclose(stencil_apply(c, offs, v), op.apply_field(v))
    good = nodal.level_errors(op, [(c, offs)], 3)
    assert good[0] < 1e-14
    bad = nodal.level_errors(op, [(c * (1 + 1e-3), offs)], 3)
    assert 5e-4 < bad[0] < 2e-3
    assert nodal.level_errors(op, [(c[:, :3], offs)], 3) == [float("inf")]
