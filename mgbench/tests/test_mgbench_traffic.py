"""The traffic generator and its kinds of right-hand side: the same seed
gives the same inputs, every seed the same sizes; the survey's dipoles sit
where its layout puts them; HPGMG's manufactured f is -div(beta grad u)."""
import pytest
import torch

from mgbench import spec, traffic

DC = spec.load_json(spec.ROOT / "mgbench" / "configs"
                    / "dcres3d-32x32x16.json")
N = 33 * 33 * 17
SURVEY = {"rhs": "dipole_survey", "columns": 1, "pool": 4, "sample": 1,
          "electrode_spacing": 2, "line_spacing": 4, "margin": 4,
          "source": "a test"}


@pytest.mark.parametrize("columns,pool", [(1, 32), (8, 8), (3, 5)])
def test_same_seed_same_inputs(columns, pool):
    mix = dict(SURVEY, columns=columns, pool=pool)
    seed = 2 ** 31 + 77
    a = traffic.make_pool(mix, DC, seed, "cpu")
    b = traffic.make_pool(mix, DC, seed, "cpu")
    c = traffic.make_pool(mix, DC, seed + 1, "cpu")
    assert len(a) == len(c) == pool
    want = (N,) if columns == 1 else (N, columns)
    for x, y, z in zip(a, b, c):
        assert x.shape == z.shape == want and x.dtype == torch.float64
        assert torch.equal(x, y)
    assert any(not torch.equal(x, z) for x, z in zip(a, c))


def test_survey_dipoles_are_neighbouring_top_face_electrodes():
    mix = dict(SURVEY, columns=8, pool=8)
    src = spec.source("dipole_survey")
    assert len(src.sources(mix, DC)) == 7 * 12
    top = 16 * 33 * 33
    seen = set()
    for B in traffic.make_pool(mix, DC, 12345, "cpu"):
        assert torch.count_nonzero(B[:top]) == 0
        for j in range(B.shape[1]):
            plus = int(torch.nonzero(B[:, j] == 1.0))
            minus = int(torch.nonzero(B[:, j] == -1.0))
            assert torch.count_nonzero(B[:, j]) == 2
            assert minus - plus == 2                    # two cells along x
            ix, iy = (plus - top) % 33, (plus - top) // 33
            assert iy % 4 == 0 and 4 <= iy <= 28 and 4 <= ix <= 26
            seen.add(plus)
    assert len(seen) == 64                              # all distinct


def test_hpgmg_rhs_is_minus_div_beta_grad_u():
    from mgbench.reference import nodal
    cfg = dict(spec.load_json(spec.ROOT / "mgbench" / "configs"
                              / "poisson3d-257.json"), cells=[32, 32, 32])
    mix = {"rhs": "hpgmg", "columns": 1, "pool": 2, "sample": 1,
           "source": "a test"}
    pool = traffic.make_pool(mix, cfg, 1, "cpu")
    assert torch.equal(pool[0], pool[1])
    assert torch.equal(pool[0], traffic.make_pool(mix, cfg, 2, "cpu")[0])
    # against the reference's operator on the nodal samples of u: the
    # same up to O(h^2) away from the (natural) boundary
    ref = spec.reference("hpgmg")
    # beta sampled at the nodes' cells, u at the nodes
    op = nodal.NodalOperator(cfg["cells"], ref.inputs(cfg, 0)["sigma"],
                             0.0, "cpu")
    t = torch.arange(33, dtype=torch.float64) / 32
    X = 2 * t ** 6 - 6 * t ** 5 + 5 * t ** 4 - t ** 2
    u = X[:, None, None] * X[None, :, None] * X[None, None, :]
    Au = op.apply_field(u)
    f = pool[0].reshape(33, 33, 33)
    inner = (slice(4, -4),) * 3
    err = (Au - f)[inner].norm() / f[inner].norm()
    assert err < 0.02


@pytest.mark.parametrize("bad", [
    {"rhs": "hpgmg", "columns": 1, "pool": 3, "source": "x"},
    {"rhs": "spikes", "columns": 1, "pool": 3, "sample": 1, "source": "x"},
    {"rhs": "hpgmg", "columns": 0, "pool": 3, "sample": 1, "source": "x"},
    {"rhs": "hpgmg", "columns": 1, "pool": 3, "sample": 1},
    dict(SURVEY, columns=8, pool=11),               # 88 > 84 sources
])
def test_malformed_mix_refused(bad):
    with pytest.raises(ValueError):
        traffic.make_pool(bad, DC, 1, "cpu")
