"""The slab tier of the PyTorch port's multi-device layer (mgtpu_torch/
parallel/comm.py, launch.py, stencil.py, sharded.py) against mgtpu, on CPU
gloo ranks.

mgtpu runs its tier on jax.devices()[:R] of conftest's virtual CPU devices;
the port runs R spawned gloo ranks (parallel/launch.py::run_ranks, with a
deadline) on the same numpy inputs.  One rank group a rank count R in {1, 2,
4}, made by a module-scoped fixture that runs every case of this file
(tests/_torch_ranks.py::parallel_cases); each case is its own test.
Tolerances are mgtpu's own (tests/test_sharded.py): the halo planes and the
transfers exact or to rounding, the overlapped apply bitwise the fused one,
the slab cycle within rtol 1e-10 (f64) of mgtpu's single-device cycle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgtpu import get_mg_param as get_mg_param_ref
from mgtpu import make_cycle_fn
from mgtpu import mg_setup as mg_setup_ref
from mgtpu.models.mesh import get_regular_mesh as mesh_ref
from mgtpu.parallel import sharded as sharded_ref
from mgtpu.parallel import stencil as stencil_ref

import _torch_ranks as tr
from mgtpu_torch.convert import sharded_mg_from_arrays
from mgtpu_torch.cycle.grid_cycle import grid_cycle
from mgtpu_torch.ops.grid_stencil import flat_to_grid, grid_to_flat
from mgtpu_torch.parallel.launch import run_ranks
from mgtpu_torch.parallel.sharded import build_sharded_mg
from mgtpu_torch.parallel.stencil import make_transfer_plan

RANKS = [1, 2, 4]


@pytest.fixture(scope="module", params=RANKS, ids=lambda r: f"R{r}")
def group(request):
    """Every case of this file on R gloo ranks: (R, per-rank outputs)."""
    R = request.param
    return R, run_ranks(tr.parallel_cases, R, "cpu", "gloo", tr.DEADLINE_S)


def _ref_state(M, A, levels, dtype=np.float64):
    """mgtpu's hierarchy of the same operator (its own mesh type)."""
    Mr = mesh_ref(list(M.domain), list(np.asarray(M.n)))
    cfg, rp = get_mg_param_ref(**tr.params(levels, dtype))
    return mg_setup_ref(A, Mr, cfg, rp)


def _cat(outs, key):
    """The ranks' slabs of one field joined along J."""
    return np.concatenate([o[key] for o in outs], axis=-2)


# ---------------------------------------------------------------------------
# halo exchange and the slab apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2])
def test_halo_exchange_gives_neighbour_planes(group, width):
    """Each slab gets its neighbours' edge planes, zero planes at the ends
    of the axis (ppermute's edge rule, mgtpu/parallel/stencil.py:151)."""
    R, outs = group
    full = tr.slab_field(2, 4 * R, tr.HALO_NI)
    pad = np.pad(full, ((0, 0), (width, width), (0, 0)))
    for k, o in enumerate(outs):
        assert np.array_equal(o[f"halo{width}"],
                              pad[:, 4 * k:4 * k + 4 + 2 * width])


def test_broadcast_gives_every_rank_the_roots_tensor(group):
    R, outs = group
    for o in outs:
        assert np.array_equal(o["bcast"], np.full(3, float(R - 1)))


def test_overlapped_apply_is_bitwise_the_fused_apply(group):
    """The interior rows applied while the halo is in flight, then the edge
    rows: bit for bit the fused exchange + apply (and at S = 1, where the
    overlapped form takes the fused one)."""
    _, outs = group
    for o in outs:
        assert np.array_equal(o["apply_over"], o["apply_fused"])
        assert np.array_equal(o["s1_over"], o["s1_fused"])


def _level0(R):
    """Level 0 of the 2D slab problem: the port's state, mgtpu's padded
    slab stencil for R devices and the slab size."""
    M, A, levels, _ = tr.slab_problem("poisson")
    st_ref = _ref_state(M, A, levels)
    mg_ref = sharded_ref.build_sharded_mg(st_ref, R, dtype=np.float64)
    return st_ref, mg_ref.levels[0]


def test_slab_apply_matches_reference(group):
    """The gathered slab apply against mgtpu's stencil_matvec_local on the
    whole (zero-halo) grid, f64."""
    R, outs = group
    _, lvl = _level0(R)
    x = tr.slab_field(2, lvl.slab * R, lvl.plan.NI, seed=8)
    xh = np.pad(x, ((0, 0), (1, 1), (0, 0))).transpose(1, 2, 0)
    want = np.asarray(stencil_ref.stencil_matvec_local(
        lvl.coeff, lvl.di, lvl.dj, jnp.asarray(xh))).transpose(2, 0, 1)
    got = _cat(outs, "apply_fused")
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_transfers_match_fw_interp_and_reference(group):
    """R r and P xc from slabs reproduce the setup's full-weighting
    operators (state.Rs[0], state.Ps[0]) and mgtpu's restrict_local."""
    R, outs = group
    st_ref, lvl = _level0(R)
    NJ, NI, NJc, NIc = (lvl.plan.NJ, lvl.plan.NI, lvl.plan.NJc,
                        lvl.plan.NIc)
    r = tr.slab_field(1, lvl.slab * R, NI, seed=9)
    r[:, NJ:] = 0
    xc = tr.slab_field(1, lvl.slab // 2 * R, NIc, seed=10)
    xc[:, NJc:] = 0
    rc = _cat(outs, "restrict")[0]
    pf = _cat(outs, "prolong")[0]
    want_r = (st_ref.Rs[0] @ r[0, :NJ].reshape(-1)).reshape(NJc, NIc)
    want_p = (st_ref.Ps[0] @ xc[0, :NJc].reshape(-1)).reshape(NJ, NI)
    assert np.abs(rc[:NJc] - want_r).max() <= 1e-13 * np.abs(want_r).max()
    assert np.abs(pf[:NJ] - want_p).max() <= 1e-13 * np.abs(want_p).max()
    assert not rc[NJc:].any()
    ref = np.asarray(stencil_ref.restrict_local(
        jnp.asarray(np.pad(r, ((0, 0), (1, 1), (0, 0))).transpose(1, 2, 0)),
        lvl.plan, lvl.masks, lvl.ds_map, lvl.slab // 2 * R))[..., 0]
    assert np.abs(rc - ref).max() <= 1e-13 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# the slab cycle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cycle_refs():
    """One V-cycle from zero of each slab problem: mgtpu's single-device
    cycle for the 2D ones, the port's single-device grid cycle for 3D."""
    out = {}
    for name in tr.SLAB_CASES:
        M, A, levels, b = tr.slab_problem(name)
        b2 = b[:, None] if b.ndim == 1 else b
        if name == "poisson3d":
            st = tr.setup(M, A, **tr.params(levels, np.float64))
            grid = st.hier.fine_grid
            x = grid_cycle(st.config, st.hier,
                           flat_to_grid(torch.tensor(b2), grid),
                           torch.zeros((b2.shape[1],) + grid,
                                       dtype=torch.float64))
            out[name] = (A, b2, grid_to_flat(x).numpy())
            continue
        st = _ref_state(M, A, levels)
        x = make_cycle_fn(st.config)(st.hier, jnp.asarray(b2),
                                     jnp.zeros_like(jnp.asarray(b2)))
        out[name] = (A, b2, np.asarray(x))
    return out


TOLS = {"poisson": (1e-10, 1e-12), "poisson3d": (1e-9, 1e-11),
        "divsig": (1e-9, 1e-11)}


@pytest.mark.parametrize("name", list(tr.SLAB_CASES))
def test_slab_cycle_matches_single_device(group, cycle_refs, name):
    """One sharded V-cycle equals the single-device cycle (mgtpu's
    test_sharded.py tolerances), and the psum-reduced residual norm is the
    true one."""
    _, outs = group
    A, b2, want = cycle_refs[name]
    rtol, atol = TOLS[name]
    for o in outs:
        np.testing.assert_allclose(o[f"cycle_{name}"], want, rtol=rtol,
                                   atol=atol)
        r_true = np.linalg.norm(b2 - A @ o[f"cycle_{name}"])
        assert abs(o[f"rn_{name}"] - r_true) < 1e-10


def test_slab_cycles_converge_to_contract(group):
    """Five sharded cycles meet mgtpu's single-device contract at 128^2, 4
    levels (test_sharded.py::test_sharded_converges_to_contract)."""
    _, outs = group
    M, A = tr.poisson(tr.CONVERGE[0])
    b = tr.rhs(A)
    for o in outs:
        assert np.linalg.norm(A @ o["converge"] - b) < 0.005


def test_byte_counts_follow_the_collectives(group):
    """One rank sends nothing; several send halo planes, gathers and
    all-reduces, the slab tier no reduce_scatter, and only the root of
    the broadcast case broadcasts."""
    R, outs = group
    for k, o in enumerate(outs):
        sent = o["sent"]
        if R == 1:
            assert not any(sent.values())
        else:
            assert sent["halo"] > 0 and sent["psum"] > 0
            assert sent["all_gather"] > 0 and sent["reduce_scatter"] == 0
            assert sent["broadcast"] == (3 * 4 * (R - 1) if k == R - 1
                                         else 0)


# ---------------------------------------------------------------------------
# the state carried across, and the entry points' rules
# ---------------------------------------------------------------------------

def _mg_arrays(mg):
    """mgtpu's ShardedMG as the plain arrays convert.py takes."""
    return {"levels": [{"coeff": np.asarray(l.coeff), "d": np.asarray(l.d),
                        "masks": np.asarray(l.masks),
                        "ds_map": np.asarray(l.ds_map), "di": l.di,
                        "dj": l.dj, "slab": l.slab,
                        "plan": {"offsets": l.plan.offsets,
                                 "NI": l.plan.NI, "NIc": l.plan.NIc,
                                 "NJ": l.plan.NJ, "NJc": l.plan.NJc,
                                 "dim": l.plan.dim}}
                       for l in mg.levels],
            "lu": np.asarray(mg.lu), "piv": np.asarray(mg.piv),
            "nu_pre": mg.nu_pre, "nu_post": mg.nu_post,
            "coarse_nj": mg.coarse_nj, "n_nodes0": mg.n_nodes0}


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("name", ["poisson", "poisson3d"])
def test_sharded_mg_from_arrays_round_trip(R, name):
    """mgtpu's ShardedMG for R devices, carried across, gives each rank's
    shard bit for bit: the same slabs as the port's own build (the LU
    factors are mgtpu's, the port's own within rounding)."""
    M, A, levels, _ = tr.slab_problem(name)
    mg_ref = sharded_ref.build_sharded_mg(_ref_state(M, A, levels), R,
                                          dtype=np.float64)
    spec = _mg_arrays(mg_ref)
    st = tr.setup(M, A, **tr.params(levels, np.float64))
    for k in range(R):
        got = sharded_mg_from_arrays(spec, R, k, device="cpu")
        own = build_sharded_mg(st, R, k, np.float64, "cpu")
        for lg, lo, lr in zip(got.levels, own.levels, mg_ref.levels):
            S = lr.slab
            rows = slice(k * S, (k + 1) * S)
            assert np.array_equal(lg.coeff.numpy(),
                                  np.asarray(lr.coeff)[:, rows])
            assert np.array_equal(lg.d.numpy(), np.asarray(lr.d)[rows])
            for f in ("coeff", "d", "masks", "ds_map"):
                assert np.array_equal(getattr(lg, f).numpy(),
                                      getattr(lo, f).numpy()), f
            assert (lg.di, lg.dj, lg.plan, lg.slab) == (lo.di, lo.dj,
                                                        lo.plan, lo.slab)
        assert np.array_equal(got.lu.numpy(), np.asarray(mg_ref.lu))
        assert np.array_equal(got.piv.numpy(), np.asarray(mg_ref.piv) + 1)
        assert np.array_equal(got.piv.numpy(), own.piv.numpy())
        assert (np.abs(own.lu.numpy() - got.lu.numpy()).max()
                <= 1e-12 * np.abs(got.lu.numpy()).max())
        assert (got.coarse_nj, got.n_nodes0, got.nu_pre) == (
            own.coarse_nj, own.n_nodes0, own.nu_pre)


def test_transfer_plan_matches_reference():
    for nodes in ([33, 33], [17, 9, 33], [5]):
        plan, masks, ds = make_transfer_plan(nodes)
        pr, mr, dr = stencil_ref.make_transfer_plan(nodes)
        assert plan.offsets == pr.offsets
        assert (plan.NI, plan.NIc, plan.NJ, plan.NJc, plan.dim) == (
            pr.NI, pr.NIc, pr.NJ, pr.NJc, pr.dim)
        assert np.array_equal(masks, mr) and np.array_equal(ds, dr)


def test_entry_points_default_to_the_card():
    """Without device=, the sharded constructors target the card: they raise
    without one."""
    from mgtpu_torch.parallel.comm import rank_device
    M, A, levels, _ = tr.slab_problem("poisson")
    st = tr.setup(M, A, **tr.params(levels, np.float64))
    assert rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_sharded_mg(st, 2, 0, np.float64)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_device()


def test_run_ranks_fails_a_hang_at_its_deadline():
    """A rank group past its deadline is killed and the call raises."""
    import time
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(tr.sleeper, 2, "cpu", "gloo", 3.0, args=(60.0,))
    assert time.monotonic() - t0 < 20.0


def test_run_ranks_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(tr.failer, 2, "cpu", "gloo", tr.DEADLINE_S)


def test_rank_entry_points_name_their_devices_and_transport():
    """run_ranks takes no default device or backend and RankGrid no default
    transport: nothing falls to CPU ranks or to gloo unasked."""
    import inspect
    from mgtpu_torch.parallel.comm import RankGrid
    sig = inspect.signature(run_ranks).parameters
    assert all(sig[k].default is inspect.Parameter.empty
               for k in ("devices", "backend"))
    assert (inspect.signature(RankGrid).parameters["transport"].default
            is inspect.Parameter.empty)
    with pytest.raises(TypeError):
        run_ranks(tr.failer, 2)
    with pytest.raises(ValueError, match="backend must be one of"):
        run_ranks(tr.failer, 2, "cpu", "mpi")
