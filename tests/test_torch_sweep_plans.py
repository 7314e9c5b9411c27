"""Kernels E and F's schedules, on the CPU: the step streams of kernel F's
plan (ops/cuda/kaczmarz.py `kaczmarz_plan`, its `kaczmarz_records`) and
kernel E's cell records (`pack_cells`), followed in numpy as the kernels
follow them — a step's record 2A steps ahead and b A steps ahead in rings
of the kernels' sizes, each column's adds summed by its owner's chain —
reproduce the plain versions and mgtpu's sweeps (JAX on the CPU) within
1e-12 in float64 / complex128.  Also: the chains cover every live tap once,
at its own column; records answer only for the values they were baked
from; kernel F's rings fit shared memory; kernel E's form for a call; and
mgtpu's states carried across get the port's own plan and cells."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle import kaczmarz as kz_ref
from mgtpu.cycle.vanka import _lex_sweep as lex_ref
from mgtpu.dd import indices as ddi_ref
from mgtpu.models.operators import linear_elasticity_operator_mixed as mix_ref
from mgtpu.models.operators import nodal_div_sig_grad_matrix as dsg_ref
from mgtpu.setup import smoothers as sm_ref

import mgtpu_torch as mt
from mgtpu_torch.convert import kaczmarz_relax_from_arrays
from mgtpu_torch.cycle import kaczmarz as kz
from mgtpu_torch.dd import indices as ddi
from mgtpu_torch.ops.cuda import kaczmarz as kf
from mgtpu_torch.ops.cuda import vanka as vk
from mgtpu_torch.setup import smoothers as sm


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _meshes(dims):
    dom = [0.0, 1.0] * len(dims)
    return (mgtpu.get_regular_mesh(dom, list(dims)),
            mt.get_regular_mesh(dom, list(dims)))


# ---------------------------------------------------------------------------
# kernel F
# ---------------------------------------------------------------------------

# (cells a side, domains, value type, right-hand sides)
F_CASES = {"nodal 64^2": (64, (4, 4), np.float64, 1),
           "ragged 63^2": (63, (4, 4), np.float64, 2),
           "complex128 32^2": (32, (4, 4), np.complex128, 1),
           "m=3 ragged 21^2": (21, (3, 2), np.float64, 3)}


def _f_problem(cells, ndom, dtype):
    """Both packages' hybrid Kaczmarz states on a rough-sigma DivSigGrad
    operator (complex: a damped Helmholtz shift)."""
    M, Mp = _meshes([cells, cells])
    A = dsg_ref(M, np.exp(np.random.RandomState(3).randn(M.num_cells)))
    shift = abs(A).sum(axis=0).max() * sp.identity(A.shape[0])
    A = (A + (1e-4 if dtype == np.float64 else -0.3 + 0.2j) * shift).tocsr()
    r = kz_ref.setup_hybrid_kaczmarz(A, M, list(ndom),
                                     ddi_ref.nodal_indices_of_box, 0.8, 2,
                                     dtype=dtype)
    p = kz.setup_hybrid_kaczmarz(A, Mp, list(ndom), ddi.nodal_indices_of_box,
                                 0.8, 2, dtype=dtype)
    return A, r, p


def _views(rec, recs, S, dtype, real):
    """A record's int chunk and value parts (numpy views of its bytes)."""
    return (rec[..., :4 * S].view(np.int32),
            rec[..., recs.ro_vals:recs.ro_coef].view(dtype),
            rec[..., recs.ro_coef:recs.ro_invd].view(dtype),
            rec[..., recs.ro_invd:recs.rb].view(real))


def emulate_f(x, b, invd, ell_val, plan, num_it):
    """Kernel F's schedule in numpy, on its records (`kaczmarz_records`:
    the int chunk and the baked values of each step): the record of step
    s + 2A copied into a ring of REC_RING slots, b at the rows of step
    s + A's record into a ring of B_RING slots; then per step: step s -
    1's chains added to x, each onto the x its owner's residual read, then
    step s's inner from that x into the inner buffer of parity s."""
    A_, RR, RB = kf.AHEAD, kf.REC_RING, kf.B_RING
    L, S = plan.tab.shape
    nd, kr, T = plan.nd, plan.kr, plan.terms
    m = x.shape[1]
    pt = plan.to("cpu")
    recs = kf.kaczmarz_records(pt, torch.from_numpy(ell_val),
                               torch.from_numpy(invd))
    rec = recs.rec.numpy()
    x = x.copy()
    inner = np.zeros((2, nd, m), dtype=x.dtype)
    ring = np.zeros((RR, rec.shape[1]), dtype=np.uint8)
    bring = np.zeros((RB, nd, m), dtype=x.dtype)
    xold = np.zeros((nd, kr, m), dtype=x.dtype)
    base = nd + nd * kr

    def parts(slot):
        return _views(ring[slot], recs, S, x.dtype, invd.dtype)

    def issue_b(s):
        rows = parts(s % RR)[0][:nd]
        ok = rows >= 0
        bring[s % RB, ok] = b[rows[ok]]

    def update(s):
        it, _, coef, _ = parts(s % RR)
        slot = it[nd:base]
        own = it[base:base + nd * kr * T].reshape(nd * kr, T)
        coef = coef[:nd * kr * T].reshape(nd * kr, T)
        inn = inner[s & 1]
        o = own[:, 0] >= 0          # the taps that own a chain
        terms, cf = own[o], coef[o]
        acc = np.conj(cf[:, 0])[:, None] * inn[terms[:, 0] >> 8]
        for t in range(1, T):
            more = terms[:, t] >= 0
            acc[more] += np.conj(cf[more, t])[:, None] * inn[terms[more, t]
                                                             >> 8]
        x[slot[o]] = xold.reshape(nd * kr, m)[o] + acc

    def residual(s):
        it, vals, _, iv = parts(s % RR)
        rows = it[:nd]
        slot = it[nd:base].reshape(nd, kr)
        vals = vals[:nd * kr].reshape(nd, kr)
        for d in np.nonzero(rows >= 0)[0]:
            xold[d] = x[slot[d]]            # kept for the step's own adds
            ax = vals[d] @ xold[d]
            inner[s & 1, d] = (bring[s % RB, d] - ax) * iv[d]

    steps = num_it * L
    for s in range(min(2 * A_, steps)):
        ring[s % RR] = rec[s % L]
    for s in range(min(A_, steps)):
        issue_b(s)
    for s in range(steps):
        if s + 2 * A_ < steps:
            ring[(s + 2 * A_) % RR] = rec[(s + 2 * A_) % L]
        if s + A_ < steps:
            issue_b(s + A_)
        if s > 0:
            update(s - 1)
        residual(s)
    update(steps - 1)
    return x


@pytest.fixture(scope="module", params=list(F_CASES))
def f_case(request):
    cells, ndom, dtype, m = F_CASES[request.param]
    A, r, p = _f_problem(cells, ndom, dtype)
    rng = np.random.RandomState(cells + m)
    x0, b = (rng.rand(A.shape[0], m).astype(dtype) for _ in range(2))
    if dtype == np.complex128:
        x0 = x0 + 1j * rng.rand(*x0.shape)
    want = np.asarray(kz_ref.kaczmarz_sweep(jnp.asarray(x0), jnp.asarray(b),
                                            r, 2))
    pt = p.to(torch.from_numpy(x0).dtype, "cpu")
    plain = kf.kaczmarz_sweep_plain(
        torch.from_numpy(x0), torch.from_numpy(b), pt.arr, pt.mask,
        pt.invd, pt.ell_idx, pt.ell_val, 2).numpy()
    return dict(A=A, r=r, p=p, x0=x0, b=b, want=want, plain=plain)


def test_f_plan_emulation_matches_plain_and_mgtpu(f_case):
    p = f_case["p"]
    y = emulate_f(f_case["x0"], f_case["b"], p.invd, p.ell_val, p.plan, 2)
    assert _rel(y, f_case["plain"]) < 1e-12
    assert _rel(y, f_case["want"]) < 1e-12


def test_f_chains_cover_every_live_tap_at_its_column(f_case):
    """Every live tap of a step (a stored entry of a live row) is a term
    of exactly one chain of that step, whose owner's slot is the tap's
    column; the slots are the rows' columns; padded domains read no row."""
    p, A = f_case["p"], f_case["A"]
    plan = p.plan
    L, nd = p.arr.shape
    kr, T = plan.kr, plan.terms
    live = p.mask != 0
    tab = plan.tab
    assert np.array_equal(tab[:, :nd], np.where(live, p.arr, -1))
    slot = tab[:, nd:nd + nd * kr].reshape(L, nd, kr)
    own = tab[:, nd + nd * kr:nd + nd * kr * (1 + T)].reshape(L, nd * kr, T)
    counts = np.diff(A.indptr)
    for i in range(L):
        seen = np.zeros((nd, kr), dtype=np.int64)
        for q in np.nonzero(own[i, :, 0] >= 0)[0]:
            col = slot[i].reshape(-1)[q]
            for tm in own[i, q][own[i, q] >= 0]:
                d, k = tm >> 8, tm & 255
                assert slot[i, d, k] == col
                seen[d, k] += 1
        want = (live[i][:, None]
                & (np.arange(kr)[None, :] < counts[p.arr[i]][:, None]))
        assert np.array_equal(seen, want.astype(np.int64))
        rows = p.arr[i][live[i]]
        assert np.array_equal(slot[i][live[i]], p.ell_idx[rows, :kr])


def test_f_records_answer_only_for_their_values(f_case):
    """kaczmarz_records remember the plan and the values they were baked
    from: a view of the same memory is theirs, a copy, a cast (what
    cast_hierarchy makes) or another plan is not; a state made on the CPU
    carries none (the kernel runs on a card only)."""
    p = f_case["p"]
    t = p.to(torch.from_numpy(f_case["x0"]).dtype, "cpu")
    assert t.records is None
    rec = kf.kaczmarz_records(t.plan, t.ell_val, t.invd)
    assert rec.of(t.plan, t.ell_val, t.invd)
    assert rec.of(t.plan, t.ell_val.view(t.ell_val.shape), t.invd[:])
    assert not rec.of(t.plan, t.ell_val.clone(), t.invd)
    assert not rec.of(t.plan, t.ell_val, t.invd.clone())
    low = torch.complex64 if t.ell_val.is_complex() else torch.float32
    assert not rec.of(t.plan, t.ell_val.to(low), t.invd.float())
    assert not rec.of(p.plan.to("cpu"), t.ell_val, t.invd)


def test_f_plan_carried_from_mgtpu_equals_the_ports(f_case):
    """kaczmarz_relax_from_arrays on mgtpu's tables builds the plan the
    port's own setup builds."""
    r, p = f_case["r"], f_case["p"]
    spec = {k: np.asarray(getattr(r, k)) for k in
            ("arr", "mask", "invd", "ell_idx", "ell_val")} | dict(
        num_domains=r.num_domains, num_it=r.num_it, omega=r.omega)
    pc = kaczmarz_relax_from_arrays(spec, "cpu")
    pd = p.to(pc.ell_val.dtype, "cpu")
    a, b = pc.plan, pd.plan
    assert (a.nd, a.kr, a.terms, a.stride) == (b.nd, b.kr, b.terms,
                                               b.stride)
    assert torch.equal(a.tab, b.tab) and torch.equal(a.pos, b.pos)


def test_f_rings_fit_shared_memory():
    """A 129^2-node 5-point level of 16 domains: kernel F's rings (records,
    b and inner; x stays in global memory) grow with the right-hand sides
    and their type, and fit at four complex128 ones."""
    M, Mp = _meshes([128, 128])
    A = dsg_ref(M, np.exp(0.3 * np.random.RandomState(3).randn(M.num_cells)))
    A = (A + 1e-4 * abs(A).sum(axis=0).max() * sp.identity(A.shape[0])
         ).tocsr()
    p = kz.setup_hybrid_kaczmarz(A, Mp, [4, 4], ddi.nodal_indices_of_box,
                                 0.8, 2)
    assert (p.plan.nd, p.plan.kr) == (16, 5)
    one = kf.smem_bytes(p.plan, 1, 8, 8)
    assert one < kf.smem_bytes(p.plan, 4, 16, 8) <= kf.MAX_SHARED


# ---------------------------------------------------------------------------
# kernel E
# ---------------------------------------------------------------------------

def emulate_e(x, b, idx, dinv, rows_idx, rows_val, num_it):
    """Kernel E's schedule in numpy, on its cell records (`pack_cells`):
    cell s + 2A's record copied into a ring of REC_RING slots, b at the
    ids of cell s + A's record into a ring of B_RING slots; cell s from the
    rings only: r = b - rows_val . x[rows_idx], u = dinv r (j in order),
    x[idx] += u."""
    A_, RR, RB = vk.AHEAD, vk.REC_RING, vk.B_RING
    L, bs = idx.shape
    K = rows_idx.shape[-1]
    m = x.shape[1]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    cells = vk.pack_cells(t(idx), t(dinv), t(rows_idx), t(rows_val))
    rec, ro_val, ro_dinv, rb = (cells.rec.numpy(), cells.ro_val,
                                cells.ro_dinv, cells.rb)
    x = x.copy()
    ring = np.zeros((RR, rb), dtype=np.uint8)
    bring = np.zeros((RB, bs, m), dtype=x.dtype)

    def ids(s):
        return ring[s % RR, :4 * (bs + bs * K)].view(np.int32)

    n = min(num_it * L, 2 * A_)
    for s in range(n):
        ring[s % RR] = rec[s % L]
    for s in range(min(A_, num_it * L)):
        bring[s % RB] = b[ids(s)[:bs]]
    for s in range(num_it * L):
        if s + 2 * A_ < num_it * L:
            ring[(s + 2 * A_) % RR] = rec[(s + 2 * A_) % L]
        if s + A_ < num_it * L:
            bring[(s + A_) % RB] = b[ids(s + A_)[:bs]]
        q = s % RR
        iv = ids(s)
        ri = iv[bs:].reshape(bs, K)
        rv = ring[q, ro_val:ro_dinv].view(x.dtype)[:bs * K].reshape(bs, K)
        dv = ring[q, ro_dinv:rb].view(dinv.dtype)[:bs * bs].reshape(bs, bs)
        ax = np.einsum("bk,bkm->bm", rv, x[ri])
        r = bring[s % RB] - ax
        x[iv[:bs]] += dv.astype(x.dtype) @ r
    return x


def _mixed(cells, dtype):
    M, Mp = _meshes([cells, cells])
    mu = np.ones(M.num_cells)
    A = mix_ref(M, mu, 10.0 * mu)
    shift = 1e-3 if dtype == np.float64 else 1e-3 + 1e-3j
    A = (A + shift * abs(A).sum(axis=0).max() * sp.identity(A.shape[0])
         ).tocsr()
    return M, Mp, A


@pytest.mark.parametrize("dtype,m", [(np.float64, 1), (np.float64, 3),
                                     (np.complex128, 1), (np.complex128, 2)])
def test_e_ring_emulation_matches_plain_and_mgtpu(dtype, m):
    M, Mp, A = _mixed(12, dtype)
    vr = sm_ref.setup_vanka(A, M, 0.75, True, "vanka-lex", dtype=dtype)
    vp = sm.setup_vanka(A, Mp, 0.75, True, "vanka-lex", dtype=dtype)
    rng = np.random.RandomState(m)
    x, b = (rng.rand(A.shape[0], m).astype(dtype) for _ in range(2))
    if dtype == np.complex128:
        b = b - 0.5j * rng.rand(*b.shape)
    want = np.asarray(lex_ref(jnp.asarray(x), jnp.asarray(b), vr, 2))
    t = vp.to(torch.from_numpy(x).dtype, "cpu")
    plain = vk.lex_sweep_plain(torch.from_numpy(x), torch.from_numpy(b),
                               t.idx[0], t.dinv[0], t.rows_idx[0],
                               t.rows_val[0], 2).numpy()
    got = emulate_e(x, b, vp.idx[0], vp.dinv[0], vp.rows_idx[0],
                    vp.rows_val[0], 2)
    assert _rel(got, plain) < 1e-12
    assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("dtype,m,form", [
    (torch.float32, 1, "smem_b"), (torch.complex64, 1, "smem_b"),
    (torch.float32, 4, "smem"), (torch.complex128, 1, "smem"),
    (torch.float64, 4, "global"), (torch.complex128, 2, "global")])
def test_e_form_for_the_64_fine_level(dtype, m, form):
    """The 64^2 mixed fine level (12,416 unknowns, bs 5, K 7): x and b are
    staged in shared memory where both fit, else x alone, else x stays in
    global memory; the rings alone stay small."""
    item = torch.empty((), dtype=dtype).element_size()
    ditem = 8 if dtype.is_complex else 4
    fits = [f for f in ("smem_b", "smem", "global")
            if vk.smem_bytes(5, 7, m, 12416, item, ditem, f) <= vk.MAX_SHARED]
    assert fits[0] == form
    assert vk.smem_bytes(5, 7, m, 12416, item, ditem, "global") < 32768


def test_e_cells_carried_from_mgtpu_equal_the_ports():
    """vanka_relax_from_arrays on mgtpu's vanka-lex tables gives the tables
    the port's own setup gives, so the cell records packed from them are
    the same bytes."""
    from mgtpu_torch.convert import vanka_relax_from_arrays
    M, Mp, A = _mixed(8, np.float64)
    vr = sm_ref.setup_vanka(A, M, 0.75, True, "vanka-lex")
    spec = {k: np.asarray(getattr(vr, k)) for k in
            ("idx", "dinv", "rows_idx", "rows_val")} | {"variant":
                                                        "vanka-lex"}
    pc = vanka_relax_from_arrays(spec, A.shape[0], torch.float64, "cpu")
    pd = sm.setup_vanka(A, Mp, 0.75, True, "vanka-lex").to(torch.float64,
                                                           "cpu")
    assert pc.cells is None and pd.cells is None   # packed on a card only
    cc, cd = (vk.pack_cells(v.idx[0], v.dinv[0], v.rows_idx[0],
                            v.rows_val[0]) for v in (pc, pd))
    assert (cc.ro_val, cc.ro_dinv, cc.rb) == (cd.ro_val, cd.ro_dinv, cd.rb)
    assert torch.equal(cc.rec, cd.rec)
    L, bs = pd.idx[0].shape
    assert cd.rec.shape == (L, cd.rb) and cd.rb % 16 == 0


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_e_cells_answer_only_for_their_tables(dtype):
    """pack_cells remember the four tables they were packed from: fresh
    views of the same memory (what vanka_sweep passes a call) are theirs;
    a cast copy (cast_hierarchy's) or other block inverses are not."""
    M, Mp, A = _mixed(6, dtype)
    t = sm.setup_vanka(A, Mp, 0.75, True, "vanka-lex", dtype=dtype).to(
        torch.from_numpy(np.zeros(1, dtype)).dtype, "cpu")
    tabs = lambda: (t.idx[0], t.dinv[0], t.rows_idx[0], t.rows_val[0])
    cells = vk.pack_cells(*tabs())
    assert cells.of(*tabs())
    low = torch.complex64 if t.rows_val.is_complex() else torch.float32
    assert not cells.of(*tabs()[:3], t.rows_val[0].to(low))
    assert not cells.of(t.idx[0], t.dinv[0].clone(), *tabs()[2:])
