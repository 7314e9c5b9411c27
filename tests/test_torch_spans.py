"""The port's spans (mgtpu_torch/spans.py) on the CPU:
off, a span is one shared no-op and nothing is kept; on, records nest
with their parent and call; the solve drivers' host reads, preparation and
finish per call; the set-up stages in `MGState.setup_times`.  On the CPU a
recorded program calls its function, so no graph replays here: the card
test (tests/test_torch_gpu.py) counts those."""
import inspect
import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu_torch as mt
from mgtpu_torch import spans
from mgtpu_torch.cycle import capture
from mgtpu_torch.krylov import _loop
from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix


@pytest.fixture(autouse=True)
def _spans_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _problem(n=8, levels=3):
    M = mt.get_regular_mesh([0.0, 1.0] * 3, [n, n, n])
    sig = np.exp(np.random.RandomState(3).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-4 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    cfg, rp = mt.get_mg_param(levels=levels, relax_type="jacobi",
                              relax_param=0.8, nu_pre=1, nu_post=1,
                              relative_tol=1e-8, max_outer_iter=60,
                              dtype=np.float32)
    st = mt.mg_setup(A, M, cfg, rp, device="cpu")
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    return st, torch.tensor(b / np.linalg.norm(b))


def test_off_span_is_a_shared_no_op_and_keeps_nothing():
    st, b = _problem()
    assert spans.span("driver.prepare") is spans.span("host_read")
    mt.solve_cg_mg(st, b)
    mt.solve_mg_refined(st, b)
    assert spans.drain() == []
    assert spans.COUNTS == {"spans_dropped": 0}


def test_off_spans_leave_no_profiler_event_outside_a_profile():
    """Off, a span opens no record_function; under torch.profiler the
    spans are on and their events show."""
    st, b = _problem()
    mt.solve_cg_mg(st, b)                       # no profiler, spans off
    assert spans.drain() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert spans.span("a") is not spans.span("b")
        mt.solve_cg_mg(st, b)
    assert spans.span("a") is spans.span("b")
    names = {e.name for e in prof.events()}
    assert {"mgtpu_torch.driver.solve_cg_mg", "mgtpu_torch.driver.prepare",
            "mgtpu_torch.driver.finish", "mgtpu_torch.host_read"} <= names
    recs = spans.drain()
    assert recs and recs[0][0] == "driver.solve_cg_mg"


def test_records_nest_with_parent_and_call():
    spans.enable()
    with spans.span("setup.x"):
        pass
    for _ in range(2):
        with spans.span("driver.a"):
            with spans.span("driver.prepare"):
                with spans.span("host_read"):
                    pass
            with spans.span("driver.inner"):        # not outermost
                pass
            spans.tail("driver.finish")
            with spans.span("host_read"):
                pass
    spans.tail("driver.finish")                     # outside a call: none
    recs = spans.drain()
    names = [r[0] for r in recs]
    assert names == ["setup.x"] + ["driver.a", "driver.prepare", "host_read",
                                   "driver.inner", "driver.finish",
                                   "host_read"] * 2
    assert [r[3] for r in recs] == [-1, -1, 1, 2, 1, 1, 5, -1, 7, 8, 7, 7, 11]
    calls = [r[4] for r in recs]
    assert calls[0] == -1 and len(set(calls[1:7])) == 1 \
        and len(set(calls[7:])) == 1 and calls[1] != calls[7]
    assert all(r[1] <= r[2] for r in recs)
    # the tail ends with its driver
    assert recs[5][2] == recs[1][2] and recs[11][2] == recs[7][2]


def test_cap_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    spans.enable()
    with spans.span("driver.a"):
        for _ in range(4):
            with spans.span("host_read"):
                pass
    assert spans.COUNTS["spans_dropped"] == 2
    assert len(spans.records()) == 3
    assert len(spans.drain()) == 3
    assert spans.COUNTS["spans_dropped"] == 0     # one overflow, one list


def test_a_span_open_across_drain_leaves_the_new_list_alone():
    spans.enable()
    with spans.span("driver.a"):
        assert spans.drain()[0][2] == -1            # still open
    assert spans.drain() == []


def test_timed_span_adds_to_seconds_and_its_dict_on_or_off():
    """`timed` sums into the process's SECONDS, `into` into its dict, each
    alone, spans off or on."""
    d = {}
    s0 = spans.SECONDS.get("setup.test_stage", 0.0)
    with spans.span("setup.test_stage", into=d):
        pass
    assert spans.SECONDS.get("setup.test_stage", 0.0) == s0
    with spans.span("setup.test_stage", timed=True):
        pass
    s1 = spans.SECONDS["setup.test_stage"]
    assert s1 > s0 and set(d) == {"test_stage"}
    d1 = d["test_stage"]
    spans.enable()
    with spans.span("setup.test_stage", into=d, timed=True):
        pass
    assert d["test_stage"] > d1
    assert spans.SECONDS["setup.test_stage"] - s1 == pytest.approx(
        d["test_stage"] - d1)
    assert [r[0] for r in spans.drain()] == ["setup.test_stage"]


def _per_call(recs):
    by = {}
    for r in recs:
        if r[4] >= 0:
            by.setdefault(r[4], []).append(r[0])
    return list(by.values())


@pytest.mark.parametrize("entry,extra", [("solve_cg_mg", 1),
                                         ("solve_mg_refined", 4)])
def test_host_reads_of_a_solve_are_its_chunks_and_finish(entry, extra):
    """A chunk's stop flag is read once; the finish reads the count (CG),
    or the count, the residual, the first residual and the history
    (refinement); prepare and finish open once a call."""
    st, b = _problem()
    solve = getattr(mt, entry)
    solve(st, b)                                   # first call: conversion
    spans.enable()
    ks = []
    for _ in range(2):
        x, info = solve(st, b)
        ks.append(int(info["iters"]))
    calls = _per_call(spans.drain())
    assert len(calls) == 2
    for names, k in zip(calls, ks):
        assert k > _loop.CHUNK
        assert names[0] == "driver." + entry
        assert names.count("driver.prepare") == 1
        assert names.count("driver.finish") == 1
        assert names.count("host_read") == math.ceil(k / _loop.CHUNK) + extra
        assert "program.replay" not in names       # the CPU runs no graphs


def test_eager_solve_mg_reads_once_a_cycle():
    st, b = _problem()
    spans.enable()
    x, info = mt.solve_mg(st, b)
    names = _per_call(spans.drain())[0]
    assert names.count("host_read") == info["iters"] + 2
    assert names[0] == "driver.solve_mg" and names[-1] == "driver.finish"
    assert names.count("driver.finish") == 1


def test_first_solve_converts_the_fine_operator_into_setup_times():
    st, b = _problem()
    before = st.setup_times["grid_convert"]
    mt.solve_mg_refined(st, b)
    after = st.setup_times["grid_convert"]
    assert after > before                          # the float64 conversion
    mt.solve_cg_mg(st, b)
    assert st.setup_times["grid_convert"] == after  # cached


def test_span_counts_are_not_kernel_counters():
    assert not any(d is spans.COUNTS for d in capture.kernel_counters())
    from mgtpu_torch.ops.cuda import fused3d
    assert not hasattr(fused3d, "GRID_LAUNCHES")


def test_grid_engine_setup_fills_setup_times():
    st, _ = _problem()
    assert type(st.hier).__name__ == "GridHierarchy"
    assert set(st.setup_times) >= {"grid_convert", "rap", "device",
                                   "coarsest"}
    assert st.setup_times["coarsest"] <= st.setup_times["device"]
    assert all(v >= 0 for v in st.setup_times.values())


def test_setup_spans_nest_under_mg_setup():
    spans.enable()
    _problem()
    recs = spans.drain()
    assert recs[0][0] == "setup.mg_setup" and recs[0][3] == -1
    names = {r[0]: r for r in recs}
    assert names["setup.coarsest"][3] == recs.index(names["setup.device"])
    assert all(r[4] == -1 for r in recs)           # no driver call


def test_drivers_keep_their_signatures():
    """The decorated entries show their own parameters (callers look them
    up)."""
    assert "block" in inspect.signature(mt.solve_cg_mg).parameters
    assert "outer_dtype" in inspect.signature(mt.solve_mg_refined).parameters
    assert mt.solve_cg_mg.__name__ == "solve_cg_mg"
