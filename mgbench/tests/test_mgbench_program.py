"""The readers of the program's own spans (mgbench/program.py, metrics/
of source program_span) on a fixed record:
mgbench/tests/fixtures/traced_program_record.json is traced_record.json
(window 1000 us, device busy 400 us, one solve span [50, 900)) with the
program's records of two calls, the second inside that solve span on a
host clock 7 s + 2 us ahead of the trace's, its set-up seconds and its
count of dropped records.  The existing readers and the trace's
reductions give the same on both fixtures, and on the new one with its
program part taken away."""
import copy
import json
from pathlib import Path

import pytest
import torch

from mgbench import loop, program, spec, trace

FIXTURES = Path(__file__).parent / "fixtures"
BENCH = spec.benchmark()
NEW = ["setup.grid_convert_s", "setup.rap_s", "setup.device_s",
       "setup.capture_s", "host_reads_per_solve", "graphs_per_solve",
       "records_in_window", "idle.prepare_share", "idle.chunk_share",
       "idle.finish_share", "idle.unspanned_share"]
OLD = [m["name"] for m in BENCH["per_layer"] if m["name"] not in NEW]


@pytest.fixture
def program_record():
    return json.loads((FIXTURES / "traced_program_record.json").read_text())


def read(name, record):
    return spec.reader(name)(record)


def test_the_new_metrics_are_declared_for_every_cell():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert [m["name"] for m in BENCH["per_layer"]][-len(NEW):] == NEW
    for name in NEW:
        assert "workloads" not in entries[name]
        assert entries[name]["source"] == "program_span"
    for w in BENCH["workloads"]:
        got = {m["name"] for m in spec.cell(BENCH, w["name"])["per_layer"]}
        assert set(NEW) <= got


def test_new_readers_on_the_fixture(program_record):
    r = program_record
    assert read("setup.grid_convert_s", r) == 0.5
    assert read("setup.rap_s", r) == 0.25
    assert read("setup.device_s", r) == 0.75
    assert read("setup.capture_s", r) == 0.0625
    assert read("host_reads_per_solve", r) == 3.0
    assert read("graphs_per_solve", r) == 2.0
    assert read("records_in_window", r) == 0
    # idle in the solve span: [50, 100) prepare; [300, 350), [500, 590)
    # chunk; [590, 600), [650, 850) finish; [850, 900) no span
    assert read("idle.prepare_share", r) == pytest.approx(5.0)
    assert read("idle.chunk_share", r) == pytest.approx(14.0)
    assert read("idle.finish_share", r) == pytest.approx(21.0)
    assert read("idle.unspanned_share", r) == pytest.approx(5.0)


def test_idle_shares_partition_idle_share(program_record):
    r = program_record
    pieces = dict(trace.top(trace.idle_gaps(r["traced"])))
    lo, hi = trace.window(r["traced"])
    rest = 100.0 * (pieces["harness"] + pieces["sync"]) * 1e6 / (hi - lo)
    parts = sum(read(f"idle.{p}_share", r)
                for p in ("prepare", "chunk", "finish", "unspanned"))
    assert abs(parts + rest - read("idle_share", r)) < 1e-9
    assert abs(parts - 100.0 * pieces["solve"] * 1e6 / (hi - lo)) < 1e-9


def test_window_calls_pairs_the_traced_call(program_record):
    calls = program.window_calls(program_record)
    assert len(calls) == 1
    top = calls[0][0]
    assert top[0] == "driver.solve_cg_mg"
    assert top[1] == pytest.approx(50.0) and top[2] == pytest.approx(850.0)


def test_pairing_picks_the_latest_calls_that_fit():
    """Three solve spans and five program calls on a host clock 1 s
    ahead: the last three nest in the solve spans (each starting 1 to 3 us
    after its span); shifting by one call does not fit."""
    solves = [["solve", 100.0 + 300 * k, 250.0] for k in range(3)]
    rec = {"traced": {"device_ops": [["k", 0.0, 1000.0]],
                      "spans": [["window", 0.0, 1000.0]] + solves},
           "program": {"seconds": {}, "counts": {"spans_dropped": 0},
                       "records": []}}
    recs = rec["program"]["records"]
    starts = [-900.0, -500.0] + [100.0 + 300 * k + 1 + k for k in range(3)]
    for call, s in enumerate(starts):
        recs.append(["driver.solve_mg_refined", int((s + 1e6) * 1e3),
                     int((s + 200 + 1e6) * 1e3), -1, call])
    calls = program.window_calls(rec)
    assert [round(c[0][1], 6) for c in calls] == [100.0, 401.0, 702.0]
    recs[-1][2] += 200_000                 # the last call outlasts its span
    assert program.window_calls(rec) is None


def test_nothing_read_without_the_program_part(program_record):
    r = copy.deepcopy(program_record)
    r["program"] = None                    # a program without the spans
    for name in NEW:
        assert read(name, r) is None
    r = copy.deepcopy(program_record)
    r["program"]["counts"]["spans_dropped"] = 1
    assert read("host_reads_per_solve", r) is None
    assert read("idle.chunk_share", r) is None
    r = dict(copy.deepcopy(program_record), traced=None)
    assert read("idle.prepare_share", r) is None
    assert read("setup.rap_s", r) == 0.25


def test_collect_reads_the_program_and_leaves_it():
    """Every reader sees the same records, whatever the order: collect
    drains nothing and keeps nothing in the record."""
    from mgtpu_torch import spans
    spans.drain()
    spans.enable()
    try:
        with spans.span("driver.solve_cg_mg"):
            pass
    finally:
        spans.disable()
    r = {}
    got = program.collect(r)
    assert [x[0] for x in got["records"]] == ["driver.solve_cg_mg"]
    assert got["counts"] == {"spans_dropped": 0}
    assert r == {} and program.collect(r) == got
    assert len(spans.drain()) == 1


def _strip(record):
    r = copy.deepcopy(record)
    r.pop("program")
    return r


def _chrome(record, with_program=True):
    """The chrome events a profile of the fixture would hold: device
    operations, the benchmark's spans and the program's (on the trace's
    clock)."""
    t = record["traced"]
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d}
          for n, ts, d in t["device_ops"]]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "mgbench." + n,
            "ts": ts, "dur": d} for n, ts, d in t["spans"]]
    if with_program:
        for call in program.window_calls(copy.deepcopy(record)):
            ev += [{"ph": "X", "cat": "user_annotation",
                    "name": "mgtpu_torch." + n, "ts": s, "dur": e - s}
                   for n, s, e in call]
    return {"traceEvents": ev}


def test_reduce_chrome_leaves_the_program_spans_out(program_record):
    full = trace.reduce_chrome(_chrome(program_record))
    bare = trace.reduce_chrome(_chrome(program_record, with_program=False))
    assert full == bare
    assert full["device_ops"] == program_record["traced"]["device_ops"]
    assert full["spans"] == program_record["traced"]["spans"]


def test_existing_readers_and_reductions_are_unchanged(program_record,
                                                       fixture_record):
    stripped = _strip(program_record)
    assert stripped == fixture_record
    for r in (program_record, stripped):
        t = r["traced"]
        assert trace.idle_gaps(t) == trace.idle_gaps(fixture_record["traced"])
        assert loop.breakdown(t) == loop.breakdown(fixture_record["traced"])
        assert trace.busy_us(t) == trace.busy_us(fixture_record["traced"])
        assert loop.device_entry(torch.device("cpu"), 1, 0, t) == \
            loop.device_entry(torch.device("cpu"), 1, 0,
                              fixture_record["traced"])
        for name in OLD:
            assert read(name, copy.deepcopy(r)) == \
                read(name, copy.deepcopy(fixture_record)), name
