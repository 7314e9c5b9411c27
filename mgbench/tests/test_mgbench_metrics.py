"""The per-layer readers on a fixed record of spans, counters and trace
events (mgbench/tests/fixtures/traced_record.json): the window is 1000 us,
the device busy 400 us of it (two kernel D launches 300 us, an
elementwise kernel overlapping one, a copy)."""
import copy
import json

import pytest
import torch

from mgbench import loop, spec, trace

BENCH = spec.benchmark()
NAMES = [m["name"] for m in BENCH["per_layer"]]


def read(name, record):
    return spec.reader(name)(record)


def test_every_per_layer_metric_has_a_reader():
    for name in NAMES:
        assert callable(spec.reader(name))


def test_readers_on_the_fixture(fixture_record):
    r = fixture_record
    assert read("setup.operator_s", r) == 1.5
    assert read("setup.hierarchy_s", r) == 2.25
    assert read("setup.record_s", r) == 0.125
    assert read("launches_per_solve", r) == 12.0
    assert read("krylov_iters", r) == 11.5
    assert read("outer_iters", r) is None
    assert read("cycle.device_ms", r) == pytest.approx(400 / 22 / 1e3)
    assert read("idle_share", r) == pytest.approx(60.0)
    # 0.67 GB at 3.35 TB/s is 200 us, over 300 us of kernel D
    assert read("stencil_roofline", r) == pytest.approx(200 / 3)


def test_roofline_left_out_when_counts_disagree(fixture_record):
    r = copy.deepcopy(fixture_record)
    r["traced"]["counters"]["stencil.launches.mgbench.stencil.calls"] = 1
    assert read("stencil_roofline", r) is None
    r = copy.deepcopy(fixture_record)
    r["traced"]["device_ops"] = r["traced"]["device_ops"][1:]
    assert read("stencil_roofline", r) is None       # a launch not traced


def test_a_trace_is_complete_when_every_counted_launch_shows(
        fixture_record):
    from mgbench import counters
    t = copy.deepcopy(fixture_record["traced"])
    assert counters.complete(t)
    t["device_ops"] = t["device_ops"][1:]               # a replay dropped
    assert not counters.complete(t)


def test_untraced_record_reads_nothing_from_the_trace(fixture_record):
    r = dict(fixture_record, traced=None)
    for name in ("cycle.device_ms", "idle_share", "stencil_roofline"):
        assert read(name, r) is None


def test_idle_gaps_and_breakdown(fixture_record):
    t = fixture_record["traced"]
    assert trace.busy_us(t) == 400.0
    gaps = trace.top(trace.idle_gaps(t))
    assert gaps == [["solve", pytest.approx(450e-6)],
                    ["harness", pytest.approx(90e-6)],
                    ["sync", pytest.approx(60e-6)]]
    b = loop.breakdown(t)
    assert b["device_ops"][0] == ["void stencil_kernel<float, 1>",
                                  pytest.approx(200e-6)]
    assert len(b["device_ops"]) == 4
    d = loop.device_entry(torch.device("cpu"), 1, 0, t)
    assert d["busy_s"] == pytest.approx(400e-6)
    assert d["window_s"] == pytest.approx(1000e-6)


def test_short_name_keeps_anonymous_namespaces():
    n = "void at::native::(anonymous namespace)::reduce_kernel<512, 1>(R)"
    assert trace.short_name(n) == \
        "void at::native::{anon}::reduce_kernel<512, 1>"


def test_window_widens_to_the_traced_operations(fixture_record):
    t = copy.deepcopy(fixture_record["traced"])
    t["device_ops"].append(["late kernel", 1100.0, 100.0])
    assert trace.window(t) == (0.0, 1200.0)
    assert trace.busy_us(t) == 500.0


def test_reduce_chrome_keeps_device_ops_and_own_spans():
    events = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1, "dur": 2},
        {"ph": "X", "cat": "gpu_memset", "name": "m", "ts": 3, "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1, "dur": 9},
        {"ph": "X", "cat": "user_annotation", "name": "mgbench.solve",
         "ts": 0, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 0,
         "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]}
    out = trace.reduce_chrome(events)
    assert out == {"device_ops": [["k", 1.0, 2.0], ["m", 3.0, 1.0]],
                   "spans": [["solve", 0.0, 10.0]]}
