"""BENCHMARK.json against the benchmark's contract, and the result line's
schema from whole runs at 16^3 on the CPU."""
import json
import re

import pytest

from mgbench import loop, spec
from mgbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.benchmark()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "mgbench/run.py"]
    assert BENCH["paths"] == ["mgbench"]
    assert all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("mgbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg and k in cfg["assumed"]
        assert "assumed" in cfg and cfg["checks"]["relres_max"] >= cfg["tol"]
        assert callable(spec.assembly(cfg["operator"]).setup)
        assert callable(spec.reference(cfg["operator"]).level_errors)


def test_workloads():
    names = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] not in names and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        names.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] == 1
        mix = spec.load_json(ROOT / "mgbench" / "traffic"
                             / f"{w['traffic']}.json")
        assert _line(mix["source"])
        assert callable(spec.source(mix["rhs"]).make)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"solve_rate", "solve_ms_p95", "peak_mem_gib",
                        "setup_s"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    seen = set()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert NAME.match(m["name"]) and m["name"] not in seen
        assert m["name"] not in e2e
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:       # every cell: setup_s, another e2e, a layer metric
        parts = spec.cell(BENCH, w)
        got = {m["name"] for m in parts["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2 and parts["per_layer"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_result_line(tiny_root, workload, trace):
    r = loop.run(workload, 99, 0.3, trace, device="cpu", root=tiny_root)
    rec = r.pop("_record")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert isinstance(r["correct"], bool)
    assert r["attempted"] >= 1 and r["failed"] == 0
    parts = spec.cell(BENCH, workload)
    want = parts["per_layer"] if trace else parts["end_to_end"]
    units = {m["name"]: m["unit"] for m in want}
    assert set(r["metrics"]) <= set(units)
    for name, v in r["metrics"].items():
        assert set(v) == {"value", "unit"} and v["unit"] == units[name]
        assert isinstance(v["value"], float)
    if not trace:
        assert set(r["metrics"]) == set(units)
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for name, c in r["checks"].items():
        assert set(c) == {"value", "limit"} and NAME.match(name)
    json.dumps(r)
    assert rec["calls"] >= 1
