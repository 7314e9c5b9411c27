"""A new kind of right-hand side, traffic mix, operator, configuration or
per-layer metric is new files and new entries: nothing that exists
changes.  Each test writes its throwaway files into the tiny copy of the
benchmark (where the harness looks first for code found by name) and runs
a cell of its own there."""
import json

from mgbench import loop, spec

SPIKES = '''
import torch


def make(mix, cfg, seed, device):
    n = 1
    for c in cfg["cells"]:
        n *= int(c) + 1
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    B = torch.zeros((int(mix["pool"]), n, int(mix["columns"])),
                    dtype=torch.float64)
    idx = torch.randint(0, n, (int(mix["pool"]), int(mix["spikes"])),
                        generator=g)
    B.scatter_(1, idx[:, :, None].expand(-1, -1, B.shape[2]), 1.0)
    return B.to(device)
'''

LAP_PROGRAM = '''
from mgbench.operators._nodal import levels, setup  # noqa: F401
'''

LAP_REFERENCE = '''
import numpy as np

from mgbench.reference import nodal

level_errors = nodal.level_errors


def inputs(cfg, seed):
    return {"sigma": np.ones(tuple(reversed(cfg["cells"])))}


def operator(cfg, inputs, device):
    return nodal.NodalOperator(cfg["cells"], None, cfg["shift_rel"], device)
'''

HALF_ITERS = '''
def read(record):
    return sum(record["iters"]) / 2 / len(record["iters"]) \\
        if record["iters"] else None
'''


def _write(root, rel, text):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def _edit_bench(root, fn):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    fn(bench)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def test_new_kind_of_right_hand_side_and_mix(tiny_root):
    _write(tiny_root, "mgbench/sources/spikes.py", SPIKES)
    _write(tiny_root, "mgbench/traffic/spikes2.json", json.dumps(
        {"rhs": "spikes", "columns": 2, "pool": 3, "sample": 2, "spikes": 5,
         "source": "throwaway", "about": "two spike columns a call"}))
    bench = _edit_bench(tiny_root, lambda b: b["workloads"].append({
        "name": "dcres3d-32x32x16.spikes2", "config": "dcres3d-32x32x16",
        "traffic": "spikes2", "chips": 1, "why": "throwaway cell"}))
    r = loop.run("dcres3d-32x32x16.spikes2", 3, 0.3, False, device="cpu",
                 root=tiny_root)
    assert r["correct"], r["checks"]
    assert r["attempted"] % 2 == 0 and r["attempted"] >= 2
    parts = spec.cell(bench, "dcres3d-32x32x16.spikes2", tiny_root)
    layer = {m["name"] for m in parts["per_layer"]}
    assert "idle_share" in layer and "krylov_iters" not in layer
    assert {m["name"] for m in parts["end_to_end"]} == {
        "solve_rate", "solve_ms_p95", "peak_mem_gib", "setup_s"}


def test_new_operator_kind_and_configuration(tiny_root):
    _write(tiny_root, "mgbench/operators/lap.py", LAP_PROGRAM)
    _write(tiny_root, "mgbench/reference/lap.py", LAP_REFERENCE)
    cfg = json.loads((tiny_root / "mgbench" / "configs"
                      / "dcres3d-32x32x16.json").read_text())
    cfg.update(name="lap3d", operator="lap", cells=[8, 8, 8])
    cfg["mg"]["levels"] = 3
    _write(tiny_root, "mgbench/configs/lap3d.json", json.dumps(cfg))

    def add(b):
        b["configs"].append({"name": "lap3d", "source": "throwaway",
                             "file": "mgbench/configs/lap3d.json",
                             "reduced": [], "why": "throwaway"})
        b["workloads"].append({"name": "lap3d.small", "config": "lap3d",
                               "traffic": "survey_small", "chips": 1,
                               "why": "throwaway cell"})
    _edit_bench(tiny_root, add)
    # the survey's layout on 8 x 8 cells, a new mix of data only
    mix = json.loads((tiny_root / "mgbench" / "traffic"
                      / "survey1.json").read_text())
    mix.update(margin=1, pool=4, sample=2)
    _write(tiny_root, "mgbench/traffic/survey_small.json", json.dumps(mix))
    r = loop.run("lap3d.small", 4, 0.3, False, device="cpu",
                 root=tiny_root)
    assert r["correct"], r["checks"]
    assert r["checks"]["level_gap_max"]["value"] < 1e-5
    r = loop.run("lap3d.small", 4, 0.3, False, device="cpu",
                 root=tiny_root, control="outer")
    assert not r["correct"]


def test_configuration_on_another_solver_and_a_new_metric(tiny_root):
    cfg = json.loads((tiny_root / "mgbench" / "configs"
                      / "dcres3d-32x32x16.json").read_text())
    cfg.update(name="dcres3d-bicg",
               solve={"entry": "solve_bicgstab_mg", "kwargs": {},
                      "iterations": "krylov"})
    _write(tiny_root, "mgbench/configs/dcres3d-bicg.json", json.dumps(cfg))
    _write(tiny_root, "mgbench/metrics/half_iters.py", HALF_ITERS)

    def add(b):
        b["configs"].append({"name": "dcres3d-bicg", "source": cfg["source"],
                             "file": "mgbench/configs/dcres3d-bicg.json",
                             "reduced": cfg["reduced"], "why": "throwaway"})
        b["workloads"].append({"name": "dcres3d-bicg.survey1",
                               "config": "dcres3d-bicg", "traffic": "survey1",
                               "chips": 1, "why": "throwaway cell"})
        b["per_layer"].append({"name": "half_iters", "unit": "iters",
                               "better": "lower", "source": "program_counter",
                               "layer": "Krylov", "moves": "solve_rate",
                               "workloads": ["dcres3d-bicg.survey1"]})
    _edit_bench(tiny_root, add)
    r = loop.run("dcres3d-bicg.survey1", 4, 0.3, True, device="cpu",
                 root=tiny_root)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert "launches_per_solve" in m
    it = r["_record"]["iters"]
    assert "krylov_iters" not in m              # not listed for this cell
    assert m["half_iters"]["value"] == sum(it) / 2 / len(it)
    r = loop.run("dcres3d-bicg.survey1", 4, 0.3, False, device="cpu",
                 root=tiny_root, control="outer")
    assert not r["correct"]
