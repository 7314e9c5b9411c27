"""Finds a cell's parts by the names in BENCHMARK.json: its configuration
file, its traffic mix (traffic/<mix>.json), the generator of its kind of
right-hand side (sources/<rhs>.py), its operator's program-side set-up
(operators/<kind>.py) and plain reference (reference/<kind>.py), the byte
counters of the kernels (kernels/*.py) and the reader of each per-layer
metric (metrics/<metric>.py).

Code found by name is loaded from its file, first under the run's `root`
and then from this folder, so that a new kind is a new file and nothing
that exists changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, its configuration (the file's contents) and its
    traffic mix, and the metric entries it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(Path(root) / conf["file"])
    mix = load_json(Path(root) / "mgbench" / "traffic"
                    / f"{w['traffic']}.json")
    return {"workload": w, "config": cfg, "traffic": mix, "root": Path(root),
            "end_to_end": [m for m in bench["end_to_end"]
                           if reports(m, workload)],
            "per_layer": [m for m in bench["per_layer"]
                          if reports(m, workload)
                          and any(e["name"] == m["moves"]
                                  and reports(e, workload)
                                  for e in bench["end_to_end"])]}


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def code(folder: str, name: str, root: Path = ROOT):
    """The module in <folder>/<name>.py under root/mgbench, or else under
    this folder (a name may hold dots, so it is loaded by its path)."""
    for base in (Path(root) / "mgbench", HERE):
        path = base / folder / f"{name}.py"
        if path.exists():
            break
    else:
        raise KeyError(f"no {folder}/{name}.py")
    modname = f"mgbench_{folder}_" + name.replace(".", "_").replace("-", "_")
    mod = sys.modules.get(modname)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def names(folder: str, root: Path = ROOT) -> list[str]:
    """Every <name> of <folder>/<name>.py, under root/mgbench and here."""
    found = set()
    for base in (Path(root) / "mgbench", HERE):
        found |= {p.stem for p in (base / folder).glob("*.py")
                  if not p.stem.startswith("_")}
    return sorted(found)


def assembly(kind: str, root: Path = ROOT):
    return code("operators", kind, root)


def reference(kind: str, root: Path = ROOT):
    return code("reference", kind, root)


def source(rhs: str, root: Path = ROOT):
    return code("sources", rhs, root)


def reader(metric: str, root: Path = ROOT):
    """metrics/<metric>.py's `read(record) -> float | None`."""
    return code("metrics", metric, root).read
