"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
with every configuration of more than TINY_NODES unknowns cut to 16^3
cells and 3 levels, so that a whole run fits a test.  Run from the repository root:

    python -m pytest mgbench/tests -q
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CELLS = [16, 16, 16]
TINY_LEVELS = 3
TINY_NODES = 40_000


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one (decided "
        "inside the test)")


def make_tiny_root(dest: Path) -> Path:
    """BENCHMARK.json, mgbench/configs (cut) and mgbench/traffic under
    `dest`: the data a run reads, the code staying the repository's."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dest / "mgbench" / "configs").mkdir(parents=True)
    shutil.copytree(ROOT / "mgbench" / "traffic", dest / "mgbench" / "traffic")
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        nodes = 1
        for n in cfg["cells"]:
            nodes *= n + 1
        if nodes > TINY_NODES:
            cfg["cells"] = TINY_CELLS
            cfg["mg"]["levels"] = TINY_LEVELS
        (dest / c["file"]).write_text(json.dumps(cfg))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def fixture_record():
    return json.loads((Path(__file__).parent / "fixtures" /
                       "traced_record.json").read_text())
