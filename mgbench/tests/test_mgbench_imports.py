"""Nothing the benchmark runs loads JAX or the JAX package: a fresh
process imports the harness and runs a cell's set-up and a short window
(16^3, on the CPU); the top-level names of sys.modules (before the first
dot, compared whole) then hold none of jax, jaxlib, flax, mgtpu.  And the
reference imports nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from mgbench.tests.conftest import ROOT

SCRIPT = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import make_tiny_root
from pathlib import Path
import tempfile
from mgbench import loop, run
with tempfile.TemporaryDirectory() as d:
    root = make_tiny_root(Path(d))
    out = loop.run("dcres3d-32x32x16.block8", 5, 0.2, True, device="cpu",
                   root=root)
print(json.dumps({{"bad": run.forbidden_modules(),
                   "mgtpu_torch": "mgtpu_torch" in sys.modules,
                   "correct": out["correct"]}}))
"""


def test_no_jax_after_a_run():
    code = SCRIPT.format(root=str(ROOT),
                         tests=str(ROOT / "mgbench" / "tests"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "mgtpu_torch": True, "correct": True}


def test_forbidden_names_are_compared_whole():
    from mgbench import run
    saved = dict(sys.modules)
    try:
        sys.modules["mgtpu_torchlike"] = sys
        sys.modules["jaxlib.x"] = sys
        assert "mgtpu_torchlike" not in run.forbidden_modules()
        assert "jaxlib.x" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _imports(path: Path, whole: bool = False) -> set[str]:
    """Top-level names of a file's imports (whole dotted names with
    `whole`)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name if whole else a.name.split(".")[0]
                      for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module if whole else node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    """The reference's files import plain libraries and each other."""
    for path in (ROOT / "mgbench" / "reference").glob("*.py"):
        assert _imports(path, whole=True) <= {
            "__future__", "numpy", "torch", "scipy", "mgbench.reference"}, \
            path


def test_harness_imports_no_jax_package():
    for path in (ROOT / "mgbench").rglob("*.py"):
        bad = _imports(path) & {"jax", "jaxlib", "flax", "mgtpu"}
        assert not bad, (path, bad)
