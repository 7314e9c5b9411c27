"""`correct` on whole runs on the CPU (Poisson cut to 16^3, the survey
cells at their own size) (the harness's look for a
card skipped): sound runs pass; the program's own float32 outer iteration
(the control) fails; so does each fault a cell can have, planted under the
timed call: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced."""
import pytest
import torch

from mgbench import loop

SEED = 2 ** 31 + 4242
CELLS = ["poisson3d-257.refined", "dcres3d-32x32x16.cg", "dcres3d-32x32x16.block8"]


def _run(root, workload, **kw):
    return loop.run(workload, SEED, 0.3, False, device="cpu", root=root,
                    **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_root, workload):
    r = _run(tiny_root, workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    c = r["checks"]["relres_max"]
    assert c["value"] < 1e-8 <= c["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_outer_float32_fails(tiny_root, workload):
    r = _run(tiny_root, workload, control="outer")
    assert not r["correct"]
    assert r["checks"]["relres_max"]["value"] > 3e-8


def test_control_bfloat16_levels_fail(tiny_root):
    r = _run(tiny_root, "dcres3d-32x32x16.cg", control="levels")
    assert not r["correct"]
    assert r["checks"]["level_gap_max"]["value"] > 1e-3


def _unchanged(solve):
    def call(b):
        x, it, ok = solve(b)
        return torch.zeros_like(x), it, ok
    return call


def _half_batch(solve):
    def call(b):
        x, it, ok = solve(b)
        x = x.clone()
        x[:, x.shape[1] // 2:] = 0
        return x, it, ok
    return call


def _altered(solve):
    def call(b):
        x, it, ok = solve(b)
        x = x.contiguous().clone()
        x.view(-1)[x.numel() // 3] += 1e-3 * float(x.abs().max())
        return x, it, ok
    return call


@pytest.mark.parametrize("workload,fault", [
    ("poisson3d-257.refined", _unchanged),
    ("dcres3d-32x32x16.cg", _unchanged),
    ("dcres3d-32x32x16.block8", _unchanged),
    ("dcres3d-32x32x16.block8", _half_batch),
    ("poisson3d-257.refined", _altered),
    ("dcres3d-32x32x16.cg", _altered),
    ("dcres3d-32x32x16.block8", _altered),
])
def test_planted_fault_is_caught(tiny_root, workload, fault):
    r = _run(tiny_root, workload, wrap=fault)
    assert not r["correct"], r["checks"]


def test_unconverged_solves_are_failed(tiny_root):
    def lies(solve):
        def call(b):
            x, it, ok = solve(b)
            return x, it, ok & False
        return call
    r = _run(tiny_root, "dcres3d-32x32x16.cg", wrap=lies)
    assert r["failed"] == r["attempted"] > 0
    assert not r["correct"]
