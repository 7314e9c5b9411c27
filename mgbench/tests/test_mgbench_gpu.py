"""On the card (marked gpu; skips without one, decided inside the test): a
whole run at 16^3 through the recorded programs and the kernels, traced,
is correct, and its roofline and device readings are shares of the
window; the float32 outer control is not correct.

    python -m pytest -m gpu mgbench/tests/test_mgbench_gpu.py
"""
import pytest
import torch

from mgbench import loop

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.parametrize("workload", ["poisson3d-257.refined",
                                      "dcres3d-32x32x16.block8"])
def test_traced_run_on_the_card(tiny_root, workload):
    _need_card()
    r = loop.run(workload, 11, 1.0, True, device="cuda:0", root=tiny_root)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert 0 < m["idle_share"]["value"] < 100
    assert m["launches_per_solve"]["value"] > 0
    for k, v in m.items():
        if k.endswith("_roofline"):
            assert 0 < v["value"] <= 105
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]


def test_control_fails_on_the_card(tiny_root):
    _need_card()
    r = loop.run("dcres3d-32x32x16.cg", 12, 0.5, False, device="cuda:0",
                 root=tiny_root, control="outer")
    assert not r["correct"]
