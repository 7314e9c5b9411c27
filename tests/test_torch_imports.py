"""The PyTorch port stands alone: importing it loads neither JAX nor mgtpu,
and its entry points run on the card unless the caller asks for the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu_torch as mt
from mgtpu_torch.config import resolve_device
from mgtpu_torch.models.operators import nodal_laplacian_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK = """
import sys
import mgtpu_torch, mgtpu_torch.convert, mgtpu_torch.ops.cuda.fused3d
import mgtpu_torch.cycle.grid_cycle, mgtpu_torch.solvers.mg_solver
import mgtpu_torch.ops.cuda.stencil, mgtpu_torch.ops.cuda.tridiag
import mgtpu_torch.krylov, mgtpu_torch.parallel.stencil
import mgtpu_torch.setup.sa_amg, mgtpu_torch.cycle.cycle
import mgtpu_torch.cycle.coarse, mgtpu_torch.ops.ell, mgtpu_torch.ops.dia
import mgtpu_torch.setup.classical_amg, mgtpu_torch.setup.device_agg
import mgtpu_torch.setup.native
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "mgtpu" or m.startswith("mgtpu."))
print("LOADED:" + ",".join(bad))
"""


def test_import_loads_no_jax_and_no_mgtpu():
    out = subprocess.run([sys.executable, "-c", CHECK], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED:\n" in out.stdout, out.stdout


def _tiny():
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [8, 8])
    return M, nodal_laplacian_matrix(M)


def test_mg_setup_defaults_to_cuda():
    """Without device=, mg_setup targets the card: it raises when there is
    none and places the hierarchy on it when there is."""
    M, L = _tiny()
    cfg, rp = mt.get_mg_param(levels=2, relax_type="jacobi")
    if torch.cuda.is_available():
        st = mt.mg_setup(L, M, cfg, rp)
        assert st.device.type == "cuda"
        assert st.hier.levels[0].A.const.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mt.mg_setup(L, M, cfg, rp)


def test_sa_amg_setup_defaults_to_cuda():
    """sa_amg_setup, with a mesh (grid engine) or without (flat engine),
    targets the card unless asked for the CPU."""
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [16, 16])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-2 * sp.identity(L.shape[0])).tocsr()
    cfg, rp = mt.get_mg_param(levels=2, relax_type="spai")
    for mesh in (M, None):
        if torch.cuda.is_available():
            st = mt.sa_amg_setup(L, cfg, rp, mesh=mesh)
            assert st.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mt.sa_amg_setup(L, cfg, rp, mesh=mesh)
        st = mt.sa_amg_setup(L, cfg, rp, mesh=mesh, device="cpu")
        assert st.device == torch.device("cpu")
        assert type(st.hier).__name__ == ("GridHierarchy" if mesh is not None
                                          else "Hierarchy")


@pytest.mark.parametrize("coarsening", ["common-c", "pmis"])
def test_classical_amg_setup_defaults_to_cuda(coarsening):
    """classical_amg_setup targets the card unless asked for the CPU; its
    PMIS coloring runs on the state's device."""
    from mgtpu_torch.setup import device_agg
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [16, 16])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-2 * sp.identity(L.shape[0])).tocsr()
    cfg, rp = mt.get_mg_param(levels=2, relax_type="spai")
    if torch.cuda.is_available():
        st = mt.classical_amg_setup(L, cfg, rp, coarsening=coarsening)
        assert st.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mt.classical_amg_setup(L, cfg, rp, coarsening=coarsening)
    device_agg.ROUNDS.clear()
    st = mt.classical_amg_setup(L, cfg, rp, coarsening=coarsening,
                                device="cpu")
    assert st.device == torch.device("cpu")
    assert type(st.hier).__name__ == "Hierarchy"
    assert len(device_agg.ROUNDS) == (coarsening == "pmis")


def test_cpu_on_request_and_solves_stay_on_the_state_device():
    M, L = _tiny()
    cfg, rp = mt.get_mg_param(levels=2, relax_type="jacobi", relax_param=0.8)
    st = mt.mg_setup(L, M, cfg, rp, device="cpu")
    assert st.device == torch.device("cpu")
    b = L @ np.ones(L.shape[0]) + 1.0
    x, _ = mt.solve_mg(st, b)
    assert x.device == torch.device("cpu") and tuple(x.shape) == b.shape


def test_resolve_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
