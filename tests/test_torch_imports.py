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
import mgtpu_torch.setup.native, mgtpu_torch.cycle.systems_grid
import mgtpu_torch.cycle.vanka, mgtpu_torch.ops.cross_stencil
import mgtpu_torch.ops.cuda.vanka, mgtpu_torch.ops.cuda.kaczmarz
import mgtpu_torch.cycle.kaczmarz, mgtpu_torch.dd.indices
import mgtpu_torch.dd.schwarz, mgtpu_torch.solvers.direct
import mgtpu_torch.solvers.schur, mgtpu_torch.solvers.wrappers
import mgtpu_torch.parallel.comm, mgtpu_torch.parallel.launch
import mgtpu_torch.parallel.sharded, mgtpu_torch.parallel.grid_sharded
import mgtpu_torch.parallel.sharded_solve, mgtpu_torch.dd.parallel
import mgtpu_torch.parallel.systems_sharded, mgtpu_torch.parallel.sharded_amg
import mgtpu_torch.parallel.part_amg
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


def test_part_amg_names_match_mgtpu():
    """The partitioned tier's module exports mgtpu's names (mgtpu exports
    them from the module, not from the package root)."""
    import mgtpu
    import mgtpu.parallel.part_amg as ref
    import mgtpu_torch.parallel.part_amg as ours
    assert sorted(ours.__all__) == sorted(ref.__all__)
    assert all(hasattr(ours, n) for n in ours.__all__)
    assert not any(n in getattr(mgtpu, "__all__", ()) for n in ref.__all__)


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


def test_root_exports_match_mgtpu_names():
    """The package root carries mgtpu's root names get_nodal_grid,
    Hierarchy and Level (mgtpu/__init__.py), the same objects as their
    modules'; enable_x64, JAX's x64 switch, has no torch meaning."""
    from mgtpu_torch.models.mesh import get_nodal_grid
    from mgtpu_torch.setup.hierarchy import Hierarchy, Level
    assert mt.get_nodal_grid is get_nodal_grid
    assert mt.Hierarchy is Hierarchy and mt.Level is Level
    for name in ("get_nodal_grid", "Hierarchy", "Level"):
        assert name in mt.__all__
    assert not hasattr(mt, "enable_x64")
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [4, 2])
    assert mt.get_nodal_grid(M).shape[0] == 15
