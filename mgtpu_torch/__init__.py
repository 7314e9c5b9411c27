"""mgtpu_torch — the PyTorch/CUDA port of mgtpu's multigrid framework.

Geometric multigrid on regular meshes through the structured grid engine:
host Galerkin setup (scipy/numpy; full weighting or semicoarsening),
grid-form cycles on torch tensors, and hand-written CUDA kernels for Hopper
(``sm_90a``) on the 3D constant-stencil levels and for line-Jacobi
smoothing.  Imports torch, numpy and scipy only — never JAX or ``mgtpu``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a card they raise.
"""

from .models.mesh import RegularMesh, get_regular_mesh
from .setup.hierarchy import MGConfig, MGState, get_mg_param, mg_setup
from .solvers.mg_solver import solve_mg, solve_mg_refined

__all__ = ["RegularMesh", "get_regular_mesh", "MGConfig", "MGState",
           "get_mg_param", "mg_setup", "solve_mg", "solve_mg_refined"]

__version__ = "0.1.0"
