"""mgtpu_torch — the PyTorch/CUDA port of mgtpu's multigrid framework.

Geometric multigrid on regular meshes through the structured grid engine
(host Galerkin setup in scipy/numpy, full weighting or semicoarsening;
grid-form cycles on torch tensors) and smoothed-aggregation AMG
(``sa_amg_setup``: structured aggregates on the grid engine with a mesh,
greedy or MIS-2 aggregates on the flat ELL/DIA engine without) and
classical AMG (``classical_amg_setup``: C/F splitting by host C++ kernels
or PMIS on the device, direct or standard interpolation, on the flat
engine), with hand-written CUDA kernels for Hopper (``sm_90a``) on the 3D
constant-stencil levels, the variable-coefficient levels and transfers,
the DIA levels and line-Jacobi smoothing; MG-preconditioned Krylov solves
(CG, BiCGSTAB, FGMRES, their block forms) and K-cycles.  Imports torch,
numpy and scipy only — never JAX or ``mgtpu``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a card they raise.
"""

from .cycle.cycle import recursive_cycle
from .krylov import bicgstab, block_fgmres, fgmres, pcg
from .models.mesh import RegularMesh, get_cell_centered_grid, get_regular_mesh
from .setup.hierarchy import (MGConfig, MGState, build_device_hierarchy,
                              get_mg_param, mg_setup)
from .setup.classical_amg import classical_amg_setup
from .setup.sa_amg import sa_amg_setup
from .solvers.mg_solver import (get_afun, get_mg_preconditioner,
                                solve_bicgstab_mg, solve_cg_mg,
                                solve_gmres_mg, solve_mg, solve_mg_refined)

__all__ = ["RegularMesh", "get_regular_mesh", "get_cell_centered_grid",
           "MGConfig", "MGState", "get_mg_param", "mg_setup",
           "sa_amg_setup", "classical_amg_setup", "build_device_hierarchy",
           "recursive_cycle", "solve_mg",
           "solve_mg_refined", "get_afun", "get_mg_preconditioner",
           "solve_cg_mg", "solve_bicgstab_mg", "solve_gmres_mg", "pcg",
           "fgmres", "block_fgmres", "bicgstab"]

__version__ = "0.1.0"
