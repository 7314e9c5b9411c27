"""mgtpu_torch — the PyTorch/CUDA port of mgtpu's multigrid framework.

Geometric multigrid on regular meshes through the structured grid engine
(host Galerkin setup in scipy/numpy, full weighting or semicoarsening;
grid-form cycles on torch tensors), the staggered-systems engine
(elasticity and mixed elasticity: cross-grid stencil blocks, per-component
transfers, cell-wise Vanka smoothers; ``transfer_type=
"SystemsFaces(Mixed)Linear"``) and smoothed-aggregation AMG
(``sa_amg_setup``: structured aggregates on the grid engine with a mesh,
greedy or MIS-2 aggregates on the flat ELL/DIA engine without) and
classical AMG (``classical_amg_setup``: C/F splitting by host C++ kernels
or PMIS on the device, direct or standard interpolation, on the flat
engine), with hand-written CUDA kernels for Hopper (``sm_90a``) on the 3D
constant-stencil levels, the variable-coefficient levels and transfers,
the DIA levels, the staggered systems' blocks, line-Jacobi smoothing and
the lexicographic Vanka sweep and the hybrid Kaczmarz sweep; the
solver façade (``MGSolver``, ``SAAMGSolver``, ``ClassicalAMGSolver``),
the direct tier (``DirectSolver``, ``batched_dense_lu``), the Schur
solver, the hierarchy lifecycle (``replace_matrix_in_hierarchy``,
``transpose_hierarchy``), re-discretized hierarchies
(``OperatorConstructor``), external coarsest solvers and serial Schwarz
domain decomposition (``dd/``); MG-preconditioned Krylov solves
(CG, BiCGSTAB, FGMRES, their block forms) and K-cycles.  The cycles, the
refinement loop and the Krylov iterations run as CUDA graphs on the card
(``cycle/capture.py``: mgtpu's compiled programs).  The multi-device
grid tier (``parallel/``, ``dd/parallel.py``) runs the grid engine, its
solves and the Schwarz sweep over ranks of ``torch.distributed`` (NCCL,
or gloo).  Imports torch, numpy and scipy only — never JAX or
``mgtpu``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a card they raise.
"""

from .cycle.cycle import cycle_jit, make_cycle_fn, recursive_cycle
from .cycle.grid_cycle import grid_cycle_jit
from .cycle.systems_grid import systems_grid_cycle_jit
from .krylov import bicgstab, block_fgmres, fgmres, pcg
from .models.mesh import (RegularMesh, get_cell_centered_grid, get_nodal_grid,
                          get_regular_mesh)
from .setup.hierarchy import (Hierarchy, Level, MGConfig, MGState,
                              OperatorConstructor, build_device_hierarchy,
                              clear, copy_solver,
                              get_mg_param, hierarchy_exists, mg_setup,
                              replace_matrix_in_hierarchy,
                              transpose_hierarchy)
from .setup.classical_amg import classical_amg_setup
from .setup.sa_amg import sa_amg_setup
from .solvers.direct import DirectSolver, batched_dense_lu
from .solvers.mg_solver import (get_afun, get_mg_preconditioner,
                                solve_bicgstab_mg, solve_cg_mg,
                                solve_gmres_mg, solve_mg, solve_mg_jit,
                                solve_mg_refined)
from .solvers.schur import SchurComplementSolver
from .solvers.wrappers import ClassicalAMGSolver, MGSolver, SAAMGSolver

__all__ = ["RegularMesh", "get_regular_mesh", "get_cell_centered_grid",
           "get_nodal_grid", "MGConfig", "MGState", "Hierarchy", "Level",
           "get_mg_param", "mg_setup",
           "OperatorConstructor", "transpose_hierarchy",
           "replace_matrix_in_hierarchy", "copy_solver", "clear",
           "hierarchy_exists", "MGSolver", "SAAMGSolver",
           "ClassicalAMGSolver", "DirectSolver", "batched_dense_lu",
           "SchurComplementSolver",
           "sa_amg_setup", "classical_amg_setup", "build_device_hierarchy",
           "recursive_cycle", "cycle_jit", "make_cycle_fn", "grid_cycle_jit",
           "systems_grid_cycle_jit",
           "solve_mg", "solve_mg_jit", "solve_mg_refined", "get_afun", "get_mg_preconditioner",
           "solve_cg_mg", "solve_bicgstab_mg", "solve_gmres_mg", "pcg",
           "fgmres", "block_fgmres", "bicgstab"]

__version__ = "0.1.0"
