#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mgtpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. card   — name and power limit (nvidia-smi) and torch's device name;
2. build  — compile every kernel from mgtpu_torch/csrc with nvcc (sm_90a),
            print ptxas's register, shared-memory and spill lines;
3. kernel — every kernel against its plain torch version on the card, on the
            3D bench operators (fine nd=7, Galerkin nd=27) at 129^3 (m=1-3),
            on the hierarchy's coarser levels, on non-cubic grids and at
            kernel A's plan edges (X = 16, ragged tiles, the wide tile);
            kernel B also against kernel A's jacobi followed by its
            residual (bit for bit, else 2e-5 / 1e-4), with its plan;
            then each kernel's device time (CUDA events, L2 cold at 129^3)
            at 129^3 nd 7 and 27, 65^3, 33^3 and 17^3 beside its byte bound,
            its plain version and a conv3d yardstick, with kernel A's and
            kernel B's plans;
4. path 3D — the 128^3 shifted nodal Laplacian (5 levels, float32):
            mg_setup + solve_mg, refined Jacobi 0.8 V(1,1) to 1e-8 (23 +- 1
            iterations), refined Chebyshev(3) V(1,0) (11 +- 1), and the
            library's default SPAI V(2,2) solve; true f64 residuals on the
            host; launch counters prove the kernels ran and no plain version
            did, and count kernel B's calls by grid;
5. path 2D — the 1024^2 problem, refined Jacobi to 1e-8 (16 +- 1), plain
            torch on the card (no kernel on 2D levels);
6. line kernel — the tridiagonal line kernel (solve and correct) against its
            plain version on every line axis of 1025^2 and 129^3 (m = 1-3),
            on a (19, 25, 31) grid, in float32 and float64, with the line_prec
            coefficients of configurations (a) and (d), and at its plan's
            edges (2- and 3-node lines, ragged strided tiles, the streamed
            variant on (4097, 40) and (40, 8193)); then its device time on
            the strided and the contiguous axes of 1025^2 and 129^3, with
            the plan;
7. path aniso — the anisotropic configurations, f32, refined to 1e-8:
            (a) 2D eps = 100 line Jacobi 0.8 (11 +- 1 iterations),
            (b) 2D eps = 0.01 semicoarsening + line Jacobi 0.9, 7 levels (6),
            (b6) the same at 6 levels, on a 33 x 257 coarsest whose dense
            inverse is built on the card (6),
            (c) 2D mixed strength, alternating lines 0.9 (21),
            (d) 3D eps = 50 on grid axis 0, line Jacobi 0.8 (11),
            (e) the same on grid axis 2 (11);
            launch counters prove the line kernel (both modes) and kernel A's
            matvec ran and no plain version did;
8. path 2D FMG — the 1024^2 problem, Chebyshev(3) V(1,0) refined from a
            full-multigrid start (6 +- 1);
9. stencil kernel — kernel D (the variable-coefficient stencil apply)
            against its plain version on every level of the rough-sigma
            DivSigGrad hierarchies (f) 1025^2 and (h) 129^3 (nd = 5, 7, 9,
            27), on (25, 41) and (19, 25, 31) grids and the slab form, at
            m = 1, 2, 4, in float32 (2e-5) and float64 (1e-12); then its
            device time per level beside its byte bound, its plain version
            and torch.sparse.mm of the operator's CSR form, with its launch
            plan (stream or split);
10. path Krylov — the rough-sigma DivSigGrad solves, f32 hierarchies with
            float64 right-hand sides, to a true f64 relres below 1e-8:
            (f) solve_cg_mg 19 +- 1 iterations, f-bicg solve_bicgstab_mg 12,
            f-block solve_cg_mg(block=True) on 4 right-hand sides 22,
            (g) Jac-GMRES K-cycles under solve_gmres_mg 4 restarts,
            (h) 3D 128^3 solve_cg_mg 16; launch counters prove kernel D ran
            in float32 and float64 and its plain version did not; one CG
            iteration's time by CUDA events and the host clock, and the
            device busy share;
11. AMG   — smoothed aggregation on the 512^2 rough-sigma operator, f32,
            4 levels: kernel D against its plain version on every SA-s
            level (5 / 13 / 37 / 97 taps), the 3D SA levels of a 32^3
            hierarchy (7 / 33 / 179), the DIA form of SA-f's fine level and
            both stride-2 transfer applies (against P @ x, P^T @ r), f32
            (2e-5) and f64 (1e-12), m = 1, 3, and a 257-tap stencil
            refused; at its plan's edges (1, 9 and 256 taps, m = 1, 3, 8,
            9, splits 1, 2, 16, both sides of the stream/split boundary,
            the parity-form transfers on odd and even extents in 2D and
            3D); its device time and plan at those shapes beside its byte
            bound (P's own for the transfers), its plain version and
            torch.sparse.mm (of P^T for the restricts, of the 3D levels'
            CSR); then (SA-s) structured
            SA, SPAI V(2,2) (38 +- 1 refined iterations), (SA-K) the same
            operator with Jac-GMRES K-cycles (48), (SA-f) greedy SA on the
            flat engine (50), each to a true f64 relres below 1e-8, with
            setup time, hierarchy, coarsest solver (a 4225-dof inverse
            built on the card; DenseLU of 964) and operator complexity
            (2.40 / 1.63); launch counters prove kernel D ran in float32
            and float64 in each solve and no plain version did; one cycle's
            time by CUDA events and the host clock, and the busy share;
12. classical — bench.py's agg_ab problem (SA-f's operator, 512^2, f32,
            4 levels, SPAI V(2,2)), set up on the card and solved inside
            one launch-counter window: (C-cc) classical AMG with the C++
            common-C coloring and direct interpolation (13 +- 1 refined
            iterations), (C-pmis) PMIS coloring on the card (13), (SA-dev)
            SA with MIS-2 aggregation on the card (20), each to a true f64
            relres below 1e-8 at its operator complexity (2.7356 / 3.1210 /
            2.2391 +- 0.01), level sizes, formats and coarsest solver
            (SuperLU / SuperLU / DenseLU), with the setup's host and device
            seconds and the device loops' round counts; (C-cg) C-cc under
            solve_cg_mg (8 +- 1, true relres <= 1e-7); counters prove the
            C++ coloring ran, kernel D ran in f32 and f64 in each solve and
            no plain version did; then kernel D against its plain version
            on C-cc's two DIA levels (f32 2e-5, f64 1e-12) and its times
            there; one cycle of each by CUDA events and the host clock, and
            the busy share.

13. systems — the staggered-systems engine, f32 hierarchies, each to
            mgtpu's count +- 1 and a true f64 relres below 1e-8 inside one
            launch-counter window: (V-2d) mixed elasticity at 1024^2,
            VankaFaces 0.75 V(1,1), 6 levels, refined (9), (E-2d)
            elasticity at 1024^2, SPAI 0.75 V(2,2), 6 levels (28), (V-3d)
            mixed elasticity at 64^3, 5 levels (12), (E-cg) E-2d's
            hierarchy under solve_cg_mg (13); the Vanka variants on the
            64^2 mixed problem, 4 levels: econ (9), add (15), tuple
            weights (8) on the systems engine, lex on kernel E (9) and
            cell Kaczmarz V(2,2) (31) on the flat one; each setup's host
            seconds by stage (RAP, transfers, cross stencils, smoother,
            coarsest inverse) and its f64 residual operator; counters
            prove kernel D's block form ran in f32 and f64 in each
            systems-engine solve (every level's apply and residual one
            launch, no cross or halo launch in the window), kernel E in
            the lex solve, and no plain version anywhere; one cycle of
            V-2d, E-2d, V-3d by CUDA events, the host clock and
            torch.profiler.  Then kernel D's cross apply against its
            plain version on every block of every level of V-2d and V-3d
            (f32 2e-5, f64 1e-12, m = 1, 2; a square block bitwise the
            square apply) and its time on V-2d's fine (0, 2) block beside
            its byte bound and torch.sparse.mm of the block's CSR (no
            systems level runs it block by block); kernel D's
            block form (csrc/block_stencil.cu) on every level operator of
            V-2d and V-3d and their f64 residual operators, apply and
            residual, m = 1, 2, 5, bit for bit the per-block cross
            applies, torch's adds and subtraction and within 2e-5 / 1e-12
            of its plain version, and its residual's time on V-2d's and
            V-3d's fine levels and V-2d's f64 operator beside its byte
            bound, the per-block path, its plain version and b -
            torch.sparse.mm of the level's CSR, with ptxas's registers;
            kernel E against its per-cell loop on a 32^2 mixed problem
            and every level of the lex hierarchy (f32 1e-5, f64 1e-12)
            and its time on the 64^2 fine level.

15. kernel F — the hybrid Kaczmarz sweep against its plain version
            (mgtpu's row_step in torch) on every level of the K-mg
            hierarchy, the K-prec level and a ragged 255^2 mesh with
            padded domains, f32 (2e-5) and f64 (1e-12), m = 1-3, a second
            launch bitwise the first; then its time (CUDA events) on the
            K-mg fine level and level 1 beside its byte bound, its
            dependency-chain bound and the plain version;
16. façade — inside one launch-counter window, each to mgtpu's count
            +- 1 (scripts/facade_reference.py) at a true f64 relres below
            1e-8: (W) MGSolver gmres / pcg / bicgstab on (f)'s 1024^2
            operator, SPAI V(2,2), 4 columns (4 / 15 / 10 a column; the
            second call reuses the setup), (W-3d) MGSolver pcg on 128^3
            (7; kernels A and B), (W-amg) SAAMGSolver / ClassicalAMGSolver
            at 512^2 (15 / 9), (W-adj) MGSolver(sym=0) gmres on the
            nonsymmetric 1024^2 operator: solve, adjoint, solve (1 / 1 / 1
            restarts below 1e-6; the third x bitwise the first), (R) four
            replace_matrix_in_hierarchy calls on the 2D state (min
            seconds, CUDA memory within 5 %) and refined Jacobi (16),
            (R-sigma) (f)'s state replaced by sigma' under CG (20, a fresh
            setup's count), (D) DirectSolver dense on the card and host in
            four value types (test_solvers.py's tolerances), (D-coarse)
            and (DD-coarse) the 2D operator with a DirectSolver / DDSolver
            coarsest on the flat engine (16 / 16), (S) the Schur solver on
            64^2 mixed elasticity (dense below 1e-10; the Kaczmarz inner
            below 0.5 on kernel F), (DD-256) DDSolver [8, 8] overlap 2
            under FGMRES(5) (6 restarts), (K-mg) solve_mg with hybrid
            Kaczmarz on kernel F (17), (K-prec) Kaczmarz-preconditioned
            FGMRES (3 restarts, capped by max_iter; below 1e-10), (bf16) 3D Jacobi refined with bfloat16 cycles (22;
            their plain calls counted and printed), (RD) 512^2 mixed
            elasticity re-discretized, Vanka (11); counters prove kernels
            A, B, D and F ran and no plain version did (but bf16's).

17. complex — the complex hierarchies (scripts/complex_reference.py),
            each to mgtpu's count +- 1 at a true complex128 relres below
            1e-8 computed on the host, inside one launch-counter window:
            the heterogeneous shifted-Laplacian Helmholtz operator
            L - (1 - 0.5i) diag(k^2) in complex64 hierarchies with
            complex128 outer solves: (H-2d) 1024^2, kh 0.125, Jacobi 0.8
            V(1,1), 5 levels, refined (17), (H-bicg) BiCGSTAB (6),
            (H-gmres) FGMRES(5) (3 restarts), (H-K) Jac-GMRES K-cycles
            refined (14), (H-3d) 128^3 refined (23), (H-3d-bicg) (7),
            (H-3d-gmres) (3); (Z-sa) / (Z-cl) the 512^2 complex-shifted
            rough DivSigGrad under greedy SA / classical AMG, SPAI V(2,2),
            4 levels, refined (20 / 10), with their level sizes and
            operator complexities; (K-c) 256^2, kh 0.25, complex128 hybrid
            Kaczmarz, solve_mg (18); each setup's host seconds by stage;
            counters prove kernel D ran in complex64 and complex128 and
            kernel F in complex128, and no plain version.  Before the
            window, kernel D's complex instantiations against their plain
            versions (2e-5 / 1e-12) on H-2d's and H-3d's fine levels and
            their complex128 residual operators, the stride-2 transfers
            of H-2d's operator under structured SA (1025^2 -> 513^2,
            restrict = P^H) and Z-sa's DIA fine level; kernel F's complex
            instantiations on K-c's fine level; their times beside their
            bounds, plain versions and torch.sparse.mm.

18. complex rest — the complex rows of scripts/complex_rest_reference.py
            at full width, each to mgtpu's count +- 1 at a true complex128
            relres below 1e-8, inside one launch-counter window, every one
            held against its eager run: (CL-2d) eps = 100 + the Helmholtz
            shift (kh 0.125) at 1024^2, line Jacobi 0.8 V(1,1), 5 levels
            (11), (CL-3d) eps = 50 on grid axis 0 at 128^3 (11), (CS-2d)
            eps = 0.01, kh 0.01, semicoarsening + line Jacobi 0.9, 7 levels
            (6), (CV-2d) mixed elasticity + (1e-3 + 1e-3i) at 1024^2,
            VankaFaces 0.75 V(1,1), 6 levels (9), (CE-2d) elasticity, SPAI
            0.75 V(2,2) (28), (C-lex) / (C-kacz) the mixed operator at 64^2
            on the flat engine (9 / 18), (Z-dev) Z-sa's operator with MIS-2
            aggregation on the card (12), (H-cd) H-2d in a complex128
            hierarchy cycled in complex64 (16), and CL-2d and C-lex in
            complex128 hierarchies (11 / 9); complex64 hierarchies else;
            counters prove kernel C, D's block form and E ran in
            complex64 and complex128, D's cross form not at all, and no
            plain version.  Before the window, those instantiations
            against their plain versions (C on CL-2d's, CL-3d's and every
            CS-2d level's lines, 2e-4 / 1e-10; the cross form on every
            block of CV-2d's fine level and its complex128 residual
            operator, 2e-5 / 1e-12; the block form on every level of
            CV-2d and its complex128 residual operator, m = 1, 2, 5, bit
            for bit the per-block path; E on every C-lex level, 1e-5 /
            1e-12) and their times beside their bounds, plain versions and
            (D) torch.sparse.mm.

19. multi-device — the scalar grid tier of mgtpu_torch/parallel/ and
            dd/parallel.py: kernel D's halo apply against its plain
            version (f32 2e-5, f64 1e-12) on MS-2d's fine slab (288 x
            1025 of 1025^2 over 4 ranks), MG-2d's fine block (257 x
            1025; f64: the refined residual's operator) and 9-tap level
            1 (129 x 513), MG-pen's fine block and level 1 (513^2,
            257^2, halos on both axes) and MG-3d's fine block (33 x
            129^2), its times beside its bound, plain version and
            torch.sparse.mm; kernel D's halo form (csrc/halo_stencil.cu)
            on the same blocks: apply, residual and slab Jacobi update,
            m = 1, 2, 5, with random neighbour planes and the ends'
            zeros, bit for bit the old path (the planes catted,
            halo_apply, torch's subtraction or update) and within 2e-5 /
            1e-12 of its plain version, the overlapped slab's two
            launches bitwise the whole; its residual's time on MS-2d's
            slab and MG-3d's block beside its bound, the old path, its
            plain version and b - torch.sparse.mm; then, spawned by
            parallel/launch.py after the kernels are built, 1 NCCL rank
            and 4 gloo ranks sharing
            the card (host-staged exchanges: those times say nothing of
            NVLink), each inside one window of kernel D's counters: (MS-2d)
            20 slab cycles at 1024^2 (one within 1e-5 of the
            single-device cycle, the reduced norm against the host's
            f64 norm where f32's rounding bound is below a tenth of it —
            after cycle 1; after 10 and 20 it is printed, not held),
            (MG-2d) the grid-sharded refined solve (16 +-
            1), (MG-pen) the same on a 2 x 2 pencil (4 ranks), (MG-3d)
            128^3 (23), (MG-cg) / (MG-bicg) (f)'s operator with an f64
            outer (19 / 12), (DD-par) DD-256 under FGMRES(5) with the
            Schwarz sweep spread over the ranks (6 restarts); each at a
            true f64 relres below 1e-8, the 4-rank x within 1e-6 of the
            1-rank x, the overlapped slab apply, residual and Jacobi
            update bitwise the fused ones; every sharded level's apply,
            residual and slab sweep on the halo form, none on the cross
            form; per row ms a solve and a cycle (host clock), bytes a
            cycle by collective kind, kernel D's launches by form and, on
            1 NCCL rank, the device operations of a cycle
            (torch.profiler).

20. multi-device 2 — the systems and row-sharded flat tiers
            (parallel/systems_sharded.py, sharded_amg.py, sharded_solve.py)
            on the states phases 11-13 set up, kept in files the ranks load:
            kernel D's halo apply between staggered grids (in_grid !=
            out_grid: the axis-0 face component has one plane more than
            the cells) against its plain version (f32 2e-5, f64 1e-12) on
            every fine block of V-2d (f32 and the f64 residual operator)
            and V-3d as rank 1 of 4 builds them, its time on V-2d's
            largest fine block beside its bound, plain version and
            torch.sparse.mm; kernel D's block
            form on every level of SY-2d (f32 and the f64 residual
            operator) as every rank of 1 and of 4 builds it, bit for bit
            the per-block halo applies, adds and subtraction; then, spawned by
            parallel/launch.py, 1 NCCL rank and 4 gloo ranks sharing the
            card: (SY-2d) V-2d's hierarchy under
            ShardedSystemsSolver.solve_refined (9 +- 1), (SE-2d) E-2d's
            (28), (SY-3d) V-3d's on 4 ranks only (12), (MA-sa) SA-f's under
            ShardedAMGSolver.solve_refined (50), (MA-cl) C-pmis's with its
            host SuperLU coarsest (13), each at a true f64 relres below
            1e-8, and (MA-fg) SA-f's under solve_fgmres (f32, tol 1e-5,
            below 1e-4); one SY-2d and one MA-sa correction cycle within
            1e-5 of the single-device cycle, the pad of every row's cycle
            exactly zero, the 4-rank x within 1e-6 of the 1-rank x; per
            row ms a solve and a cycle, bytes a cycle by collective kind,
            kernel D's launches (the systems rows' levels on its block
            form, one launch an apply or residual, no halo apply).

21. multi-device 3 — the partitioned flat tier (parallel/part_amg.py)
            and the reduce hook, on the states phases 7 and 11-13 kept and
            PA-K's own host setup, 1 NCCL rank and 4 gloo ranks sharing
            the card: (PA-sa) SA-f's under
            PartitionedAMGSolver.solve_refined (50 +- 1; on 4 ranks the
            halo entries of A a level mgtpu's {1026, 814, 487, 224}),
            (PA-cl) C-pmis's, its SuperLU coarsest solved on rank 0 (13),
            (PA-K) SA-f's operator with Jac-GMRES K-cycles (62), (GK-2d)
            (g)'s configuration at 5 levels (its 6 cut to 5 for the
            script's time) on the sharded grid engine under
            solve_fgmres(restart=5) and solve_refined (the single-device
            counts at that depth, on the card), (SK-2d) V-2d's hierarchy
            with K-cycles under ShardedSystemsSolver.solve_refined (the
            single-device count), each at a true f64 relres below 1e-8;
            one correction cycle against one device's (PA-*: on the tier's
            own ELL levels, bitwise on 1 rank, 1e-5 on 4; a K-cycle where
            its rounding differs 5e-3), its pad exactly zero, the 4-rank
            x within 1e-6 of the 1-rank x; per row ms a solve and a cycle,
            bytes a cycle by collective kind (PA-sa beside MA-sa's
            replicated cycle), kernel D's halo-form launches (GK-2d, and
            its device operations a cycle on 1 NCCL rank) and block
            launches (SK-2d).

Every solve of phases 4, 5, 7, 8, 10, 11, 12, 13, 16, 17 and 18 runs
through the recorded programs (mgtpu_torch/cycle/capture.py: CUDA graphs),
the entry points' default, and is then held against its eager run (the
captured phase, 14):

14. captured — for each of the 55 paths (3D Jacobi, Chebyshev and SPAI
            refined; 2D Jacobi; the FMG start; (a)-(e) and (b6); (f),
            f-bicg, f-block, (g), (h); SA-s, SA-K, SA-f; C-cc, C-pmis,
            SA-dev, C-cg; V-2d, E-2d, V-3d, E-cg and the five Vanka
            variants; W (pcg), W-3d, R, D-coarse, DD-coarse, DD-256, K-mg,
            bf16, RD; H-2d, H-gmres, H-3d; the eleven rows of phase 18):
            the recorded solve takes the eager loop's
            iteration count (device_loop=False) and returns its x bit for
            bit (or within a stated 1e-12 relative); one recorded
            correction cycle (grid_cycle_jit / cycle_jit) launches what the
            eager cycle launches, with no plain call; the solve's and the
            cycle's times, recorded beside eager, by CUDA events and the
            host clock, the busy shares, the recording's time and its graph
            count (a host SuperLU coarsest splits it); the eager runs are
            left out of the path windows' counts.  Then one CG iteration of
            (f) recorded and eager, and the chunk sweep: time to 1e-8 of the
            3D Jacobi refined solve and of (f)'s CG at 1, 2, 4, 8 and 16
            iterations a program.  Kernel D's timings (9, 11, 12, 13) add
            its time per launch inside a CUDA graph of 40 launches.

The last lines are one JSON object with a row per kernel, the card's name and
power limit, and {"ok": true, "device": {...}}.  Without a CUDA device, or
without the mgtpu_torch package beside it, the script fails.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
FP64_FLOPS = 34e12               # H100 SXM float64 outside the tensor cores
SEED = 0


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

def shifted_laplacian(dims):
    """The bench operator: nodal Laplacian + 1e-4 (max column sum) I."""
    from mgtpu_torch import get_regular_mesh
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    M = get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(axis=0).max()
         * sp.identity(L.shape[0])).tocsr()
    return M, L


def galerkin_coeff(n: int):
    """Grid coefficients of the first full-weighting Galerkin coarsening of
    the shifted nodal Laplacian on an n^3 cube mesh, from its 1D factors:
    A = sum_a L1 (x) I (x) I + s I and P = P1 (x) P1 (x) P1 give
    R A P = 1/8 [Lc (x) Mc (x) Mc + ... + s Mc (x) Mc (x) Mc] with
    Lc = P1' L1 P1, Mc = P1' P1 — so the coarse operator at (n/2 + 1)^3 nodes
    is built without assembling the fine matrix."""
    from mgtpu_torch.models.operators import _ddx_cell
    from mgtpu_torch.setup.transfers import fw_interp_1d
    D = _ddx_cell(n, 1.0 / n)
    L1 = (D.T @ D).tocsr()
    s = 1e-4 * 3 * float(abs(L1).sum(axis=0).max())
    P1 = fw_interp_1d(n + 1)[0]
    Lc = np.asarray((P1.T @ L1 @ P1).todense())
    Mc = np.asarray((P1.T @ P1).todense())
    nc = Lc.shape[0]

    def band(T, o):
        v = np.zeros(nc)
        i = np.arange(max(0, -o), nc - max(0, o))
        v[i] = T[i, i + o]
        return v

    offsets = sorted(itertools.product((-1, 0, 1), repeat=3))
    coeff = np.empty((len(offsets), nc, nc, nc), dtype=np.float64)
    for k, (o0, o1, o2) in enumerate(offsets):
        l0, l1, l2 = band(Lc, o0), band(Lc, o1), band(Lc, o2)
        m0, m1, m2 = band(Mc, o0), band(Mc, o1), band(Mc, o2)
        coeff[k] = 0.125 * (
            l0[:, None, None] * m1[None, :, None] * m2[None, None, :]
            + m0[:, None, None] * l1[None, :, None] * m2[None, None, :]
            + m0[:, None, None] * m1[None, :, None] * l2[None, None, :]
            + s * m0[:, None, None] * m1[None, :, None] * m2[None, None, :])
    return coeff, tuple(offsets), (nc,) * 3


def aniso2d(n: int, eps: float):
    """(a), (b): eps*u_xx + u_yy on the (n+1)^2 node grid, 5-point
    (tests/test_line_smoother.py::_aniso)."""
    from mgtpu_torch import get_regular_mesh
    N = n + 1
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N)) * (n ** 2)
    I = sp.identity(N)
    A = eps * sp.kron(I, T) + sp.kron(T, I)
    return get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n]), sp.csr_matrix(A)


def mixed_strength(n: int):
    """(c): a(x)*u_xx + u_yy with a = 100 on the left half, 0.01 on the
    right, plus a 1e-6 shift (tests/test_line_smoother.py::_mixed_strength)."""
    from mgtpu_torch import get_regular_mesh
    N = n + 1
    a_edge = np.where(np.arange(N - 1) < (N - 1) // 2, 100.0, 0.01)
    D = sp.diags([-1.0, 1.0], [0, 1], shape=(N - 1, N))
    Tx = (D.T @ sp.diags(a_edge) @ D) * (n ** 2)
    Ty = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N)) * (n ** 2)
    A = sp.kron(sp.identity(N), Tx) + sp.kron(Ty, sp.identity(N))
    A = A + 1e-6 * abs(A).sum(0).max() * sp.identity(A.shape[0])
    return get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n]), sp.csr_matrix(A)


def aniso3d(dims, strong: int, eps: float = 50.0):
    """(d), (e): a 3D 7-point operator with eps on grid axis `strong`
    (tests/test_line_smoother.py::test_line_jacobi_3d); dims per mesh axis."""
    from mgtpu_torch import get_regular_mesh
    Ts = [sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(d + 1, d + 1))
          * (d ** 2) for d in reversed(dims)]          # grid axes (z, y, x)
    A = 0
    for k in range(3):
        mats = [sp.identity(d + 1) for d in reversed(dims)]
        mats[k] = Ts[k]
        w = eps if k == strong else 1.0
        A = A + w * sp.kron(sp.kron(mats[0], mats[1]), mats[2])
    return get_regular_mesh([0.0, 1.0] * 3, list(dims)), sp.csr_matrix(A)


def galerkin_stencil(n: int, device):
    from mgtpu_torch.ops.grid_stencil import (GridStencil,
                                              compress_grid_stencil)
    coeff, offsets, grid = galerkin_coeff(n)
    A = compress_grid_stencil(
        GridStencil(coeff.astype(np.float32), offsets, grid), device=device)
    require(A is not None, "Galerkin operator is not constant-interior")
    return A


def check_galerkin_builder() -> None:
    """The 1D-factor Galerkin builder agrees with the setup's structured RAP
    of the assembled operator (small cube, float64)."""
    from mgtpu_torch.ops.grid_stencil import (grid_stencil_from_csr,
                                              structured_fw_rap)
    n = 16
    _, L = shifted_laplacian((n, n, n))
    ref = structured_fw_rap(grid_stencil_from_csr(L, [n + 1] * 3))
    coeff, offsets, grid = galerkin_coeff(n)
    require(offsets == ref.offsets and grid == ref.grid,
            "Galerkin builder: offsets/grid differ from structured RAP")
    err = np.abs(coeff - ref.coeff).max() / np.abs(ref.coeff).max()
    require(err < 1e-12, f"Galerkin builder differs from RAP: {err:.2e}")
    log(f"galerkin builder vs structured RAP (16^3, f64): rel err {err:.2e}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Device time of one call by CUDA events: `reps` calls back to back,
    enqueued behind a GPU sleep so that host launch overhead leaves no idle
    gaps, rotating over several input sets so that at 129^3 each call finds
    its inputs evicted from the card's 50 MB L2 by the others.  Also returns
    the host time of one synchronised call (wrapper and launch overhead)."""

    def __init__(self, reps: int = 20):
        self.reps = reps

    def __call__(self, calls) -> tuple[float, float]:
        for c in calls:
            c()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls[0]()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        torch.cuda._sleep(int(3e9 * host * self.reps) + 2_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(self.reps):
            calls[i % len(calls)]()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / self.reps, host * 1e3


def graph_ms(calls, reps: int = 40) -> float:
    """Device time of one call inside a CUDA graph of `reps` back-to-back
    calls (rotating over the input sets), by CUDA events over five
    replays: a launch's cost once the host is out of the loop."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            calls[i % len(calls)]()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (5 * reps)


def loop_ms(call) -> float:
    """Host-clock ms of one synchronised call of a plain version that is a
    Python loop over a sweep's steps (kernels E and F): its thousands of
    small launches are host-bound, so one call by the host clock is its
    time (a second would take seconds more and tell nothing new)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card():
    require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    name = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {name} x{torch.cuda.device_count()}")
    return smi, name


BUILD_LOGS: dict = {}         # ptxas's output of each source (phase_build)
PROBE_NS: dict = {}           # ns a dependent shared-memory round (probe)


def phase_build():
    from mgtpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    logs = _build.build()
    BUILD_LOGS.update(logs)
    log(f"[build] nvcc {' '.join(_build.FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "entry")):
                log(f"[build] {name}: {line.strip()}")
    for name in _build.SOURCES:
        _build.library(name)


def ptxas(source: str, kernel: str) -> str:
    """Registers and spill bytes of each instantiation of `kernel` in
    `source`'s ptxas output, e.g. "IddLi5ELi1E 40 regs 0/0 B spill"."""
    out, entry = [], None
    for line in BUILD_LOGS.get(source, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = name if kernel in name else None
        elif entry and "spill stores" in line:
            st = line.split("bytes spill stores")[0].split(",")[-1].strip()
            ld = line.split("bytes spill loads")[0].split(",")[-1].strip()
            spill = f"{st}/{ld} B spill"
        elif entry and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            tag = entry.split(kernel, 1)[1].split("Ev", 1)[0]
            out.append(f"{tag} {regs} regs {spill}")
            entry = None
    return "; ".join(out) or "not built by this process"


def phase_probe(card):
    """The latency probe (csrc/probe.cu): ns a dependent shared-memory
    round under __syncwarp, __syncthreads (32 and 128 threads) and a
    cluster barrier of 2-16 blocks.  Kernels E and F step by __syncwarp,
    so their dependency-chain bounds are steps x the warp round; the
    others are what a step of a wider block or of a cluster would pay."""
    from mgtpu_torch.ops.cuda import probe
    PROBE_NS.update(warp=probe.round_ns("warp"),
                    block32=probe.round_ns("block", threads=32),
                    block128=probe.round_ns("block", threads=128))
    for c in (2, 4, 8, 16):
        PROBE_NS[f"cluster{c}"] = probe.round_ns("cluster", ctas=c)
    log("[probe] ns a dependent shared-memory round (slope of two launches "
        "by CUDA events): " + ", ".join(f"{k} {v:.1f}" for k, v in
                                        PROBE_NS.items()) + f" ({card})")


KERNELS = {
    # row name: (replaces, source, fields moved, kernel call)
    "stencil3d_apply.matvec": (
        "mgtpu/ops/pallas/const3d.py:526 _interior_kernel (K1) + "
        ":573 _xband_fix_kernel (K2)", "mgtpu_torch/csrc/const3d.cu", 2),
    "stencil3d_apply.residual": (
        "mgtpu/ops/pallas/fused3d.py:55 _fused_kernel as residual3d (K3) + "
        "const3d.py:573 (K2)", "mgtpu_torch/csrc/const3d.cu", 3),
    "stencil3d_apply.jacobi": (
        "mgtpu/ops/pallas/fused3d.py:55 _fused_kernel as jacobi3d (K4) + "
        "const3d.py:573 (K2)", "mgtpu_torch/csrc/const3d.cu", 4),
    "stencil3d_apply.jacobi_corr": (
        "mgtpu/ops/pallas/fused3d.py:55 _fused_kernel as jacobi_corr3d (K5) "
        "+ const3d.py:573 (K2)", "mgtpu_torch/csrc/const3d.cu", 5),
    "jacobi_residual3d": (
        "mgtpu/ops/pallas/fused3d.py:196 _jacres_kernel (K6) + "
        "const3d.py:573 (K2)", "mgtpu_torch/csrc/fused3d.cu", 5),
    # fields moved per right-hand side (r, out; + x), plus 3 coefficients
    "tridiag.solve": (
        "mgtpu/ops/pallas/tridiag.py:71 _fwd_kernel + :85 _bwd_kernel (K7) "
        "as line_solve_pallas", "mgtpu_torch/csrc/tridiag.cu", 2),
    "tridiag.correct": (
        "mgtpu/ops/pallas/tridiag.py:71 _fwd_kernel + :85 _bwd_kernel (K7) "
        "as line_correct_pallas", "mgtpu_torch/csrc/tridiag.cu", 3),
    # fields moved per right-hand side (x, y), plus nd coefficients
    "stencil.float32": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76", "mgtpu_torch/csrc/stencil.cu", 2),
    "stencil.float64": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76", "mgtpu_torch/csrc/stencil.cu", 2),
    # kernel D's cross apply: mgtpu computes these blocks in XLA
    # (ops/cross_stencil.py:123-138), K8's job between two grids
    "stencil_cross.float32": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76, as mgtpu/ops/cross_stencil.py:123 "
        "cross_stencil_matvec", "mgtpu_torch/csrc/stencil.cu", 2),
    "stencil_cross.float64": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76, as mgtpu/ops/cross_stencil.py:123 "
        "cross_stencil_matvec", "mgtpu_torch/csrc/stencil.cu", 2),
    # kernel E: no Pallas kernel; mgtpu's lax.fori_loop over the cells
    "vanka_lex": (
        "mgtpu/cycle/vanka.py:97 _lex_sweep (lax.fori_loop, no "
        "pallas_call)", "mgtpu_torch/csrc/vanka.cu", 2),
    # kernel F: no Pallas kernel; mgtpu's lax.fori_loop over the rows
    "kaczmarz": (
        "mgtpu/cycle/kaczmarz.py:70 kaczmarz_sweep (row_step :78-91, "
        "lax.fori_loop, no pallas_call)", "mgtpu_torch/csrc/kaczmarz.cu", 2),
    # the complex instantiations of kernels D and F (phase 17): mgtpu runs
    # its complex levels through grid_stencil_matvec in XLA
    "stencil.complex64": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76; complex in mgtpu/ops/grid_stencil.py "
        "grid_stencil_matvec (XLA)", "mgtpu_torch/csrc/stencil.cu", 2),
    "stencil.complex128": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76; complex in mgtpu/ops/grid_stencil.py "
        "grid_stencil_matvec (XLA)", "mgtpu_torch/csrc/stencil.cu", 2),
    "kaczmarz.complex128": (
        "mgtpu/cycle/kaczmarz.py:70 kaczmarz_sweep (row_step :78-91, "
        "lax.fori_loop, no pallas_call)", "mgtpu_torch/csrc/kaczmarz.cu", 2),
    # phase 18: kernel C, kernel D's cross form and kernel E in complex;
    # mgtpu runs complex lines through its XLA doubling scan (its Pallas
    # line kernel is float32 only) and the rest in XLA
    **{f"tridiag.{c}": (
        "mgtpu/ops/pallas/tridiag.py:71 _fwd_kernel + :85 _bwd_kernel (K7), "
        "pallas_calls at :120, :134 (float32 only); complex lines in "
        "mgtpu/cycle/relax.py:218 _scan_linear (XLA)",
        "mgtpu_torch/csrc/tridiag.cu", 3) for c in ("complex64",
                                                    "complex128")},
    **{f"stencil_cross.{c}": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76, as mgtpu/ops/cross_stencil.py:123 "
        "cross_stencil_matvec (XLA, complex)", "mgtpu_torch/csrc/stencil.cu",
        2) for c in ("complex64", "complex128")},
    **{f"vanka_lex.{c}": (
        "mgtpu/cycle/vanka.py:97 _lex_sweep (lax.fori_loop, no "
        "pallas_call)", "mgtpu_torch/csrc/vanka.cu", 2)
        for c in ("complex64", "complex128")},
    # phase 19: kernel D's halo apply, the slab rows from a halo-extended
    # slab or block (the multi-device tier)
    **{f"stencil_halo.{c}": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76, on mgtpu/parallel/stencil.py:97 "
        "stencil_matvec_local's halo-extended slab",
        "mgtpu_torch/csrc/stencil.cu", 2) for c in ("float32", "float64")},
    # phase 19: kernel D's halo form, a rank's block apply, residual or
    # slab Jacobi update in one launch, reading the neighbours' planes
    # where they arrived (the multi-device grid tier's main path)
    **{f"stencil_halo_form.{c}": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76, on mgtpu/parallel/stencil.py:97 "
        "stencil_matvec_local's halo-extended slab, with b - A x and the "
        "slab Jacobi update (mgtpu/parallel/sharded.py:109-123; "
        "mgtpu/parallel/grid_sharded.py:95's GSPMD-sharded levels)",
        "mgtpu_torch/csrc/halo_stencil.cu", 3) for c in ("float32", "float64")},
    # phase 20: the same halo apply between two staggered grids (the
    # systems tier's block operators; mgtpu lets GSPMD shard its XLA cross
    # apply, mgtpu/parallel/systems_sharded.py)
    **{f"stencil_halo_stag.{c}": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76, as mgtpu/ops/cross_stencil.py:123 "
        "cross_stencil_matvec on the blocks of "
        "mgtpu/parallel/systems_sharded.py", "mgtpu_torch/csrc/stencil.cu",
        2) for c in ("float32", "float64")},
    # kernel D's block form: a systems level's whole operator, or
    # its residual, in one launch; mgtpu sums its XLA cross applies
    # (phases 13, 18, 20, 21: every systems level on the main path)
    **{f"stencil_block.{c}": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76, as mgtpu/cycle/systems_grid.py:114 "
        "BlockGridOperator.matvec (XLA: mgtpu/ops/cross_stencil.py:123 "
        "cross_stencil_matvec a block, summed) and b - A x",
        "mgtpu_torch/csrc/block_stencil.cu", 3)
        for c in ("float32", "float64", "complex64", "complex128")},
}
STENCIL_KERNELS = [k for k in KERNELS       # kernels A and B
                   if not k.startswith(("tridiag", "stencil.",
                                        "stencil_cross.", "stencil_halo.",
                                        "stencil_halo_form.",
                                        "stencil_halo_stag.",
                                        "stencil_block.", "vanka",
                                        "kaczmarz"))]


def run_kernel(name, A, x, b, d, p, plain: bool):
    from mgtpu_torch.ops.cuda import const3d, fused3d
    if name == "jacobi_residual3d":
        fn = fused3d.jacobi_residual_plain if plain \
            else fused3d.jacobi_residual3d
        return fn(A, d, b, x)
    mode = name.split(".")[1]
    fn = const3d.apply_plain if plain else const3d.stencil3d_apply
    return fn(A, mode, x, b=b, d=d, p=p)


def fields(grid, m, seed):
    rng = np.random.RandomState(seed)
    x, b, p = (torch.tensor(rng.rand(m, *grid).astype(np.float32),
                            device="cuda") for _ in range(3))
    d = torch.tensor(rng.rand(*grid).astype(np.float32), device="cuda")
    return x, b, d, p


def phase_kernels(st, rows):
    """Kernel against plain version on every case; fills rows[name]."""
    from mgtpu_torch.ops.grid_stencil import (compress_grid_stencil,
                                              grid_stencil_from_csr,
                                              make_grid_stencil,
                                              structured_fw_rap)
    check_galerkin_builder()
    levels = [lv.A for lv in st.hier.levels[:-1]]
    _, Ln = shifted_laplacian((18, 24, 30))
    Ln = Ln.astype(np.float32)
    An7 = make_grid_stencil(Ln, [19, 25, 31], device="cuda")
    An27 = compress_grid_stencil(structured_fw_rap(
        grid_stencil_from_csr(shifted_laplacian((36, 48, 60))[1]
                              .astype(np.float32), [37, 49, 61])),
        device="cuda")
    t0 = time.perf_counter()
    A129_27 = galerkin_stencil(256, "cuda")
    log(f"[kernel] 129^3 Galerkin (nd=27) operator built in "
        f"{time.perf_counter() - t0:.1f} s")
    # kernel A's plan edges: X = 16 planes (one x-run) with y and z one node
    # past the narrow (16, 32) tile; the wide (4, 128) tile at its narrowest
    # interior, ragged in y, and with a Galerkin level
    edge = {}
    for dims in ((32, 16, 15), (99, 22, 15), (124, 24, 16)):   # mesh axes
        nodes = [d + 1 for d in dims]
        L = shifted_laplacian(dims)[1].astype(np.float32)
        edge[tuple(nodes)] = make_grid_stencil(L, nodes, device="cuda")
        if all(n % 2 for n in nodes):
            edge[tuple(nodes) + ("G",)] = compress_grid_stencil(
                structured_fw_rap(grid_stencil_from_csr(L, nodes)),
                device="cuda")
    cases = [("129^3 fine", levels[0], (1, 2, 3)),
             ("129^3 Galerkin", A129_27, (1, 2)),
             ("65^3 Galerkin", levels[1], (1, 2)),
             ("33^3", levels[2], (1,)), ("17^3", levels[3], (1,)),
             ("mesh (18,24,30)", An7, (1, 2, 3)),
             ("mesh (18,24,30) Galerkin", An27, (1, 2))] + [
        (f"edge {k[:3]}{' Galerkin' if len(k) > 3 else ''}", A, (1, 3))
        for k, A in edge.items()]
    from mgtpu_torch.ops.cuda import const3d, fused3d
    for label, A, ms in cases:
        for m in ms:
            x, b, d, p = fields(A.grid, m, SEED)
            for name in STENCIL_KERNELS:
                out = run_kernel(name, A, x, b, d, p, plain=False)
                ref = run_kernel(name, A, x, b, d, p, plain=True)
                outs = out if isinstance(out, tuple) else (out,)
                refs = ref if isinstance(ref, tuple) else (ref,)
                for j, (o, r) in enumerate(zip(outs, refs)):
                    require(o.shape == r.shape and bool(
                        torch.isfinite(o).all()), f"{name}: bad output")
                    ae = float((o - r).abs().max())
                    re = ae / float(r.abs().max())
                    tol = 1e-4 if j == 1 else 2e-5       # r' of the double
                    row = rows[name]
                    row["max_abs_err"] = max(row["max_abs_err"], ae)
                    row["max_rel_err"] = max(row["max_rel_err"], re)
                    require(re < tol, f"{name} {label} m={m}: relative "
                            f"error {re:.3e} >= {tol}")
            # kernel B is kernel A's jacobi followed by its residual, node
            # by node the same arithmetic: bit for bit, else within 2e-5
            # (x') / 1e-4 (r')
            x1, r1 = run_kernel("jacobi_residual3d", A, x, b, d, p,
                                plain=False)
            xa = run_kernel("stencil3d_apply.jacobi", A, x, b, d, p,
                            plain=False)
            ra = run_kernel("stencil3d_apply.residual", A, xa, b, d, p,
                            plain=False)
            same = bool(torch.equal(x1, xa) and torch.equal(r1, ra))
            row = rows["jacobi_residual3d"]
            row["bitwise_kernel_a"] = row.get("bitwise_kernel_a", True) and same
            for o, r, tol in ((x1, xa, 2e-5), (r1, ra, 1e-4)):
                re = float((o - r).abs().max() / r.abs().max())
                require(re < tol, f"kernel B {label} m={m}: {re:.3e} from "
                        f"kernel A's jacobi + residual (>= {tol})")
            plan = const3d.apply_plan(tuple(A.grid), A.boxes, "matvec")
            bplan = fused3d.jacres_plan(tuple(A.grid), A.boxes)
            log(f"[kernel] {label} grid {A.grid} nd={len(A.offsets)} m={m}: "
                f"all kernels match their plain versions (kernel A tile "
                f"{plan.ty}x{plan.tz}, x-run {plan.xrun}, {plan.ntiles} x "
                f"{plan.nruns} interior + {plan.nband} band blocks); kernel B "
                f"{'equals' if same else 'is within tolerance of'} kernel "
                f"A's jacobi + residual (plan: tile {bplan.ty}x{bplan.tz}, "
                f"x-run {bplan.xrun}, "
                f"{bplan.ntiles} x {bplan.nruns} interior + {bplan.nband} "
                f"band + {bplan.nshell} shell blocks)")
    return [(lbl, A) for lbl, A, _ in cases[:5]]


def conv3d_yardstick(A, x):
    """torch conv3d with the interior constants (no boundary band)."""
    w = torch.zeros((1, 1, 3, 3, 3), dtype=torch.float32, device="cuda")
    for k, (dx, dy, dz) in enumerate(A.offsets):
        w[0, 0, 1 + dx, 1 + dy, 1 + dz] = A.const[k]
    xc = x[:, None]
    return lambda: torch.nn.functional.conv3d(xc, w, padding=1)


def phase_timing(timed_levels, rows):
    """Kernel, plain and yardstick device times per level (m = 1)."""
    from mgtpu_torch.ops.cuda import const3d, fused3d
    timer = Timer()
    for label, A in timed_levels:
        sets = [fields(A.grid, 1, SEED + 1 + j) for j in range(4)]
        nodes = int(np.prod(A.grid))
        band_bytes = 4 * int(A.band.numel())
        conv_ms, _ = timer([conv3d_yardstick(A, x) for x, _, _, _ in sets])
        for name in STENCIL_KERNELS:
            nfields = KERNELS[name][2]
            ms, host_ms = timer([
                lambda f=f: run_kernel(name, A, *f, plain=False)
                for f in sets])
            plain_ms, plain_host_ms = timer([
                lambda f=f: run_kernel(name, A, *f, plain=True)
                for f in sets])
            fbytes = nfields * 4 * nodes
            flops = 2 * len(A.offsets) * nodes * (
                2 if name == "jacobi_residual3d" else 1)
            bound = max(fbytes / HBM_BYTES_PER_S,
                        flops / FP32_FLOPS) * 1e3
            rows[name].setdefault("times", {})[
                f"{label} nd={len(A.offsets)}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound,
                library_ms=conv_ms if name.endswith("matvec") else None)
            if name.startswith("stencil3d_apply."):
                plan = const3d.apply_plan(tuple(A.grid), A.boxes,
                                          name.split(".")[1])
            else:
                plan = fused3d.jacres_plan(tuple(A.grid), A.boxes)
            tile = f"  tile {plan.ty}x{plan.tz} x-run {plan.xrun}"
            log(f"[time] {label:14s} nd={len(A.offsets):2d} {name:28s} "
                f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {bound:.4f} ms ({fbytes / 1e6:.1f} MB fields, "
                f"+{band_bytes / 1e6:.2f} MB band)  conv3d {conv_ms:.4f} ms"
                f"  kernel/bound {ms / bound:.1f}x  host per call: kernel "
                f"{host_ms:.3f} ms, plain {plain_host_ms:.3f} ms{tile}")
            if label == "129^3 fine":
                rows[name].update(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if fbytes / HBM_BYTES_PER_S
                    >= flops / FP32_FLOPS else "operations",
                    band_bytes=band_bytes, conv3d_interior_ms=conv_ms,
                    host_ms=host_ms, plain_host_ms=plain_host_ms,
                    library_ms=conv_ms if name.endswith("matvec") else None)


def reset_counters():
    from mgtpu_torch.ops.cuda import (const3d, fused3d, kaczmarz, stencil,
                                      tridiag, vanka)
    from mgtpu_torch.setup import native
    for dct in (const3d.LAUNCHES, const3d.PLAIN_CALLS, fused3d.LAUNCHES,
                fused3d.PLAIN_CALLS, tridiag.LAUNCHES, tridiag.PLAIN_CALLS,
                stencil.LAUNCHES, stencil.PLAIN_CALLS,
                stencil.CROSS_LAUNCHES, stencil.HALO_LAUNCHES,
                stencil.BLOCK_LAUNCHES, vanka.LAUNCHES,
                vanka.PLAIN_CALLS, vanka.FORMS, kaczmarz.LAUNCHES,
                kaczmarz.PLAIN_CALLS, native.CALLS, native.PLAIN_CALLS):
        for k in dct:
            dct[k] = 0


def counters():
    from mgtpu_torch.ops.cuda import const3d, fused3d
    launches = {f"stencil3d_apply.{k}": v for k, v in const3d.LAUNCHES.items()}
    launches.update(fused3d.LAUNCHES)
    plain = dict(const3d.PLAIN_CALLS, **fused3d.PLAIN_CALLS)
    return launches, plain


def line_counters():
    """Launches and plain calls of the line kernel, per mode."""
    from mgtpu_torch.ops.cuda import tridiag
    return ({f"tridiag.{k}": v for k, v in tridiag.LAUNCHES.items()},
            {f"tridiag.{k}": v for k, v in tridiag.PLAIN_CALLS.items()})


def stencil_counters():
    """Launches and plain calls of kernel D, per float type."""
    from mgtpu_torch.ops.cuda import stencil
    return ({f"stencil.{k}": v for k, v in stencil.LAUNCHES.items()},
            {f"stencil.{k}": v for k, v in stencil.PLAIN_CALLS.items()})


def vanka_counters():
    """Launches and plain calls of kernel E, per float type."""
    from mgtpu_torch.ops.cuda import vanka
    return ({f"vanka.{k}": v for k, v in vanka.LAUNCHES.items()},
            {f"vanka.{k}": v for k, v in vanka.PLAIN_CALLS.items()})


def kaczmarz_counters():
    """Launches and plain calls of kernel F, per float type."""
    from mgtpu_torch.ops.cuda import kaczmarz
    return ({f"kaczmarz.{k}": v for k, v in kaczmarz.LAUNCHES.items()},
            {f"kaczmarz.{k}": v for k, v in kaczmarz.PLAIN_CALLS.items()})


def form_counters():
    """Launches of kernel E by form (x and b staged, x staged, x in global
    memory)."""
    from mgtpu_torch.ops.cuda import vanka
    return {f"E.{k}": v for k, v in vanka.FORMS.items()}


def true_relres(L, b, x) -> float:
    """||b - L x|| / ||b|| on the host, in float64 (complex128 for a
    complex x)."""
    xh = x.detach().cpu().numpy()
    xh = xh.astype(np.complex128 if np.iscomplexobj(xh) else np.float64)
    require(xh.shape == b.shape and np.isfinite(xh).all(),
            "solution has the wrong shape or non-finite values")
    return float(np.linalg.norm(b - L @ xh) / np.linalg.norm(b))


def compare_krylov(st, A, rh, label, solve, kw, x, info, first_ms, card):
    """A recorded Krylov solve just run (x, info, its first call's time)
    against its eager loop (device_loop=False: eager iterations, eager
    cycles): the same count, x bitwise; the warm recorded and the eager
    times per iteration and the preconditioner's cycle pair.  Adds a row
    to CAPTURED.  The loop's form (`loop_form`) is read from the set_cond
    launches of a recorded call; a recorded call after the profiled one
    (the while form's executable instantiated anew) gives x again."""
    iters = int(info["iters"])
    with uncounted():
        times = {}
        for mode in (True, False):
            torch.cuda.synchronize()
            n_cond = set_cond_launches()
            t0 = time.perf_counter()
            xm, im = solve(st, rh, device_loop=mode, **kw)
            torch.cuda.synchronize()
            times[mode] = (time.perf_counter() - t0) * 1e3
            if mode:
                form = loop_form(label, set_cond_launches() - n_cond, iters)
            require(int(im["iters"]) == iters, f"{label}: {im['iters']} "
                    f"iterations ({'recorded' if mode else 'eager'}), "
                    f"first recorded run {iters}")
            if mode:
                require(torch.equal(xm, x), f"{label}: two recorded runs "
                        "differ")
            else:
                x_rel = same_x(label, x, xm)
    xh = x.detach().cpu().numpy()
    rr = np.linalg.norm(rh - A @ xh, axis=0) / np.linalg.norm(rh, axis=0)
    row = dict(label=label, iters=iters, x_rel=x_rel,
               relres=float(np.max(rr)), first_ms=first_ms,
               solve_ms=times[True], eager_ms=times[False],
               iter_ms=times[True] / iters, eager_iter_ms=times[False] / iters,
               loop_form=form,
               **solve_profile(lambda: solve(st, rh, **kw), label, card),
               **cycle_pair(st, rh if rh.ndim == 1 else rh[:, 0], card))
    with uncounted():
        xa, _ = solve(st, rh, **kw)
        require(torch.equal(xa, x), f"{label}: the recorded run after the "
                "profiled one differs")
    CAPTURED.append(row)
    log_captured(row, card)
    log(f"[captured] {label}: {row['iter_ms']:.3f} ms an iteration "
        f"recorded, {row['eager_iter_ms']:.3f} eager (host clock over the "
        f"warm solve; {card})")
    return row


def refined(st, L, b, want, label, card, max_iter=40, fmg=False,
            compare=True, kw=None, pair=True):
    """Certified refined solve through the recorded device loop (the
    default): iteration count and host f64 residual; with `compare`, held
    against the eager loop (compare_refined; `pair`: with the cycle pair).
    `want` None: no contract count, the eager run's count alone.  `kw`:
    more keywords of solve_mg_refined (cycle_dtype)."""
    from mgtpu_torch import solve_mg_refined
    kw = kw or {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = solve_mg_refined(st, b, tol=1e-8, max_iter=max_iter, fmg=fmg,
                               **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rr = true_relres(L, b, x)
    log(f"[path] {label}: refined iters {info['iters']} (want {want} +- 1), "
        f"true {'c128' if np.iscomplexobj(b) else 'f64'} relres {rr:.3e}, "
        f"time to 1e-8 {wall:.1f} ms "
        f"(host clock, synchronised; {card})")
    require(want is None or abs(info["iters"] - want) <= 1,
            f"{label}: {info['iters']} refined iterations, want {want} +- 1")
    require(rr < 1e-8, f"{label}: true relres {rr:.3e} >= 1e-8")
    if compare:
        compare_refined(st, L, b, label, info, x, wall, card, max_iter, fmg,
                        kw, pair)
    return info["iters"], rr, wall


def one_cycle(st, b, captured: bool = True):
    """A call running one cycle of the state's hierarchy (either engine)
    from a zero guess on b, in the hierarchy's precision: the recorded
    cycle (grid_cycle_jit / cycle_jit), or the eager one."""
    from mgtpu_torch.config import torch_dtype
    from mgtpu_torch.solvers.mg_solver import _runtime
    to_field, _, cycle, _ = _runtime(st, captured)
    bg = to_field(torch.as_tensor(b, dtype=torch_dtype(st.config.dtype),
                                  device="cuda")[:, None])
    x0 = torch.zeros_like(bg)
    return lambda: cycle(bg, x0, True)


def cycle_times(run):
    """Median over ten calls of one cycle: CUDA events and the
    synchronised host clock (ms)."""
    for _ in range(3):
        run()
    ev, host = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ev.append(e0.elapsed_time(e1))
    return sorted(ev)[5], sorted(host)[5]


def vcycle_ms(st, b, card, label="129^3, 5 levels", captured=True):
    """One cycle from a zero guess on the fine grid: CUDA events and the
    synchronised host clock (the eager cycle is launch-bound at depth)."""
    ev_ms, host_ms = cycle_times(one_cycle(st, b, captured))
    log(f"[path] {st.config.cycle_type}-cycle ({st.config.relax_type}, "
        f"{label}, {'recorded' if captured else 'eager'}): {ev_ms:.3f} ms "
        f"CUDA events, {host_ms:.3f} ms host clock ({card})")
    return ev_ms, host_ms


def device_ms(run, reps: int = 5):
    """torch.profiler's kernel times of `reps` calls, per call: (total ms,
    [(kernel, ms)]), total 0 when the profiler saw no device events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    events = [(e.key, e.self_device_time_total / (reps * 1e3))
              for e in prof.key_averages() if e.self_device_time_total > 0]
    return sum(ms for _, ms in events), events


def vcycle_profile(st, b, cycle_ms, card, label="129^3", captured=True):
    """Device time of one cycle by torch.profiler (sum of kernel times
    over five cycles) against its CUDA-event time: the busy share."""
    busy, events = device_ms(one_cycle(st, b, captured))
    if busy == 0:
        log("[path] V-cycle device time: not measured (no device events)")
        return None
    d_ms = sum(ms for key, ms in events if "stencil_kernel" in key)
    log(f"[path] {st.config.cycle_type}-cycle ({label}) device time "
        f"{busy:.3f} ms of {cycle_ms:.3f} ms "
        f"(busy share {busy / cycle_ms:.2f}; kernel D {d_ms:.4f} ms; "
        f"{card}); largest:")
    for key, ms in sorted(events, key=lambda e: -e[1])[:6]:
        log(f"[path]   {ms:.4f} ms  {key[:70]}")
    return busy


# ---------------------------------------------------------------------------
# recorded programs against the eager runs (the captured phase)
# ---------------------------------------------------------------------------

CAPTURED = []           # one row per path: printed as JSON at the end
NO_PAIR = dict(cycle_launches=None, graphs=None, record_ms=None,
               cycle_ev_ms=None, cycle_host_ms=None, cycle_dev_ms=None,
               eager_cycle_ev_ms=None, eager_cycle_host_ms=None,
               eager_cycle_dev_ms=None, busy=None, eager_busy=None)
CAPTURED_PATHS = 55     # 3D Jacobi, Chebyshev, SPAI; 2D Jacobi; FMG;
                        # (a)-(e), (b6); (f), f-bicg, f-block, (g), (h);
                        # SA-s, SA-K, SA-f; C-cc, C-pmis, SA-dev, C-cg;
                        # V-2d, E-2d, V-3d, E-cg and the five Vanka
                        # variants; W (pcg), W-3d, R, D-coarse, DD-coarse,
                        # DD-256, K-mg, bf16, RD; H-2d, H-gmres, H-3d;
                        # CL-2d, CL-3d, CS-2d, CV-2d, CE-2d, C-lex,
                        # C-kacz, Z-dev, H-cd, CL-2d-c128, C-lex-c128


@contextlib.contextmanager
def uncounted():
    """Launches inside the block — the eager runs the recorded ones are
    held against, and timing — are taken back out of the kernels'
    counters, so a path window counts its recorded run alone."""
    from mgtpu_torch.cycle.capture import kernel_counters
    saved = [dict(d) for d in kernel_counters()]
    try:
        yield
    finally:
        for d, v in zip(kernel_counters(), saved):
            d.clear()
            d.update(v)


def launches_of(run):
    """Kernel launches and plain calls of one call of `run` (a dict by
    counter), outside any window."""
    from mgtpu_torch.ops.cuda import (const3d, fused3d, kaczmarz, stencil,
                                      tridiag, vanka)
    named = {"const3d": const3d.LAUNCHES, "fused3d": fused3d.LAUNCHES,
             "tridiag": tridiag.LAUNCHES, "stencil": stencil.LAUNCHES,
             "vanka": vanka.LAUNCHES, "kaczmarz": kaczmarz.LAUNCHES}
    plain = {"const3d": const3d.PLAIN_CALLS, "fused3d": fused3d.PLAIN_CALLS,
             "tridiag": tridiag.PLAIN_CALLS, "stencil": stencil.PLAIN_CALLS,
             "vanka": vanka.PLAIN_CALLS, "kaczmarz": kaczmarz.PLAIN_CALLS}
    with uncounted():
        b_l = {k: dict(d) for k, d in named.items()}
        b_p = {k: dict(d) for k, d in plain.items()}
        run()
        torch.cuda.synchronize()
        got = {f"{k}.{m}": v - b_l[k][m] for k, d in named.items()
               for m, v in d.items() if v != b_l[k][m]}
        nplain = sum(v - b_p[k][m] for k, d in plain.items()
                     for m, v in d.items())
    return got, nplain


def set_cond_launches() -> int:
    from mgtpu_torch.ops.cuda import device_loop
    return device_loop.LAUNCHES["set_cond"]


def loop_form(label, n_cond, iters) -> str:
    """The form a recorded loop took, from its set_cond launches: the
    while form counts one after the start and one an iteration (k + 1),
    the chunked form and FGMRES's restart programs none."""
    require(n_cond in (0, iters + 1), f"{label}: {n_cond} set_cond launches "
            f"for {iters} iterations")
    return "while" if n_cond else "programs"


def same_x(label, x_rec, x_eager):
    """x of the recorded run against the eager run's: bit for bit, or the
    stated 1e-12 relative bound (logged as such).  Returns the relative
    difference (0 when bitwise)."""
    if torch.equal(x_rec, x_eager):
        return 0.0
    rel = float((x_rec - x_eager).abs().max() / x_eager.abs().max())
    log(f"[captured] {label}: x NOT bitwise the eager run's, "
        f"{rel:.3e} relative")
    require(rel <= 1e-12, f"{label}: recorded x differs from eager by "
            f"{rel:.3e} relative (> 1e-12)")
    return rel


def cycle_pair(st, b, card):
    """One correction cycle of the state's hierarchy, recorded beside
    eager: launches per cycle (equal, no plain call), times by CUDA events
    and the host clock, busy share, the recording's time and its graph
    count."""
    from mgtpu_torch.cycle import capture
    with uncounted():
        capture.forget(st.hier)         # so that the cycle records anew
        table = capture.programs(st.hier).table
        rec = one_cycle(st, b, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec()                                   # warm-up + recording
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        segs = [c.segments for c in table.values()]
        require(len(segs) == 1, f"one cycle recorded {len(segs)} programs")
        eager = one_cycle(st, b, False)
        l_e, p_e = launches_of(eager)
        l_c, p_c = launches_of(rec)
        require(l_c == l_e and p_c == p_e == 0, f"launches per cycle: "
                f"recorded {l_c} ({p_c} plain), eager {l_e} ({p_e} plain)")
        ev_e, host_e = cycle_times(eager)
        ev_c, host_c = cycle_times(rec)
        dev_e, _ = device_ms(eager)
        dev_c, _ = device_ms(rec)
    return dict(cycle_launches=sum(l_c.values()), graphs=segs[0],
                record_ms=rec_s * 1e3,
                cycle_ev_ms=ev_c, cycle_host_ms=host_c, cycle_dev_ms=dev_c,
                eager_cycle_ev_ms=ev_e, eager_cycle_host_ms=host_e,
                eager_cycle_dev_ms=dev_e,
                busy=dev_c / ev_c if dev_c else None,
                eager_busy=dev_e / ev_e if dev_e else None)


def solve_profile(run, label, card):
    """The device time of one warm recorded solve (torch.profiler) against
    its host-clock time: the solve's busy share, and its three largest
    kernels."""
    with uncounted():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        dev, events = device_ms(run, reps=1)
    top = sorted(events, key=lambda e: -e[1])[:3]
    log(f"[captured] {label}: solve device time "
        + (f"{dev:.3f} ms of {wall:.3f} ms host clock (busy share "
           f"{dev / wall:.2f}); largest "
           + "; ".join(f"{ms:.3f} ms {k[:48]}" for k, ms in top)
           if dev else "not measured (no device events)") + f" ({card})")
    return dict(solve_dev_ms=dev or None,
                solve_busy=dev / wall if dev else None)


def log_captured(row, card):
    fmt = lambda v, f=".3f": "not measured" if v is None else format(v, f)
    log(f"[captured] {row['label']}: {row['iters']} iterations recorded = "
        f"eager, x {'bitwise' if row['x_rel'] == 0 else 'within 1e-12'}; "
        f"solve {fmt(row['solve_ms'], '.1f')} ms recorded (first call, "
        f"with recording {fmt(row['first_ms'], '.1f')}) vs "
        f"{fmt(row['eager_ms'], '.1f')} eager; cycle "
        f"{fmt(row['cycle_ev_ms'])} / {fmt(row['eager_cycle_ev_ms'])} ms by "
        f"events, {fmt(row['cycle_host_ms'])} / "
        f"{fmt(row['eager_cycle_host_ms'])} host, busy "
        f"{fmt(row['busy'], '.2f')} / {fmt(row['eager_busy'], '.2f')}, "
        f"{row['cycle_launches']} launches a cycle both ways, "
        f"{row['graphs']} graph(s), recorded in "
        f"{fmt(row['record_ms'], '.1f')} ms; loop "
        f"{row.get('loop_form', 'not read')} ({card})")


def compare_refined(st, L, b, label, info, x, first_ms, card, max_iter,
                    fmg=False, kw=None, pair=True):
    """The recorded refined solve just run (x, info, its first call's
    time) against the eager loop: the same count, x bitwise, a true f64
    relres below 1e-8; then the warm recorded and the eager times and (with
    `pair`) the cycle pair.  Adds a row to CAPTURED.  The loop's form and
    the recorded call after the profiled one as in `compare_krylov`."""
    from mgtpu_torch import solve_mg_refined
    kw = kw or {}
    with uncounted():
        times = {}
        for mode in (True, False):
            torch.cuda.synchronize()
            n_cond = set_cond_launches()
            t0 = time.perf_counter()
            xm, im = solve_mg_refined(st, b, tol=1e-8, max_iter=max_iter,
                                      fmg=fmg, device_loop=mode, **kw)
            torch.cuda.synchronize()
            times[mode] = (time.perf_counter() - t0) * 1e3
            if mode:
                form = loop_form(label, set_cond_launches() - n_cond,
                                 info["iters"])
            require(im["iters"] == info["iters"], f"{label}: "
                    f"{im['iters']} iterations ({'recorded' if mode else 'eager'}"
                    f"), first recorded run {info['iters']}")
            if mode:
                require(torch.equal(xm, x), f"{label}: two recorded runs "
                        "differ")
            else:
                x_rel = same_x(label, x, xm)
    row = dict(label=label, iters=info["iters"], x_rel=x_rel,
               relres=true_relres(L, b, x), first_ms=first_ms,
               solve_ms=times[True], eager_ms=times[False], loop_form=form,
               **solve_profile(lambda: solve_mg_refined(
                   st, b, tol=1e-8, max_iter=max_iter, fmg=fmg, **kw),
                   label, card),
               **(cycle_pair(st, b, card) if pair else NO_PAIR))
    with uncounted():
        xa, _ = solve_mg_refined(st, b, tol=1e-8, max_iter=max_iter, fmg=fmg,
                                 **kw)
        require(torch.equal(xa, x), f"{label}: the recorded run after the "
                "profiled one differs")
    CAPTURED.append(row)
    log_captured(row, card)
    return row


def per_cycle_launches(st, b):
    """Kernel launches of one V-cycle from a non-zero-guess entry."""
    from mgtpu_torch.cycle.grid_cycle import grid_cycle
    from mgtpu_torch.ops.grid_stencil import flat_to_grid
    bg = flat_to_grid(torch.as_tensor(b, dtype=torch.float32,
                                      device="cuda")[:, None],
                      st.hier.fine_grid)
    reset_counters()
    grid_cycle(st.config, st.hier, bg, torch.zeros_like(bg))
    launches, _ = counters()
    log(f"[path] launches in one Jacobi V(1,1) cycle (plus one "
        f"stencil3d_apply.matvec per solve_mg residual): {launches}")


def phase_path3d(M3, L3, st_jac, card):
    from mgtpu_torch import get_mg_param, mg_setup, solve_mg
    b = L3 @ np.random.RandomState(SEED).rand(L3.shape[0])
    b /= np.linalg.norm(b)
    bc = L3 @ np.random.RandomState(8).rand(L3.shape[0])
    bc /= np.linalg.norm(bc)
    cfg_c, rp_c = get_mg_param(levels=5, relax_type="chebyshev",
                               cheby_degree=3, nu_pre=1, nu_post=0,
                               dtype=np.float32)
    st_cheb = mg_setup(L3, M3, cfg_c, rp_c)
    cfg_s, rp_s = get_mg_param(levels=5, dtype=np.float32)  # SPAI V(2,2)
    st_spai = mg_setup(L3, M3, cfg_s, rp_s)

    reset_counters()                       # ---- main path window ----
    x, info = solve_mg(st_jac, b)
    rr = true_relres(L3, b, x)
    log(f"[path] 3D Jacobi V(1,1) solve_mg: {info['iters']} cycles, relres "
        f"{info['relres']:.3e} (true f64 {rr:.3e})")
    require(info["relres"] < 1e-6, "3D solve_mg did not reach 1e-6")
    refined(st_jac, L3, b, 23, "3D Jacobi 0.8 V(1,1)", card)
    refined(st_cheb, L3, bc, 11, "3D Chebyshev(3) V(1,0)", card)
    xs, info_s = solve_mg(st_spai, b)
    rr_s = true_relres(L3, b, xs)
    log(f"[path] 3D default config (SPAI 1.0 V(2,2)) solve_mg: "
        f"{info_s['iters']} cycles, relres {info_s['relres']:.3e} "
        f"(true f64 {rr_s:.3e})")
    require(info_s["relres"] < 1e-6, "3D SPAI solve_mg did not reach 1e-6")
    refined(st_spai, L3, b, None, "3D SPAI 1.0 V(2,2)", card)
    launches, plain = counters()           # ---- end of window ----
    log(f"[path] kernel launches: {launches}")
    log(f"[path] plain-version calls on the card: {plain}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path was never launched: {launches}")
    require(not any(plain.values()), f"plain versions ran: {plain}")

    # timings after the window (they do not count toward the launches)
    jac_ms, _ = vcycle_ms(st_jac, b, card)
    vcycle_profile(st_jac, b, jac_ms, card)
    vcycle_ms(st_cheb, bc, card)
    per_cycle_launches(st_jac, b)
    return launches


def phase_path2d(card):
    from mgtpu_torch import get_mg_param, mg_setup
    M, L = shifted_laplacian((1024, 1024))
    cfg, rp = get_mg_param(levels=6, max_outer_iter=20, relative_tol=1e-6,
                           relax_type="jacobi", relax_param=0.8, nu_pre=1,
                           nu_post=1, dtype=np.float32)
    t0 = time.perf_counter()
    st = mg_setup(L, M, cfg, rp)
    log(f"[path] 2D 1024^2 setup {time.perf_counter() - t0:.1f} s")
    b = L @ np.random.RandomState(SEED).rand(L.shape[0])
    b /= np.linalg.norm(b)
    before = counters()
    refined(st, L, b, 16, "2D 1024^2 Jacobi 0.8 V(1,1)", card)
    require(counters() == before, "2D levels launched a 3D kernel")
    return M, L, b, st


# ---------------------------------------------------------------------------
# the line kernel and the anisotropic paths
# ---------------------------------------------------------------------------

def line_states(M, A, dtype):
    """line_prec states (omega 0.8) on every grid axis, as tensors on the
    card; host pivots in f64 once per axis, cast as line_prec casts."""
    from mgtpu_torch.cycle.grid_cycle import line_state_to
    from mgtpu_torch.setup.smoothers import line_prec
    g = len(np.asarray(M.n).ravel())
    return [line_state_to(line_prec(A, M, 0.8, axis=a), dtype, "cuda")
            for a in range(g)]


def run_line(name, lr, r, x, plain: bool):
    from mgtpu_torch.ops.cuda import tridiag
    fn = tridiag.line_plain if plain else tridiag.line_apply
    mode = name.split(".")[1]
    args = (mode, lr.alpha, lr.pivot, lr.cprime, lr.axis, r)
    if mode == "solve":
        return fn(*args, omega=lr.omega)
    return fn(*args, x=x, omega=lr.omega)


def phase_line_kernels(ops, rows):
    """The line kernel against its plain version on every axis, m = 1, 2,
    float32 (2e-4 relative) and float64 (1e-10); returns the f32 states of
    the timed shapes."""
    timed = {}
    for label, (M, A) in ops.items():
        for dtype, tol in ((torch.float32, 2e-4), (torch.float64, 1e-10)):
            states = line_states(M, A, dtype)
            if dtype == torch.float32:
                timed[label] = states
            for lr in states:
                for m in (1, 2, 3):
                    rng = np.random.RandomState(SEED + m)
                    r, x = (torch.tensor(rng.rand(m, *lr.alpha.shape),
                                         dtype=dtype, device="cuda")
                            for _ in range(2))
                    for name in ("tridiag.solve", "tridiag.correct"):
                        o = run_line(name, lr, r, x, plain=False)
                        ref = run_line(name, lr, r, x, plain=True)
                        torch.cuda.synchronize()
                        require(o.shape == ref.shape and o.dtype == ref.dtype
                                and bool(torch.isfinite(o).all()),
                                f"{name}: bad output")
                        ae = float((o - ref).abs().max())
                        re = ae / float(ref.abs().max())
                        row = rows[name]
                        row["max_abs_err"] = max(row["max_abs_err"], ae)
                        row["max_rel_err"] = max(row["max_rel_err"], re)
                        require(re < tol, f"{name} {label} axis {lr.axis} "
                                f"m={m} {dtype}: relative error {re:.3e} "
                                f">= {tol}")
            log(f"[kernel] line kernel, {label} grid "
                f"{tuple(states[0].alpha.shape)} {dtype}: solve and correct "
                "match their plain versions on every axis, m = 1, 2, 3")
    return timed


def thomas_coeffs(grid, axis, dtype, seed=0):
    """Thomas coefficients of a random diagonally dominant tridiagonal
    operator along `axis` of `grid`, in line_prec's form (alpha zero at
    line starts, cprime zero at line ends), on the card."""
    rng = np.random.RandomState(seed)
    sub, sup = (-rng.uniform(0.5, 1.0, grid) for _ in range(2))
    diag = 2.5 + rng.rand(*grid)
    sub, sup, diag = (np.moveaxis(v, axis, 0) for v in (sub, sup, diag))
    sub[0] = 0.0
    sup[-1] = 0.0
    piv, cp = np.empty_like(diag), np.empty_like(diag)
    for i in range(diag.shape[0]):
        piv[i] = 1.0 / (diag[i] - sub[i] * (cp[i - 1] if i else 0.0))
        cp[i] = sup[i] * piv[i]
    return [torch.tensor(np.ascontiguousarray(np.moveaxis(v, 0, axis)),
                         dtype=dtype, device="cuda")
            for v in (-piv * sub, piv, cp)]


# kernel C's plan edges: 2- and 3-node lines, a strided inner extent that
# is not a multiple of the tile, the long lines of a (4097, 40) grid on both
# axes (streamed strided, staged contiguous) and of (40, 8193) (a staged
# contiguous line past 48 KB in f32, a streamed one in f64)
LINE_EDGES = [((2, 37), 0), ((3, 37), 0), ((37, 2), 1), ((37, 3), 1),
              ((4097, 40), 0), ((4097, 40), 1), ((40, 8193), 1)]


def phase_line_edges(rows):
    """The line kernel against its plain version at its plan's edges, both
    variants, float32 (2e-4) and float64 (1e-10), m = 1 and 3."""
    from mgtpu_torch.ops.cuda import tridiag
    seen = set()
    for grid, axis in LINE_EDGES:
        inner = int(np.prod(grid[axis + 1:]))
        len_outer = int(np.prod(grid[:axis]))
        for dtype, tol in ((torch.float32, 2e-4), (torch.float64, 1e-10)):
            alpha, piv, cp = thomas_coeffs(grid, axis, dtype)
            for m in (1, 3):
                rng = np.random.RandomState(SEED + m)
                r, x = (torch.tensor(rng.rand(m, *grid), dtype=dtype,
                                     device="cuda") for _ in range(2))
                for mode in tridiag.MODES:
                    kw = dict(omega=0.8, x=x if mode == "correct" else None)
                    plan = tridiag.line_plan(
                        r.numel() // (grid[axis] * inner), grid[axis], inner,
                        r.element_size(), mode)
                    seen.add((mode, plan.variant))
                    o = tridiag.line_apply(mode, alpha, piv, cp, axis, r, **kw)
                    ref = tridiag.line_plain(mode, alpha, piv, cp, axis, r,
                                             **kw)
                    torch.cuda.synchronize()
                    require(o.shape == ref.shape and bool(
                        torch.isfinite(o).all()), f"line {grid}: bad output")
                    ae = float((o - ref).abs().max())
                    re = ae / float(ref.abs().max())
                    row = rows[f"tridiag.{mode}"]
                    row["max_abs_err"] = max(row["max_abs_err"], ae)
                    row["max_rel_err"] = max(row["max_rel_err"], re)
                    require(re < tol, f"line {grid} axis {axis} m={m} {mode} "
                            f"{dtype} ({plan.variant}): relative error "
                            f"{re:.3e} >= {tol}")
            plans = {md: tridiag.line_plan(
                len_outer, grid[axis], inner, r.element_size(), md)[:2]
                for md in tridiag.MODES}
            log(f"[kernel] line kernel edge {grid} axis {axis} {dtype}: "
                f"matches its plain version, m = 1, 3 (m = 1 plans: "
                f"{plans})")
    want = {(m, v) for m in tridiag.MODES for v in ("staged", "streamed")}
    require(seen == want, f"line edges reached {sorted(seen)}, want both "
            "variants in both modes")


def phase_line_timing(timed, rows):
    """Device time of the line kernel (m = 1, f32, four input sets with
    their own copies of the coefficients, so that every call reads its
    inputs from device memory) beside its byte bound and plain time."""
    from mgtpu_torch.cycle.relax import LineRelax
    from mgtpu_torch.ops.cuda import tridiag
    timer = Timer()
    cases = [("1025^2", 0), ("1025^2", 1), ("129^3", 0), ("129^3", 2)]
    for label, axis in cases:
        lr = timed[label][axis]
        nodes = lr.alpha.numel()
        sets = [(LineRelax(lr.alpha.clone(), lr.pivot.clone(),
                           lr.cprime.clone(), lr.axis, lr.omega),
                 *(torch.tensor(np.random.RandomState(SEED + 10 + j).rand(
                     1, *lr.alpha.shape), dtype=torch.float32, device="cuda")
                   for _ in range(2))) for j in range(4)]
        for name in ("tridiag.solve", "tridiag.correct"):
            ms, host_ms = timer([lambda s=s: run_line(name, *s, False)
                                 for s in sets])
            plain_ms, _ = timer([lambda s=s: run_line(name, *s, True)
                                 for s in sets])
            fbytes = (KERNELS[name][2] + 3) * 4 * nodes
            flops = (7 if name.endswith("correct") else 6) * nodes
            bound = max(fbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
            grid = tuple(lr.alpha.shape)
            inner = int(np.prod(grid[axis + 1:]))
            plan = tridiag.line_plan(nodes // (grid[axis] * inner),
                                     grid[axis], inner, 4, name[8:])
            log(f"[time] line {label} axis {axis} "
                f"({'contiguous' if inner == 1 else 'strided'}) "
                f"{name:16s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {bound:.4f} ms ({fbytes / 1e6:.1f} MB)  "
                f"kernel/bound {ms / bound:.1f}x  host per call "
                f"{host_ms:.3f} ms  plan {tuple(plan)}")
            rows[name].setdefault("times", {})[f"{label} axis {axis}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound)
            if (label, axis) == ("1025^2", 1):     # configuration (a)'s lines
                rows[name].update(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if fbytes / HBM_BYTES_PER_S
                    >= flops / FP32_FLOPS else "operations",
                    library_ms=None, host_ms=host_ms,
                    timed_shape="1025^2 f32 m=1, lines on grid axis 1")


ANISO = [
    # key, label, operator, options, refined iterations
    ("a", "(a) 2D eps=100, line Jacobi 0.8 V(1,1), 6 levels",
     lambda: aniso2d(1024, 100.0),
     dict(levels=6, relax_type="line-jacobi", relax_param=0.8), 11),
    ("b", "(b) 2D eps=0.01, semicoarsening + line Jacobi 0.9, 7 levels",
     lambda: aniso2d(1024, 0.01),
     dict(levels=7, relax_type="line-jacobi", relax_param=0.9,
          transfer_type="semicoarsening"), 6),
    ("b6", "(b6) the same at 6 levels: a 33 x 257 coarsest, device-built "
     "inverse", lambda: aniso2d(1024, 0.01),
     dict(levels=6, relax_type="line-jacobi", relax_param=0.9,
          transfer_type="semicoarsening"), 6),
    ("c", "(c) 2D mixed strength, alternating lines 0.9, 6 levels",
     lambda: mixed_strength(1024),
     dict(levels=6, relax_type="line-jacobi",
          relax_param={"axis": "alt", "omega": 0.9}), 21),
    ("d", "(d) 3D eps=50 on grid axis 0, line Jacobi 0.8, 5 levels",
     lambda: aniso3d([128] * 3, 0),
     dict(levels=5, relax_type="line-jacobi", relax_param=0.8), 11),
    ("e", "(e) 3D eps=50 on grid axis 2, line Jacobi 0.8, 5 levels",
     lambda: aniso3d([128] * 3, 2),
     dict(levels=5, relax_type="line-jacobi", relax_param=0.8), 11),
]
SEMI_GRIDS = [(1025, 1025), (513, 1025), (257, 1025), (129, 1025),
              (65, 513), (33, 257), (17, 129)]


def phase_aniso(ops, card):
    """Configurations (a)-(e) through mg_setup + solve_mg_refined on the
    card; returns the launches of the window."""
    from mgtpu_torch import get_mg_param, mg_setup
    runs = []
    for key, label, make, opts, want in ANISO:
        M, A = ops[key] if key in ops else make()
        cfg, rp = get_mg_param(nu_pre=1, nu_post=1, dtype=np.float32, **opts)
        t0 = time.perf_counter()
        st = mg_setup(A, M, cfg, rp)
        grids = [tuple(lv.A.grid) for lv in st.hier.levels]
        log(f"[path] {label}: setup {time.perf_counter() - t0:.1f} s, "
            f"grids {grids}")
        if key in ("b", "b6"):
            want_grids = SEMI_GRIDS[:cfg.levels]
            require(grids == want_grids, f"({key}) level grids {grids}, "
                    f"want {want_grids}")
        if key == "b6":
            from mgtpu_torch.cycle.grid_cycle import DenseInverse
            require(isinstance(st.hier.coarse, DenseInverse),
                    "(b6): want the device-built dense inverse")
        b = A @ np.random.RandomState(SEED).rand(A.shape[0])
        runs.append((key, label, st, A, b / np.linalg.norm(b), want))

    reset_counters()                       # ---- main path window ----
    for key, label, st, A, b, want in runs:
        before = dict(line_counters()[0], **stencil_counters()[0])
        refined(st, A, b, want, label, card, max_iter=60)
        after = dict(line_counters()[0], **stencil_counters()[0])
        log(f"[path] {key}: line kernel and kernel D launches in this "
            f"solve: {({k: v - before[k] for k, v in after.items()})}")
    launches, plain = counters()           # ---- end of window ----
    for more in (line_counters(), stencil_counters()):
        launches.update(more[0])
        plain.update(more[1])
    log(f"[path] aniso kernel launches: {launches}")
    log(f"[path] aniso plain-version calls on the card: {plain}")
    # (c) is a variable-coefficient operator: kernel D in f32 and f64
    for k in ("tridiag.solve", "tridiag.correct", "stencil3d_apply.matvec",
              "stencil.float32", "stencil.float64"):
        require(launches[k] > 0, f"{k} was never launched on the aniso path")
    require(not any(plain.values()), f"plain versions ran: {plain}")

    for key, label, st, A, b, want in runs:
        if key in ("a", "d"):
            ev_ms, _ = vcycle_ms(st, b, card, label=label)
            vcycle_profile(st, b, ev_ms, card, label=f"({key})")
    return launches


def phase_fmg(card):
    """The 2D 1024^2 bench operator, Chebyshev(3) V(1,0), 6 levels, refined
    from a full-multigrid start (6 +- 1)."""
    from mgtpu_torch import get_mg_param, mg_setup
    M, L = shifted_laplacian((1024, 1024))
    cfg, rp = get_mg_param(levels=6, relax_type="chebyshev", cheby_degree=3,
                           nu_pre=1, nu_post=0, dtype=np.float32)
    st = mg_setup(L, M, cfg, rp)
    b = L @ np.random.RandomState(SEED).rand(L.shape[0])
    b /= np.linalg.norm(b)
    reset_counters()                       # ---- path window ----
    refined(st, L, b, 6, "2D 1024^2 Chebyshev(3) V(1,0), FMG start", card,
            fmg=True)
    launches, plain = counters()           # ---- end of window ----
    line_l, line_p = line_counters()
    d_l, d_p = stencil_counters()
    plain.update(line_p, **d_p)
    require(not any(plain.values()), f"plain versions ran: {plain}")
    require(not any(launches.values()) and not any(line_l.values())
            and not any(d_l.values()),
            "the constant-coefficient 2D FMG path launched a 3D, line or "
            "variable-coefficient kernel")


# ---------------------------------------------------------------------------
# kernel D and the variable-coefficient (Krylov) paths
# ---------------------------------------------------------------------------

def divsig(dims, shift=1e-8, seed=3):
    """Rough-sigma DivSigGrad, sigma = exp(RandomState(seed).randn(cells)),
    + shift * (max column sum) I (bench.py:540-544's operator)."""
    from mgtpu_torch import get_regular_mesh
    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    M = get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    sig = np.exp(np.random.RandomState(seed).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + shift * abs(A).sum(axis=0).max()
         * sp.identity(A.shape[0])).tocsr()
    return M, A


def stencil_cases(states):
    """(label, GridStencil) of every level of the (f) and (h) hierarchies,
    in f32 and as f64 casts, plus the f64 fine operators and the small
    non-square / non-cubic fine and Galerkin levels."""
    from mgtpu_torch.ops.grid_stencil import (GridStencil,
                                              grid_stencil_from_csr,
                                              structured_fw_rap)
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    cases = []
    for key, st in states.items():
        for l, lv in enumerate(st.hier.levels):
            A = lv.A
            require(isinstance(A, GridStencil),
                    f"({key}) level {l} is a {type(A).__name__}, want a "
                    "variable GridStencil")
            cases.append((f"({key}) level {l}", A))
            cases.append((f"({key}) level {l} f64", GridStencil(
                A.coeff.double(), A.offsets, A.grid)))
        cases.append((f"({key}) f64 fine operator",
                      high_precision_fine_operator(st)))
    for dims in ((24, 40), (18, 24, 30)):
        _, A = divsig(dims)
        gs = grid_stencil_from_csr(A, [d + 1 for d in dims])
        for dt in (np.float32, np.float64):
            g = GridStencil(gs.coeff.astype(dt), gs.offsets, gs.grid)
            cases.append((f"{g.grid} fine {np.dtype(dt).name}",
                          g.to("cuda")))
            r = structured_fw_rap(g)
            cases.append((f"{r.grid} Galerkin {np.dtype(dt).name}",
                          r.to("cuda")))
    return cases


D_TOLS = {torch.float32: 2e-5, torch.float64: 1e-12, torch.complex64: 2e-5,
          torch.complex128: 1e-12}


def check_d(rows, label, out, ref, row="stencil"):
    """Kernel D's output against its reference: same shape and type,
    finite, relative error below 2e-5 (f32) / 1e-12 (f64); the row of its
    type (`row`: "stencil", or "stencil_cross" for the cross apply) keeps
    the largest errors."""
    torch.cuda.synchronize()
    require(out.shape == ref.shape and out.dtype == ref.dtype
            and bool(torch.isfinite(out).all()), f"D {label}: bad output")
    ae = float((out - ref).abs().max())
    re = ae / float(ref.abs().max())
    row = rows[f"{row}.{str(ref.dtype).split('.')[-1]}"]
    row["max_abs_err"] = max(row["max_abs_err"], ae)
    row["max_rel_err"] = max(row["max_rel_err"], re)
    require(re < D_TOLS[ref.dtype], f"kernel D {label}: relative error "
            f"{re:.3e} >= {D_TOLS[ref.dtype]}")


def phase_stencil_kernels(states, rows):
    """Kernel D against its plain version on every case, m = 1, 2, 4;
    the slab entry on a 2D and a folded 3D operator."""
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import grid_stencil_matvec
    from mgtpu_torch.parallel.stencil import stencil_from_banded
    def check(label, m, out, ref):
        check_d(rows, f"{label} m={m}", out, ref)

    for label, A in stencil_cases(states):
        for m in (1, 2, 4):
            x = torch.tensor(np.random.RandomState(SEED + m).rand(
                m, *A.grid), dtype=A.coeff.dtype, device="cuda")
            check(label, m, stencil.grid_apply(A.coeff, A.offsets, x),
                  grid_stencil_matvec(A.coeff, A.offsets, x))
        log(f"[kernel] D {label}: grid {A.grid} nd={len(A.offsets)} "
            f"{A.coeff.dtype}: matches its plain version, m = 1, 2, 4")
    for dims in ((24, 40), (18, 24, 30)):
        _, A = divsig(dims)
        for dt in (np.float32, np.float64):
            sl = stencil_from_banded(A, [d + 1 for d in dims], 0.8, dtype=dt)
            coeff = torch.tensor(sl.coeff, device="cuda")
            for m in (1, 2, 4):
                x = torch.tensor(np.random.RandomState(m).rand(m, *sl.shape),
                                 dtype=coeff.dtype, device="cuda")
                check(f"slab {sl.shape}", m,
                      stencil.stencil_matvec(coeff, sl.di, sl.dj, x),
                      stencil.stencil_matvec_plain(coeff, sl.di, sl.dj, x))
        log(f"[kernel] D slab form of {dims} ({len(sl.di)} taps, NI = "
            f"{sl.shape[1]}): matches its plain version, f32 and f64")


def sparse_mm_yardstick(C, dtype):
    """The level's host CSR matrix as a torch CSR tensor on the card (the
    operand of the torch.sparse.mm yardstick)."""
    C = sp.csr_matrix(C)
    return torch.sparse_csr_tensor(
        torch.tensor(C.indptr, dtype=torch.int64),
        torch.tensor(C.indices, dtype=torch.int64),
        torch.tensor(C.data), size=C.shape, dtype=dtype, device="cuda")


def d_plan(box, nd, dtype, form="apply", m=1):
    """Kernel D's launch plan (ops/cuda/stencil.py::stencil_plan) as a dict
    with its schedule; None for a checkout whose kernel D has no plan."""
    from mgtpu_torch.ops.cuda import stencil
    planner = getattr(stencil, "stencil_plan", None)
    if planner is None:
        return None
    p = planner(tuple(int(v) for v in box), int(nd), m, dtype, form)
    return dict(p._asdict(), schedule=p.schedule)


def box3(grid):
    return (1,) * (3 - len(grid)) + tuple(int(v) for v in grid)


def d_case(kind, op, csr):
    """What timing one kernel-D case needs: (dtype, input shape, kernel
    call, plain call, plan, least bytes, flops, shape note).  kind: "grid"
    (a GridStencil), "cross" (a CrossGridStencil: nd coefficient planes
    and y on the output grid, x on the input grid), "halo" (the same, a
    block and its halo planes, through halo_apply), "dia" (a DIA matrix),
    "prolong" / "restrict" (a Stride2Transfer, whose least bytes are P's
    own: nnz + nc + nf values of csr, P or P^T)."""
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import grid_stencil_matvec
    dt = op.dtype
    item = torch.empty((), dtype=dt).element_size()
    fl = 8 if dt.is_complex else 2        # flops of a tap's multiply-add
    if kind == "cross":
        nd, no = len(op.offsets), int(np.prod(op.out_grid))
        ni = int(np.prod(op.in_grid))
        return (dt, (1,) + tuple(op.in_grid),
                lambda x: stencil.cross_apply(op.coeff, op.offsets,
                                              op.in_grid, x),
                lambda x: stencil.cross_apply_plain(op.coeff, op.offsets,
                                                    op.in_grid, x),
                d_plan(box3(op.out_grid), nd, dt, "apply" if op.in_grid
                       == op.out_grid else "cross"), (nd * no + ni + no) * item,
                fl * nd * no, f"{op.in_grid} -> {op.out_grid} nd={nd}")
    if kind == "halo":
        nd, no = len(op.offsets), int(np.prod(op.out_grid))
        ni = int(np.prod(op.in_grid))
        return (dt, (1,) + tuple(op.in_grid),
                lambda x: stencil.halo_apply(op.coeff, op.offsets,
                                             op.in_grid, x),
                lambda x: stencil.cross_apply_plain(op.coeff, op.offsets,
                                                    op.in_grid, x),
                d_plan(box3(op.out_grid), nd, dt, "cross"),
                (nd * no + ni + no) * item, fl * nd * no,
                f"{op.in_grid} -> {op.out_grid} nd={nd}")
    if kind == "grid":
        n, nd = int(np.prod(op.grid)), len(op.offsets)
        return (dt, (1,) + tuple(op.grid),
                lambda x: stencil.grid_apply(op.coeff, op.offsets, x),
                lambda x: grid_stencil_matvec(op.coeff, op.offsets, x),
                d_plan(box3(op.grid), nd, dt), (nd + 2) * n * item,
                fl * nd * n, f"grid {op.grid} nd={nd}")
    if kind == "dia":
        n, nd = op.shape[0], len(op.offsets)
        return (dt, (n, 1),
                lambda x: stencil.dia_apply(op.data, op.offsets, x),
                lambda x: stencil.dia_apply_plain(op.data, op.offsets, x),
                d_plan((1, 1, n), nd, dt), (nd + 2) * n * item, fl * nd * n,
                f"DIA n={n} nd={nd}")
    pbytes = (csr.nnz + csr.shape[0] + csr.shape[1]) * item
    packed = hasattr(op, "pcoeff")
    if kind == "prolong":
        return (dt, (1,) + tuple(op.coarse_grid), op.prolong,
                getattr(stencil, "stride2_prolong_plain", None)
                and (lambda x: stencil.stride2_prolong_plain(op, x)),
                d_plan(box3(op.fine_grid), op.pcoeff.shape[0], dt,
                       "prolong") if packed else None, pbytes,
                fl * csr.nnz,
                f"{op.coarse_grid} -> {op.fine_grid} "
                f"taps {len(op.offsets)}")
    return (dt, (1,) + tuple(op.fine_grid), op.restrict,
            getattr(stencil, "stride2_restrict_plain", None)
            and (lambda x: stencil.stride2_restrict_plain(op, x)),
            d_plan(box3(op.coarse_grid), len(op.offsets), dt, "restrict")
            if packed else None, pbytes, fl * csr.nnz,
            f"{op.fine_grid} -> {op.coarse_grid} taps {len(op.offsets)}")


def time_d(label, kind, op, csr, timer, card, plain=True, seed=30):
    """Kernel D's device time on one case (m = 1, four input sets), beside
    its least time, its plain version (if `plain`) and torch.sparse.mm of
    `csr`; returns the entry and the kernel's output on the first set."""
    dt, shape, run, plain_fn, plan, fbytes, flops, note = d_case(kind, op,
                                                                 csr)
    sets = [torch.tensor(np.random.RandomState(SEED + seed + j).rand(*shape),
                         dtype=dt, device="cuda") for j in range(4)]
    ms, host_ms = timer([lambda x=x: run(x) for x in sets])
    g_ms = graph_ms([lambda x=x: run(x) for x in sets])
    plain_ms = (timer([lambda x=x: plain_fn(x) for x in sets])[0]
                if plain and plain_fn else None)
    lib_ms = None
    if csr is not None:
        Tm = sparse_mm_yardstick(csr, dt)
        try:
            lib_ms = timer([lambda c=x.reshape(-1, 1): torch.sparse.mm(Tm, c)
                            for x in sets])[0]
        except RuntimeError as e:          # the yardstick, not the port
            log(f"[time] D {label}: torch.sparse.mm has no {dt} CSR product "
                f"on the card ({str(e).splitlines()[0][:90]}): library "
                "time none")
    peak = (FP32_FLOPS if dt in (torch.float32, torch.complex64)
            else FP64_FLOPS)
    bound = max(fbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
    fmt = lambda v: "none" if v is None else f"{v:.4f} ms"
    sched = "no plan" if plan is None else (
        f"plan {plan['schedule']} split {plan['split']} group "
        f"{plan['group']} blocks {plan['blocks']}")
    log(f"[time] D {label:18s} {note} {dt}: kernel {ms:.4f} ms  plain "
        f"{fmt(plain_ms)}  sparse.mm {fmt(lib_ms)}  bound {bound:.4f} ms "
        f"({fbytes / 1e6:.2f} MB)  kernel/bound {ms / bound:.1f}x  {sched}"
        f"  host per call {host_ms:.3f} ms  in a CUDA graph {g_ms:.4f} ms "
        f"({card})")
    entry = dict(shape=note, ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                 library_ms=lib_ms,
                 bound_ms=bound, host_ms=host_ms, plan=plan,
                 bound_by="bytes" if fbytes / HBM_BYTES_PER_S
                 >= flops / peak else "operations")
    return entry, run(sets[0])


def fh_cases(states):
    """(label, kind, op, csr) of every level of (f) and (h) and of (f)'s
    f64 fine operator."""
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    out = []
    for key, st in states.items():
        for l, lv in enumerate(st.hier.levels):
            out.append((f"({key}) level {l}", "grid", lv.A, st.As[l]))
        if key == "f":
            out.append(("(f) f64 fine", "grid",
                        high_precision_fine_operator(st), st.A_input))
    return out


def phase_stencil_timing(states, rows, card):
    """Kernel D, plain and torch.sparse.mm device times on every level of
    (f) and (h) (m = 1, four input sets so that the large levels come from
    device memory) and on the f64 fine operator of (f), with D's plan."""
    timer = Timer()
    for label, kind, op, csr in fh_cases(states):
        entry, _ = time_d(label, kind, op, csr, timer, card)
        name = f"stencil.{str(op.dtype).split('.')[-1]}"
        rows[name].setdefault("times", {})[label] = entry
        if label in ("(f) level 0", "(f) f64 fine"):
            rows[name].update(
                {k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "host_ms",
                                       "plan")},
                timed_shape=f"{label}: {entry['shape']} m=1",
                library_call="torch.sparse.mm(CSR, x)")


KRYLOV = [
    # key, label, state, solve, keywords, right-hand sides, mgtpu's count
    # on the CPU (f-block's from scripts/fblock_reference.py)
    ("f", "(f) 2D 1025^2 rough sigma, solve_cg_mg, Jacobi 0.8 V(1,1)",
     "f", "solve_cg_mg", {}, "b", 19),
    ("f-bicg", "(f-bicg) the same, solve_bicgstab_mg", "f",
     "solve_bicgstab_mg", {}, "b", 12),
    ("f-block", "(f-block) the same, 4 RHS, solve_cg_mg(block=True)", "f",
     "solve_cg_mg", dict(block=True), "B", 22),
    ("g", "(g) the same operator, Jac-GMRES 1.0 K-cycles, "
     "solve_gmres_mg(inner=5)", "g", "solve_gmres_mg", dict(inner=5), "b",
     4),
    ("h", "(h) 3D 129^3 rough sigma, solve_cg_mg, Jacobi 0.8 V(1,1)", "h",
     "solve_cg_mg", {}, "b", 16),
]


def krylov_states():
    """(f)/(g) on the 1024^2-cell operator (6 levels) and (h) on the
    128^3-cell one (5 levels), f32 hierarchies; right-hand sides as in the
    reference counts: b = A RandomState(4).rand(n) normalised, and
    RandomState(4).rand(n, 4) with normalised columns."""
    from mgtpu_torch import get_mg_param, mg_setup
    base = dict(max_outer_iter=100, relative_tol=1e-8, nu_pre=1, nu_post=1,
                dtype=np.float32)
    ops, states = {}, {}
    for key, dims, levels, opts in (
            ("f", (1024, 1024), 6, dict(relax_type="jacobi",
                                        relax_param=0.8)),
            ("g", None, 6, dict(relax_type="jac-gmres", relax_param=1.0,
                                cycle_type="K")),
            ("h", (128, 128, 128), 5, dict(relax_type="jacobi",
                                           relax_param=0.8))):
        t0 = time.perf_counter()
        # (g) runs on (f)'s operator
        M, A = ops[key] = ops["f"] if dims is None else divsig(dims)
        cfg, rp = get_mg_param(levels=levels, **base, **opts)
        states[key] = mg_setup(A, M, cfg, rp)
        log(f"[path] ({key}) operator + setup {time.perf_counter() - t0:.1f}"
            f" s, grids {[lv.A.grid for lv in states[key].hier.levels]}, "
            f"taps {[len(lv.A.offsets) for lv in states[key].hier.levels]}")
    rhs = {}
    for key in ("f", "h"):
        A = ops[key][1]
        b = A @ np.random.RandomState(4).rand(A.shape[0])
        B = np.random.RandomState(4).rand(A.shape[0], 4)
        rhs[key] = dict(b=b / np.linalg.norm(b),
                        B=B / np.linalg.norm(B, axis=0))
    rhs["g"] = rhs["f"]
    return ops, states, rhs


def phase_krylov(ops, states, rhs, card):
    """The Krylov solves inside one launch-counter window; returns kernel
    D's launches in the window."""
    import mgtpu_torch
    reset_counters()                       # ---- main path window ----
    for key, label, skey, fn, kw, which, want in KRYLOV:
        A, rh = ops[skey][1], rhs[skey][which]
        before = stencil_counters()[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = getattr(mgtpu_torch, fn)(states[skey], rh, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        xh = x.detach().cpu().numpy()
        require(xh.shape == rh.shape and xh.dtype == np.float64
                and np.isfinite(xh).all(), f"{key}: bad solution")
        rr = np.linalg.norm(rh - A @ xh, axis=0) / np.linalg.norm(rh, axis=0)
        iters = int(info["iters"])
        d_l = {k: v - before[k] for k, v in stencil_counters()[0].items()}
        log(f"[path] {label}: {iters} iterations (mgtpu {want}), true "
            f"f64 relres {np.array2string(np.atleast_1d(rr), precision=3)}, "
            f"time to 1e-8 {wall:.1f} ms (host clock, synchronised; {card})"
            f"; kernel D launches {d_l}")
        require(abs(iters - want) <= 1,
                f"{key}: {iters} iterations, want {want} +- 1")
        require(bool(np.all(rr < 1e-8)), f"{key}: true relres {rr} >= 1e-8")
        compare_krylov(states[skey], A, rh, label, getattr(mgtpu_torch, fn),
                       kw, x, info, wall, card)
    launches, plain = stencil_counters()   # ---- end of window ----
    more_l, more_p = counters()
    plain.update(more_p)
    log(f"[path] Krylov window kernel D launches: {launches}; other "
        f"kernels {more_l}")
    log(f"[path] Krylov window plain-version calls on the card: {plain}")
    for k in ("stencil.float32", "stencil.float64"):
        require(launches[k] > 0, f"{k} was never launched on the Krylov "
                "path")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    return launches


def cg_iteration(st, b, card):
    """One CG iteration of (f), recorded (chunks of CHUNK iterations) and
    eager, by CUDA events and the host clock, as the slope between a c-
    and a 4c-iteration solve (c = CHUNK, tol 0, so that no chunk runs
    masked iterations); and the device busy share of the 4c-iteration
    solve (torch.profiler) both ways."""
    from dataclasses import replace
    from mgtpu_torch import solve_cg_mg
    from mgtpu_torch.krylov import _loop
    cfg = st.config
    k1, k2 = _loop.CHUNK, 4 * _loop.CHUNK

    def run(k, mode):
        st.config = replace(cfg, max_outer_iter=k, relative_tol=0.0)
        try:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            _, info = solve_cg_mg(st, b, device_loop=mode)
            e1.record()
            torch.cuda.synchronize()
            require(int(info["iters"]) == k, "fixed-count CG stopped early")
            return e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3
        finally:
            st.config = cfg

    out = {}
    with uncounted():
        for mode in (True, False):
            run(k1, mode)
            run(k2, mode)
            ev, host = [], []
            for _ in range(3):
                e2, h2 = run(k2, mode)
                e1, h1 = run(k1, mode)
                ev.append((e2 - e1) / (k2 - k1))
                host.append((h2 - h1) / (k2 - k1))
            busy, events = device_ms(lambda: run(k2, mode), reps=1)
            total = run(k2, mode)[0]
            out[mode] = (sorted(ev)[1], sorted(host)[1],
                         busy / total if busy else None)
            share = (f"busy share {busy / total:.2f}" if busy
                     else "device time not measured (no device events)")
            log(f"[path] one CG iteration of (f) (V-cycle + f64 matvec + "
                f"dots), {'recorded' if mode else 'eager'}: "
                f"{out[mode][0]:.3f} ms CUDA events, {out[mode][1]:.3f} ms "
                f"host clock; {k2}-iteration solve: device time "
                f"{busy:.3f} ms of {total:.3f} ({share}; {card}); largest:")
            for key, ms in sorted(events, key=lambda e: -e[1])[:5]:
                log(f"[path]   {ms:.4f} ms  {key[:70]}")
    return out


# ---------------------------------------------------------------------------
# smoothed-aggregation AMG
# ---------------------------------------------------------------------------

AMG_CELLS = 512
AMG = [
    # key, label, sigma seed (b's is seed + 1), structured (mesh), options,
    # max_iter, mgtpu's refined count and operator complexity on the CPU
    # (scripts/amg_reference.py)
    ("SA-s", "(SA-s) 512^2 rough sigma, structured SA, SPAI V(2,2), "
     "4 levels", 3, True, dict(relax_type="spai"), 60, 38, 2.40),
    ("SA-K", "(SA-K) the same operator, structured SA, Jac-GMRES 1.0 "
     "K-cycles", 3, True, dict(relax_type="jac-gmres", relax_param=1.0,
                              nu_pre=1, nu_post=1, cycle_type="K"), 70, 48,
     2.40),
    ("SA-f", "(SA-f) 512^2 rough sigma (seed 5), greedy SA on the flat "
     "engine, SPAI V(2,2)", 5, False, dict(relax_type="spai"), 60, 50, 1.63),
]


def amg_states():
    """The SA-s, SA-K and SA-f hierarchies (f32, 4 levels) on the card, with
    their operators and right-hand sides; SA-s and SA-K share the
    operator.  Checks each hierarchy's engine, coarsest solver and
    operator complexity."""
    from mgtpu_torch import get_mg_param, sa_amg_setup
    from mgtpu_torch.cycle.grid_cycle import DenseInverse, GridHierarchy
    from mgtpu_torch.cycle.coarse import DenseLU
    ops, runs = {}, []
    for key, label, seed, structured, opts, max_iter, want, opc in AMG:
        if seed not in ops:
            M, A = divsig((AMG_CELLS, AMG_CELLS), seed=seed)
            b = A @ np.random.RandomState(seed + 1).rand(A.shape[0])
            ops[seed] = (M, A, b / np.linalg.norm(b))
        M, A, b = ops[seed]
        cfg, rp = get_mg_param(levels=4, dtype=np.float32, **opts)
        t0 = time.perf_counter()
        st = sa_amg_setup(A, cfg, rp, mesh=M if structured else None)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        h = st.hier
        kinds = [type(lv.A).__name__ for lv in h.levels]
        taps = [len(lv.A.offsets) if hasattr(lv.A, "offsets") else None
                for lv in h.levels]
        sizes = [a.shape[0] for a in st.As]
        log(f"[amg] {label}: setup {setup:.1f} s (host clock), "
            f"{type(h).__name__}, levels {sizes}, operators {kinds}, taps "
            f"{taps}, coarsest {type(h.coarse).__name__} of {sizes[-1]} "
            f"dofs, operator complexity {st.operator_complexity():.4f} "
            f"(want {opc:.2f})")
        require(abs(st.operator_complexity() - opc) <= 0.01,
                f"{key}: operator complexity {st.operator_complexity():.4f}")
        if structured:
            require(isinstance(h, GridHierarchy)
                    and isinstance(h.coarse, DenseInverse)
                    and sizes[-1] == 4225,
                    f"{key}: want a grid hierarchy with a 4225-dof "
                    "device-built inverse")
        else:
            require(not isinstance(h, GridHierarchy)
                    and kinds[0] == "DIA" and set(kinds[1:]) == {"ELL"}
                    and isinstance(h.coarse, DenseLU),
                    f"{key}: want DIA + ELL levels and a DenseLU coarsest")
        runs.append((key, label, st, A, b, max_iter, want))
    return runs


def sa3d_levels():
    """The 3D smoothed-aggregation stencils: structured SA of the rough-sigma
    DivSigGrad at 32^3 cells, 4 levels, f32 (grids 33^3, 17^3, 9^3)."""
    from mgtpu_torch import get_mg_param, sa_amg_setup
    M, A = divsig((32, 32, 32))
    cfg, rp = get_mg_param(levels=4, relax_type="spai", dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp, mesh=M)
    levels = [lv.A for lv in st.hier.levels if lv.A is not None]
    log(f"[amg] 3D SA 32^3: grids {[A.grid for A in levels]}, taps "
        f"{[len(A.offsets) for A in levels]}")
    return st, levels


def phase_amg_kernels(runs, st3, levels3, rows):
    """Kernel D against its plain version at the SA shapes: every level of
    SA-s (5 / 13 / 37 / 97 taps) and of the 3D hierarchy (7 / 33 / 179),
    the DIA form of SA-f's fine level (5 taps, offsets +-1, +-513), and
    both applies of every Stride2Transfer of SA-s against P @ x and
    P^T @ r of the CSR matrices; m = 1 and 3, f32 (2e-5) and f64 (1e-12).
    A 257-tap stencil must raise."""
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import (grid_stencil_matvec,
                                              stride2_transfer_from_scipy)
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    def check(label, out, ref):
        check_d(rows, label, out, ref)

    st_s = runs[0][2]
    grids = [("SA-s", l, lv.A) for l, lv in enumerate(st_s.hier.levels)
             if lv.A is not None] + [
        ("3D SA", l, A) for l, A in enumerate(levels3)]
    for name, l, A in grids:
        for dt in (torch.float32, torch.float64):
            coeff = A.coeff.to(dt)
            for m in (1, 3):
                x = torch.tensor(np.random.RandomState(SEED + m).rand(
                    m, *A.grid), dtype=dt, device="cuda")
                check(f"{name} level {l} m={m}",
                      stencil.grid_apply(coeff, A.offsets, x),
                      grid_stencil_matvec(coeff, A.offsets, x))
        log(f"[kernel] D {name} level {l}: grid {A.grid} nd="
            f"{len(A.offsets)}: matches its plain version, f32 and f64, "
            "m = 1, 3")
    st_f = runs[2][2]
    for D in (st_f.hier.levels[0].A, high_precision_fine_operator(st_f)):
        for m in (1, 3):
            x = torch.tensor(np.random.RandomState(SEED + m).rand(
                D.shape[0], m), dtype=D.dtype, device="cuda")
            check(f"SA-f DIA m={m}", stencil.dia_apply(D.data, D.offsets, x),
                  stencil.dia_apply_plain(D.data, D.offsets, x))
        log(f"[kernel] D DIA form of SA-f level 0 ({D.dtype}, offsets "
            f"{D.offsets}): matches its plain version, m = 1, 3")
    for l, lv in enumerate(st_s.hier.levels[:-1]):
        P = st_s.Ps[l].astype(np.float64)
        P_dev = sparse_mm_yardstick(P, torch.float64)
        PT_dev = sparse_mm_yardstick(P.T, torch.float64)
        for dt, T in ((torch.float32, lv.P1), (torch.float64,
                      stride2_transfer_from_scipy(
                          P, list(reversed(lv.P1.fine_grid)),
                          list(reversed(lv.P1.coarse_grid)),
                          dtype=np.float64, max_delta=7, device="cuda"))):
            for m in (1, 3):
                rng = np.random.RandomState(SEED + m)
                xc = torch.tensor(rng.rand(m, *T.coarse_grid), dtype=dt,
                                  device="cuda")
                r = torch.tensor(rng.rand(m, *T.fine_grid), dtype=dt,
                                 device="cuda")
                y_ref = torch.sparse.mm(P_dev, xc.double().reshape(m, -1).T)
                rc_ref = torch.sparse.mm(PT_dev, r.double().reshape(m, -1).T)
                check(f"SA-s prolong {l} m={m}",
                      T.prolong(xc).reshape(m, -1).T, y_ref.to(dt))
                check(f"SA-s restrict {l} m={m}",
                      T.restrict(r).reshape(m, -1).T, rc_ref.to(dt))
        log(f"[kernel] D as SA-s Stride2Transfer {l} ({len(lv.P1.offsets)} "
            f"taps on {lv.P1.fine_grid}): prolong and restrict match P @ x "
            "and P^T @ r, f32 and f64, m = 1, 3")
    coeff = torch.ones((257, 9, 9), device="cuda")
    offs = tuple((i // 17 - 8, i % 17 - 8) for i in range(257))
    try:
        stencil.grid_apply(coeff, offs, torch.ones((1, 9, 9), device="cuda"))
    except ValueError as e:
        log(f"[kernel] D refuses a 257-tap stencil: {e}")
    else:
        raise RuntimeError("kernel D took a 257-tap stencil")


def amg_cases(runs, st3):
    """(label, kind, op, csr) at the SA shapes: every SA-s level, both
    applies of each SA-s transfer (csr P for the prolong, P^T for the
    restrict), the 3D SA levels and SA-f's DIA level in f32 and f64."""
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    st_s, st_f = runs[0][2], runs[2][2]
    out = []
    for l, lv in enumerate(st_s.hier.levels):
        if lv.A is not None:
            out.append((f"SA-s level {l}", "grid", lv.A, st_s.As[l]))
    for l, lv in enumerate(st_s.hier.levels[:-1]):
        P = st_s.Ps[l].tocsr()
        out.append((f"SA-s prolong {l}", "prolong", lv.P1, P))
        out.append((f"SA-s restrict {l}", "restrict", lv.P1, P.T.tocsr()))
    for l, lv in enumerate(st3.hier.levels):
        if lv.A is not None:
            out.append((f"3D SA level {l}", "grid", lv.A, st3.As[l]))
    for D in (st_f.hier.levels[0].A, high_precision_fine_operator(st_f)):
        out.append((f"SA-f DIA {str(D.dtype).split('.')[-1]}", "dia", D,
                    st_f.A_input if D.dtype == torch.float64
                    else st_f.As[0]))
    return out


def phase_amg_timing(runs, st3, rows, card):
    """Kernel D, plain and torch.sparse.mm device times (m = 1, four input
    sets) with D's plan at the SA shapes: SA-s's levels, prolongs and
    restricts (whose bound is P's own bytes), the 3D SA levels, SA-f's DIA
    level in f32 and f64."""
    timer = Timer()
    for label, kind, op, csr in amg_cases(runs, st3):
        entry, _ = time_d(label, kind, op, csr, timer, card)
        name = f"stencil.{str(op.dtype).split('.')[-1]}"
        rows[name].setdefault("times_amg", {})[label] = entry


def wide_stencil(ntaps, dim, grid, dtype, seed=0):
    """Random coefficients (on the card) of a stencil whose taps are the
    `ntaps` offsets nearest the centre of a radius-8 box (ties in order)."""
    r = range(-8, 9)
    offs = sorted(itertools.product(*[r] * dim),
                  key=lambda o: (sum(d * d for d in o), o))[:ntaps]
    coeff = np.random.RandomState(seed).rand(ntaps, *grid)
    return torch.tensor(coeff, dtype=dtype, device="cuda"), tuple(offs)


def random_stride2(fine, seed):
    """A random stride-2 prolongation on a fine node grid (slowest axis
    first) onto ceil(fine / 2): entries at f = 2c + d for a random half of
    the offsets d in [-3, 3]^dim."""
    rng = np.random.RandomState(seed)
    coarse = tuple((f + 1) // 2 for f in fine)
    offs = np.array([d for d in itertools.product(range(-3, 4),
                                                  repeat=len(fine))
                     if rng.rand() < 0.5])
    cs = np.stack(np.meshgrid(*map(np.arange, coarse), indexing="ij"),
                  -1).reshape(-1, len(fine))
    f = 2 * cs[:, None, :] + offs[None]
    ok = np.all((f >= 0) & (f < np.array(fine)), axis=-1)
    rows = np.ravel_multi_index(tuple(f[ok].T), fine)
    cols = np.broadcast_to(np.arange(len(cs))[:, None], ok.shape)[ok]
    P = sp.csr_matrix((rng.rand(len(rows)) + 0.5, (rows, cols)),
                      shape=(int(np.prod(fine)), len(cs)))
    return P, coarse


def phase_d_edges(rows):
    """Kernel D against its plain version at its plan's edges, f32 (2e-5)
    and f64 (1e-12): nd = 1, 9 (one past a group of 8) and 256 on 2D and
    3D grids at m = 1, 3, 8, 9, at the default plan and at splits 1, 2 and
    16; 97 taps on 1D fields of FILL - 1 nodes (split) and FILL (stream);
    the parity-form transfers on odd and even fine extents in 2D and 3D
    against P @ x and P^T @ r, m = 1 and 3, at the default plan and at
    splits 2 and 16."""
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import (grid_stencil_matvec,
                                              stride2_transfer_from_scipy)
    for dt in (torch.float32, torch.float64):
        for ntaps, dim in ((1, 2), (9, 2), (256, 3)):
            grid = (37, 41) if dim == 2 else (13, 15, 17)
            coeff, offsets = wide_stencil(ntaps, dim, grid, dt)
            taps = tuple((0,) * (3 - dim) + o for o in offsets)
            for m in (1, 3, 8, 9):
                x = torch.tensor(np.random.RandomState(m).rand(m, *grid),
                                 dtype=dt, device="cuda")
                ref = grid_stencil_matvec(coeff, offsets, x)
                check_d(rows, f"{ntaps} taps on {grid} m={m}",
                        stencil.grid_apply(coeff, offsets, x), ref)
                for split in (1, 2, 16):
                    plan = stencil.stencil_plan(box3(grid), ntaps, m, dt,
                                                split=split)
                    check_d(rows, f"{ntaps} taps on {grid} m={m} split "
                            f"{split}", stencil._launch(
                                coeff, box3(grid), taps, x, plan=plan), ref)
        for n in (stencil.FILL - 1, stencil.FILL):
            coeff = torch.tensor(np.random.RandomState(n).rand(97, n),
                                 dtype=dt, device="cuda")
            offsets = tuple((k - 48,) for k in range(97))
            x = torch.tensor(np.random.RandomState(1).rand(1, n), dtype=dt,
                             device="cuda")
            plan = stencil.stencil_plan((1, 1, n), 97, 1, dt)
            require(plan.schedule == ("split" if n < stencil.FILL
                                      else "stream"),
                    f"kernel D plan on {n} nodes: {plan}")
            check_d(rows, f"97 taps on {n} nodes ({plan.schedule})",
                    stencil.grid_apply(coeff, offsets, x),
                    grid_stencil_matvec(coeff, offsets, x))
        for fine in ((37, 40), (40, 37), (17, 18, 19), (20, 15, 16)):
            P, coarse = random_stride2(fine, seed=sum(fine))
            T = stride2_transfer_from_scipy(
                P, list(reversed(fine)), list(reversed(coarse)),
                dtype=np.float32 if dt == torch.float32 else np.float64,
                device="cuda")
            fb, cb = box3(fine), box3(coarse)
            taps = tuple((0,) * (3 - len(fine)) + o for o in T.offsets)
            for m in (1, 3):
                rng = np.random.RandomState(m)
                xc, r = rng.rand(m, P.shape[1]), rng.rand(m, P.shape[0])
                xd = torch.tensor(xc.reshape((m,) + coarse), dtype=dt,
                                  device="cuda")
                rd = torch.tensor(r.reshape((m,) + fine), dtype=dt,
                                  device="cuda")
                y_ref = torch.tensor((P @ xc.T).T.reshape((m,) + fine),
                                     dtype=dt, device="cuda")
                rc_ref = torch.tensor((P.T @ r.T).T.reshape((m,) + coarse),
                                      dtype=dt, device="cuda")
                outs = [("prolong", T.prolong(xd), y_ref),
                        ("restrict", T.restrict(rd), rc_ref)]
                for split in (2, 16):
                    outs.append((f"prolong split {split}", stencil._launch(
                        T.pcoeff, fb, taps, xd, form="prolong", in_box=cb,
                        in_space=coarse, ptab=T.ptab,
                        plan=stencil.stencil_plan(
                            fb, T.pcoeff.shape[0], m, dt, "prolong",
                            split=split)), y_ref))
                    outs.append((f"restrict split {split}", stencil._launch(
                        T.rcoeff, cb, taps, rd, form="restrict", in_box=fb,
                        in_space=fine, plan=stencil.stencil_plan(
                            cb, len(taps), m, dt, "restrict",
                            split=split)), rc_ref))
                for what, out, ref in outs:
                    check_d(rows, f"random stride-2 {fine} {what} m={m}",
                            out, ref)
    log("[kernel] D at its plan's edges (1 / 9 / 256 taps, m = 1, 3, 8, 9, "
        "splits 1, 2, 16; 97 taps on FILL - 1 and FILL nodes; parity-form "
        "transfers on (37, 40), (40, 37), (17, 18, 19), (20, 15, 16) "
        "against P @ x and P^T @ r): matches, f32 and f64")


def phase_amg(runs, card):
    """SA-s, SA-K and SA-f through solve_mg_refined to a true f64 relres
    below 1e-8 inside one launch-counter window: kernel D in f32 and f64 in
    each solve, no plain version anywhere.  Returns D's launches."""
    reset_counters()                       # ---- main path window ----
    for key, label, st, A, b, max_iter, want in runs:
        before = stencil_counters()[0]
        refined(st, A, b, want, label, card, max_iter=max_iter)
        d_l = {k: v - before[k] for k, v in stencil_counters()[0].items()}
        log(f"[path] {key}: kernel D launches in this solve: {d_l}")
        for k in ("stencil.float32", "stencil.float64"):
            require(d_l[k] > 0, f"{key}: {k} was never launched")
    launches, plain = stencil_counters()   # ---- end of window ----
    more_l, more_p = counters()
    line_l, line_p = line_counters()
    plain.update(more_p, **line_p)
    log(f"[path] AMG window kernel D launches: {launches}; other kernels "
        f"{dict(more_l, **line_l)}")
    log(f"[path] AMG window plain-version calls on the card: {plain}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    for key, label, st, A, b, max_iter, want in runs:
        ev_ms, _ = vcycle_ms(st, b, card, label=key)
        vcycle_profile(st, b, ev_ms, card, label=key)
    return launches


# ---------------------------------------------------------------------------
# classical AMG and the device-side AMG setup
# ---------------------------------------------------------------------------

CLASSICAL = [
    # key, label, setup, options, mgtpu's refined count, operator
    # complexity, level sizes, level formats and coarsest solver on the
    # CPU (scripts/classical_reference.py)
    ("C-cc", "(C-cc) classical AMG, common-C coloring (C++ kernels), "
     "direct interpolation", "classical", {}, 13, 2.7356,
     [263169, 131587, 50778, 23908], ["DIA", "DIA", "ELL", "ELL"],
     "SparseLUCoarse"),
    ("C-pmis", "(C-pmis) classical AMG, PMIS on the card + enforce_common_c",
     "classical", dict(coarsening="pmis"), 13, 3.1210,
     [263169, 153476, 70003, 31487], ["DIA", "ELL", "ELL", "ELL"],
     "SparseLUCoarse"),
    ("SA-dev", "(SA-dev) SA, MIS-2 aggregation on the card (MGTPU_AGG="
     "device)", "sa", {}, 20, 2.2391, [263169, 69425, 13952, 2153],
     ["DIA", "ELL", "ELL", "ELL"], "DenseLU"),
]
C_CG = 8        # (C-cg) C-cc's hierarchy under solve_cg_mg, mgtpu's count


def setup_counters():
    """Calls of the host C++ setup kernels and of their numpy versions."""
    from mgtpu_torch.setup import native
    return dict(native.CALLS), dict(native.PLAIN_CALLS)


def classical_setup(key, setup, opts, A):
    """One CLASSICAL setup on the card (f32, 4 levels, SPAI V(2,2)): the
    state, its host seconds and its device seconds (torch.profiler's
    device time over the setup)."""
    import os
    from torch.profiler import ProfilerActivity, profile
    from mgtpu_torch import classical_amg_setup, get_mg_param, sa_amg_setup
    cfg, rp = get_mg_param(levels=4, relax_type="spai", dtype=np.float32)
    if setup == "sa":
        os.environ["MGTPU_AGG"] = "device"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            st = (sa_amg_setup(A, cfg, rp) if setup == "sa"
                  else classical_amg_setup(A, cfg, rp, **opts))
            torch.cuda.synchronize()
        host = time.perf_counter() - t0
    finally:
        os.environ.pop("MGTPU_AGG", None)
    dev = sum(e.self_device_time_total
              for e in prof.key_averages()) / 1e6
    return st, host, dev


def phase_classical(agg_ab, rows, card):
    """C-cc, C-pmis and SA-dev on bench.py's agg_ab problem (SA-f's: 512^2,
    sigma seed 5, b seed 6), set up and solved inside one launch-counter
    window: each to mgtpu's refined count +- 1 and a true f64 relres below
    1e-8, at its operator complexity +- 0.01, with its level sizes, formats
    and coarsest solver; (C-cg) C-cc's hierarchy under solve_cg_mg to 8 +-
    1 iterations and a true relres <= 1e-7.  The C++ setup kernels ran (the
    coloring on C-cc's levels, the greedy aggregation nowhere), kernel D
    ran in f32 and f64 in each solve, and no plain version ran.  Then
    kernel D against its plain version on C-cc's two DIA levels (f32 2e-5,
    f64 1e-12, m = 1, 3) and its times there; one cycle of each by CUDA
    events and the host clock, with the busy share.  Returns kernel D's
    launches in the window."""
    from dataclasses import replace
    from mgtpu_torch import solve_cg_mg
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.dia import DIA
    from mgtpu_torch.setup import device_agg
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    _, _, _, A, b, _, _ = agg_ab
    reset_counters()                       # ---- main path window ----
    states = {}
    for key, label, setup, opts, _, opc, sizes, kinds, coarse in CLASSICAL:
        device_agg.ROUNDS.clear()
        c0 = setup_counters()[0]
        st, host_s, dev_s = classical_setup(key, setup, opts, A)
        states[key] = st
        got_sizes = [a.shape[0] for a in st.As]
        got_kinds = [type(lv.A).__name__ for lv in st.hier.levels]
        got_coarse = type(st.hier.coarse).__name__
        calls = {k: v - c0[k] for k, v in setup_counters()[0].items()}
        rounds = [{k: v for k, v in r.items() if k != "call"}
                  for r in device_agg.ROUNDS]
        log(f"[classical] {label}: setup {host_s:.2f} s host clock, "
            f"{dev_s:.4f} s device time (torch.profiler; {card}); levels "
            f"{got_sizes}, operators {got_kinds}, coarsest {got_coarse}, "
            f"operator complexity {st.operator_complexity():.4f} (want "
            f"{opc:.4f}); C++ kernel calls {calls}; device loops {rounds}")
        require(abs(st.operator_complexity() - opc) <= 0.01,
                f"{key}: operator complexity {st.operator_complexity():.4f}")
        require(got_sizes == sizes and got_kinds == kinds
                and got_coarse == coarse, f"{key}: want levels {sizes}, "
                f"operators {kinds} and a {coarse} coarsest")
        if key == "C-cc":
            require(calls["cf_coloring"] == len(sizes) - 1,
                    f"{key}: the C++ coloring ran {calls} times")
        else:
            require(len(rounds) == len(sizes) - 1
                    and all(r["seconds"] > 0 for r in rounds),
                    f"{key}: the device loops ran {len(rounds)} times")
    for key, label, _, _, want, *_ in CLASSICAL:
        st = states[key]
        before = stencil_counters()[0]
        refined(st, A, b, want, label, card, max_iter=60)
        d_l = {k: v - before[k] for k, v in stencil_counters()[0].items()}
        log(f"[path] {key}: kernel D launches in this solve: {d_l}")
        for k in ("stencil.float32", "stencil.float64"):
            require(d_l[k] > 0, f"{key}: {k} was never launched")
    st = states["C-cc"]
    cfg = st.config
    st.config = replace(cfg, max_outer_iter=100, relative_tol=1e-8)
    try:
        before = dict(stencil_counters()[0], **block_counters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solve_cg_mg(st, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        st.config = cfg
    rr, iters = true_relres(A, b, x), int(info["iters"])
    d_l = {k: v - before[k] for k, v in stencil_counters()[0].items()}
    log(f"[path] (C-cg) C-cc's hierarchy, solve_cg_mg: {iters} iterations "
        f"(want {C_CG} +- 1), true f64 relres {rr:.3e}, time to 1e-8 "
        f"{wall:.1f} ms (host clock, synchronised; {card}); kernel D "
        f"launches {d_l}")
    require(abs(iters - C_CG) <= 1, f"C-cg: {iters} iterations")
    require(rr <= 1e-7, f"C-cg: true relres {rr:.3e} > 1e-7")
    st.config = replace(cfg, max_outer_iter=100, relative_tol=1e-8)
    try:
        compare_krylov(st, A, b, "(C-cg) C-cc's hierarchy, solve_cg_mg",
                       solve_cg_mg, {}, x, info, wall, card)
    finally:
        st.config = cfg
    for k in ("stencil.float32", "stencil.float64"):
        require(d_l[k] > 0, f"C-cg: {k} was never launched")
    launches, plain = stencil_counters()   # ---- end of window ----
    more_l, more_p = counters()
    line_l, line_p = line_counters()
    calls, setup_plain = setup_counters()
    plain.update(more_p, **line_p, **{f"setup.{k}": v
                                      for k, v in setup_plain.items()})
    log(f"[path] classical window kernel D launches: {launches}; other "
        f"kernels {dict(more_l, **line_l)}; C++ setup kernels {calls}")
    log(f"[path] classical window plain-version calls: {plain}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    require(calls["aggregate"] == 0 and calls["cf_coloring"] > 0,
            f"C++ setup kernel calls {calls}")

    levels = [("C-cc DIA level 0", st.hier.levels[0].A, st.As[0],
               high_precision_fine_operator(st), st.A_input)]
    D1 = st.hier.levels[1].A
    levels.append(("C-cc DIA level 1", D1, st.As[1],
                   DIA(D1.data.double(), D1.offsets, D1.shape), st.As[1]))
    timer = Timer()
    for label, D32, csr32, D64, csr64 in levels:
        for D in (D32, D64):
            for m in (1, 3):
                x = torch.tensor(np.random.RandomState(SEED + m).rand(
                    D.shape[0], m), dtype=D.dtype, device="cuda")
                check_d(rows, f"{label} m={m}",
                        stencil.dia_apply(D.data, D.offsets, x),
                        stencil.dia_apply_plain(D.data, D.offsets, x))
        log(f"[kernel] D {label} ({D32.shape[0]} rows, {len(D32.offsets)} "
            f"diagonals at offsets {D32.offsets}): matches its plain "
            "version, f32 and f64, m = 1, 3")
        for D, csr in ((D32, csr32), (D64, csr64)):
            dt = str(D.dtype).split(".")[-1]
            entry, _ = time_d(f"{label} {dt}", "dia", D, csr, timer, card)
            rows[f"stencil.{dt}"].setdefault("times_classical", {})[
                f"{label} {dt}"] = entry
    for key, st in states.items():
        ev_ms, _ = vcycle_ms(st, b, card, label=key)
        vcycle_profile(st, b, ev_ms, card, label=key)
        coarsest_ms(st, ev_ms, card, key)
    save_handoff("C-pmis", states["C-pmis"], A, b)
    return launches


# ---------------------------------------------------------------------------
# the staggered-systems engine
# ---------------------------------------------------------------------------

SYSTEMS = [
    # key, label, dim, cells, mixed, relax, sweeps, levels, mgtpu's refined
    # count on the CPU (scripts/systems_reference.py)
    ("V-2d", "(V-2d) mixed elasticity 1024^2, SystemsFacesMixedLinear, "
     "VankaFaces 0.75 V(1,1), 6 levels", 2, 1024, True, "VankaFaces", 1, 6,
     9),
    ("E-2d", "(E-2d) elasticity 1024^2, SystemsFacesLinear, SPAI 0.75 "
     "V(2,2), 6 levels", 2, 1024, False, "SPAI", 2, 6, 28),
    ("V-3d", "(V-3d) mixed elasticity 64^3, VankaFaces 0.75 V(1,1), 5 "
     "levels", 3, 64, True, "VankaFaces", 1, 5, 12),
]
E_CG = 13       # (E-cg) E-2d's hierarchy under solve_cg_mg, mgtpu's count
VARIANTS = [
    # key, relax, weight, sweeps, engine, mgtpu's refined count on the
    # 64^2 mixed problem, 4 levels (scripts/systems_reference.py)
    ("econ", "EconVankaFaces", 0.75, 1, "SystemsGridHierarchy", 9),
    ("add", "VankaFacesAdd", 0.75, 1, "SystemsGridHierarchy", 15),
    ("tuple", "VankaFaces", (0.75, 0.75), 1, "SystemsGridHierarchy", 8),
    ("lex", "VankaFacesLex", 0.75, 1, "Hierarchy", 9),
    ("kacz", "hybridVankaFacesKaczmarz", 0.9, 2, "Hierarchy", 31),
]
LEX_TOLS = {torch.float32: 1e-5, torch.float64: 1e-12, torch.complex64: 1e-5,
            torch.complex128: 1e-12}


def elasticity(dim, cells, mixed, shift=1e-3):
    """The systems contracts' operator (bench.py:396-399): elasticity or
    mixed elasticity with mu = lam = 1, plus shift * (max column sum) * I
    (1e-3; the complex rows (1e-3 + 1e-3i)); its mesh and b = A
    RandomState(4).rand(n), normalised."""
    from mgtpu_torch import get_regular_mesh
    from mgtpu_torch.models.operators import (
        linear_elasticity_operator, linear_elasticity_operator_mixed)
    M = get_regular_mesh([0.0, 1.0] * dim, [cells] * dim)
    mu = np.ones(M.num_cells)
    A = (linear_elasticity_operator_mixed if mixed
         else linear_elasticity_operator)(M, mu, mu)
    A = (A + shift * abs(A).sum(axis=0).max() * sp.identity(A.shape[0])
         ).tocsr()
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    return M, A, b / np.linalg.norm(b)


def systems_setup(label, dim, cells, mixed, relax, w, nu, levels, card):
    """mg_setup on the card with its host seconds by stage, and the f64
    residual operator built once; returns (state, A, b)."""
    from mgtpu_torch import get_mg_param, mg_setup
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    t0 = time.perf_counter()
    M, A, b = elasticity(dim, cells, mixed)
    t_op = time.perf_counter() - t0
    cfg, rp = get_mg_param(
        levels=levels, relax_type=relax, relax_param=w, nu_pre=nu,
        nu_post=nu, dtype=np.float32, max_outer_iter=60,
        transfer_type="SystemsFacesMixedLinear" if mixed
        else "SystemsFacesLinear")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = mg_setup(A, M, cfg, rp)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    high_precision_fine_operator(st)
    torch.cuda.synchronize()
    t_hi = time.perf_counter() - t0
    stages = ", ".join(f"{k} {v:.2f} s" for k, v in st.setup_times.items())
    log(f"[systems] {label}: {A.shape[0]} unknowns, {A.nnz} nonzeros; "
        f"operator {t_op:.2f} s, mg_setup {t_setup:.2f} s host clock "
        f"({stages}), f64 residual operator {t_hi:.2f} s; levels "
        f"{[a.shape[0] for a in st.As]}, {type(st.hier).__name__} ({card})")
    return st, A, b


def cross_blocks(key, st):
    """(label, stencil) of every block of every level of a systems state,
    f32 from the hierarchy, f64 from the residual operator (level 0) or
    the f32 coefficients widened (the coarser levels)."""
    from mgtpu_torch.ops.cross_stencil import CrossGridStencil
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    out = []
    for l, lv in enumerate(st.hier.levels):
        hi = (high_precision_fine_operator(st).stencils if l == 0 else
              [CrossGridStencil(S.coeff.double(), S.offsets, S.out_grid,
                                S.in_grid) for S in lv.A.stencils])
        for (ci, cj), S, S64 in zip(lv.A.pairs, lv.A.stencils, hi):
            out.append((f"{key} level {l} block ({ci},{cj})", S))
            out.append((f"{key} level {l} block ({ci},{cj})", S64))
    return out


def phase_cross_kernels(states, rows, card):
    """Kernel D's cross apply against its plain version on every block of
    every level of V-2d and V-3d, f32 (2e-5) and f64 (1e-12), m = 1, 2;
    a square block bitwise the square apply (grid_apply); then its times
    on V-2d's fine (0, 2) block, f32 and f64 (x-face rows from the
    pressure grid: a cross form launch; a square block launches the apply
    form), its rows' shape.  Then kernel D's
    block form (check_block) on every level operator of V-2d and V-3d and
    their f64 residual operators, and its times (time_block) on V-2d's
    and V-3d's fine levels and V-2d's f64 residual operator."""
    from mgtpu_torch.ops.cuda import stencil
    nblocks = 0
    for key in ("V-2d", "V-3d"):
        for label, S in cross_blocks(key, states[key][0]):
            for m in (1, 2):
                x = torch.tensor(np.random.RandomState(SEED + m).rand(
                    m, *S.in_grid), dtype=S.coeff.dtype, device="cuda")
                y = stencil.cross_apply(S.coeff, S.offsets, S.in_grid, x)
                check_d(rows, f"{label} m={m}", y,
                        stencil.cross_apply_plain(S.coeff, S.offsets,
                                                  S.in_grid, x),
                        "stencil_cross")
                if S.in_grid == S.out_grid:
                    require(torch.equal(y, stencil.grid_apply(
                        S.coeff, S.offsets, x)), f"{label}: the square "
                        "block differs from the square apply")
            nblocks += 1
    log(f"[kernel] D cross apply: {nblocks} blocks of V-2d's and V-3d's "
        "levels (f32 and f64, m = 1, 2) match their plain version; the "
        "square blocks are bitwise the square apply")
    # the cross form's times on its rows' block alone: since the block
    # form no systems level runs it block by block
    timer = Timer()
    for label, S in cross_blocks("V-2d", states["V-2d"][0]):
        if label != "V-2d level 0 block (0,2)":
            continue
        dt = str(S.coeff.dtype).split(".")[-1]
        entry, _ = time_d(f"{label} {dt}", "cross", S, S.to_scipy(), timer,
                          card)
        row = rows[f"stencil_cross.{dt}"]
        row.setdefault("times", {})[f"{label} {dt}"] = entry
        row.update({k: entry[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "host_ms", "plan")},
            timed_shape=f"{label}: {entry['shape']} m=1",
            library_call="torch.sparse.mm(CSR, x)")
    # kernel D's block form, the systems levels' main path: every level of
    # V-2d and V-3d and their f64 residual operators, bitwise the per-block
    # path; its times on the fine levels
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    ops = {}
    for key in ("V-2d", "V-3d"):
        st = states[key][0]
        for l, lv in enumerate(st.hier.levels):
            ops[f"{key} level {l}"] = lv.A
        ops[f"{key} f64 residual operator"] = high_precision_fine_operator(st)
    for label, op in ops.items():
        check_block(rows, label, op, stencil.cross_apply)
    log(f"[kernel] D block form: {len(ops)} level operators of V-2d and V-3d "
        "(f32 levels, f64 residual operators; apply and residual, m = 1, 2, "
        "5) bitwise the per-block cross applies, adds and subtraction, and "
        "within 2e-5 / 1e-12 of the plain version; ptxas "
        f"{ptxas('block_stencil', 'block_kernel')}")
    for label in ("V-2d level 0", "V-2d f64 residual operator",
                  "V-3d level 0"):
        op = ops[label]
        entry = time_block(label, op, states[label[:4]][1], timer, card)
        name = f"stencil_block.{str(op.dtype).split('.')[-1]}"
        rows[name].setdefault("times", {})[label] = entry
        if label.startswith("V-2d"):
            block_row(rows, op.dtype, label, entry)


# ---------------------------------------------------------------------------
# kernel D's block form (csrc/block_stencil.cu): a staggered system's level
# operator, or its residual b - A x, in one launch
# ---------------------------------------------------------------------------

def block_counters():
    """Launches of kernel D's block form, and of its cross and halo forms,
    per value type."""
    from mgtpu_torch.ops.cuda import stencil
    out = {f"stencil_block.{k}": v for k, v in stencil.BLOCK_LAUNCHES.items()}
    out.update({f"cross.{k}": v for k, v in stencil.CROSS_LAUNCHES.items()})
    out.update({f"halo.{k}": v for k, v in stencil.HALO_LAUNCHES.items()})
    return out


def block_fields(grids, m, dt, seed):
    """(m, *grid) fields of every component on the card, from one seed
    (complex: real and imaginary parts drawn in turn)."""
    rng = np.random.RandomState(seed)
    out = []
    for g in grids:
        a = rng.rand(m, *g)
        if dt.is_complex:
            a = a + 1j * rng.rand(m, *g)
        out.append(torch.tensor(a, dtype=dt, device="cuda"))
    return tuple(out)


def per_block_path(op, xs, bs, apply):
    """A block operator's apply and residual as the port ran them before
    the block form: one launch of `apply(coeff, taps, in_grid, x)` a block
    (kernel D's cross_apply, or halo_apply on a rank's blocks), torch's
    adds in block order, torch's subtraction from b."""
    g = len(op.grids[0])
    ys = [None] * len(op.grids)
    for (ci, cj), coeff, offs in zip(op.pairs, op.block_coeffs,
                                     op.block_offsets):
        t = apply(coeff, offs, tuple(xs[cj].shape[-g:]), xs[cj])
        ys[ci] = t if ys[ci] is None else ys[ci] + t
    ys = tuple(xs[0].new_zeros((xs[0].shape[0],) + tuple(gr)) if y is None
               else y for y, gr in zip(ys, op.grids))
    return ys, (None if bs is None else tuple(b - y for b, y in zip(bs, ys)))


def check_block(rows, label, op, apply, ms=(1, 2, 5), seed=0):
    """Kernel D's block form on `op` (a BlockGridOperator, or a rank's
    ShardedBlockOperator on its halo-extended inputs), apply and residual
    at each m of `ms`: bit for bit the per-block path (`per_block_path`
    with `apply`), and within 2e-5 / 1e-12 of its plain version (the row
    stencil_block.<type> keeps the largest errors)."""
    from mgtpu_torch.ops.cuda import stencil
    dt = op.block_coeffs[0].dtype
    for m in ms:
        xs = block_fields(getattr(op, "in_grids", op.grids), m, dt,
                          SEED + seed + m)
        bs = block_fields(op.grids, m, dt, SEED + seed + 10 + m)
        got = stencil.block_apply(op, xs) + stencil.block_apply(op, xs, bs)
        y0, r0 = per_block_path(op, xs, bs, apply)
        torch.cuda.synchronize()
        for c, (a, b) in enumerate(zip(got, y0 + r0)):
            require(torch.equal(a, b), f"block form {label} m={m}: output "
                    f"{c} differs from the per-block path")
        ref = (stencil.block_apply_plain(op, xs)
               + stencil.block_apply_plain(op, xs, bs))
        for c, (a, b) in enumerate(zip(got, ref)):
            check_d(rows, f"block form {label} m={m} output {c}", a, b,
                    "stencil_block")


def time_block(label, op, csr, timer, card):
    """Kernel D's block form, the residual b - A x of a level operator
    (m = 1, four input sets): its device time by CUDA events and inside a
    CUDA graph, beside its least time (each block's coefficients, each
    input component once, b read and r written), the per-block path it
    replaces (events and graph), its plain version and torch.sparse.mm of
    the level's host CSR `csr` (in the operator's type) followed by
    b - y."""
    from mgtpu_torch.cycle.systems_grid import fields_to_rows
    from mgtpu_torch.ops.cuda import stencil
    dt = op.dtype
    item = torch.empty((), dtype=dt).element_size()
    sets = [(block_fields(op.grids, 1, dt, SEED + 60 + j),
             block_fields(op.grids, 1, dt, SEED + 70 + j)) for j in range(4)]
    calls = lambda fn: [lambda s=s: fn(*s) for s in sets]
    new = lambda xs, bs: stencil.block_apply(op, xs, bs)
    old = lambda xs, bs: per_block_path(op, xs, bs, stencil.cross_apply)
    plain = lambda xs, bs: stencil.block_apply_plain(op, xs, bs)
    ms, host_ms = timer(calls(new))
    g_ms = graph_ms(calls(new))
    old_ms, old_host_ms = timer(calls(old))
    old_g_ms = graph_ms(calls(old))
    plain_ms = timer(calls(plain))[0]
    Tm = sparse_mm_yardstick(csr, dt)
    cols = [tuple(fields_to_rows(f).reshape(-1, 1) for f in s) for s in sets]
    lib_ms = None
    try:
        lib_ms = timer([lambda c=c: c[1] - torch.sparse.mm(Tm, c[0])
                        for c in cols])[0]
    except RuntimeError as e:              # the yardstick, not the port
        log(f"[time] D block {label}: torch.sparse.mm has no {dt} CSR "
            f"product on the card ({str(e).splitlines()[0][:90]}): library "
            "time none")
    n_out = [int(np.prod(g)) for g in op.grids]
    taps = sum(len(o) * n_out[ci] for (ci, _), o in zip(op.pairs,
                                                        op.block_offsets))
    fbytes = (taps + sum(n_out) * 3) * item
    flops = (8 if dt.is_complex else 2) * taps + (2 if dt.is_complex
                                                  else 1) * sum(n_out)
    peak = (FP32_FLOPS if dt in (torch.float32, torch.complex64)
            else FP64_FLOPS)
    bound = max(fbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
    splits = sorted({int(v) for v in
                     stencil.block_table_parts(op.block_table)[1][:, 5]})
    note = (f"{len(op.grids)} components {list(op.grids)}, {len(op.pairs)} "
            f"blocks, {sum(len(o) for o in op.block_offsets)} taps, splits "
            f"{splits}")
    fmt = lambda v: "none" if v is None else f"{v:.4f} ms"
    # the per-block path: a launch a block, an add a block after a
    # component's first, a subtraction a component
    fed = len({ci for ci, _ in op.pairs})
    old_launches = 2 * len(op.pairs) - fed + len(op.grids)
    log(f"[time] D block {label} {dt} residual: kernel {ms:.4f} ms (graph "
        f"{g_ms:.4f})  per-block path {old_ms:.4f} ms (graph {old_g_ms:.4f}, "
        f"{old_launches} launches)  plain {fmt(plain_ms)}  sparse.mm + b - y "
        f"{fmt(lib_ms)}  "
        f"bound {bound:.4f} ms ({fbytes / 1e6:.2f} MB)  kernel/bound "
        f"{ms / bound:.1f}x  host per call {host_ms:.3f} ms (per-block "
        f"{old_host_ms:.3f})  {note} ({card})")
    return dict(shape=note, ms=ms, graph_ms=g_ms, old_path_ms=old_ms,
                old_path_graph_ms=old_g_ms, old_path_launches=old_launches,
                plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, host_ms=host_ms,
                old_path_host_ms=old_host_ms,
                bound_by="bytes" if fbytes / HBM_BYTES_PER_S >= flops / peak
                else "operations")


def block_row(rows, dt, label, entry):
    """A timing entry as the headline of the row stencil_block.<dt>."""
    row = rows[f"stencil_block.{str(dt).split('.')[-1]}"]
    row.update({k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "host_ms",
                                      "old_path_ms", "graph_ms")},
               timed_shape=f"{label}: {entry['shape']}, residual, m=1",
               library_call="b - torch.sparse.mm(CSR, x)",
               ptxas=ptxas("block_stencil", "block_kernel"))


def lex_tables(st, l):
    """The vanka-lex tables of level l of a flat state, as kernel E takes
    them."""
    vr = st.hier.levels[l].relax
    return vr.idx[0], vr.dinv[0], vr.rows_idx[0], vr.rows_val[0]


def e_forms(n, tabs, m):
    """Kernel E's forms that fit a call, the one it takes first: {form:
    its shared memory}."""
    from mgtpu_torch.ops.cuda import vanka
    L, bs = tabs[0].shape
    K = tabs[2].shape[-1]
    dt = tabs[3].dtype
    item = torch.empty((), dtype=dt).element_size()
    ditem = 8 if dt.is_complex else 4
    need = {f: vanka.smem_bytes(bs, K, m, n, item, ditem, f)
            for f in E_FORMS}
    return {f: v for f, v in need.items() if v <= vanka.MAX_SHARED}


def e_call(x, b, tabs, it, need):
    """One kernel E launch with shared memory capped at `need`, so that it
    takes the form that needs that much (the first that fits)."""
    from mgtpu_torch.ops.cuda import vanka
    old = vanka.MAX_SHARED
    vanka.MAX_SHARED = need
    try:
        return vanka.lex_sweep(x, b, *tabs, it)
    finally:
        vanka.MAX_SHARED = old


def check_e(label, n, tabs, row, seed, complex_=False):
    """Kernel E (two sweeps) against its plain per-cell loop (LEX_TOLS,
    relative) in every form that fits (x staged in shared memory, x in
    global memory): two launches of a form bitwise, every form bitwise the
    first.  Returns the forms."""
    from mgtpu_torch.ops.cuda import vanka
    dt = tabs[3].dtype
    rng = np.random.RandomState(seed)
    draw = (lambda: rng.rand(n, 1) + 1j * rng.rand(n, 1)) if complex_ \
        else (lambda: rng.rand(n, 1))
    x, b = (torch.tensor(draw(), dtype=dt, device="cuda") for _ in range(2))
    ref = vanka.lex_sweep_plain(x, b, *tabs, 2)
    forms = e_forms(n, tabs, 1)
    first = None
    for form, need in forms.items():
        f0 = vanka.FORMS[form]
        out = e_call(x, b, tabs, 2, need)
        out2 = e_call(x, b, tabs, 2, need)
        torch.cuda.synchronize()
        require(vanka.FORMS[form] == f0 + 2, f"kernel E {label}: form "
                f"{form} did not run")
        require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                f"kernel E {label} {form}: bad output")
        require(torch.equal(out, out2), f"kernel E {label} {form}: two "
                "launches differ")
        require(first is None or torch.equal(out, first), f"kernel E "
                f"{label}: form {form} differs from {next(iter(forms))}")
        first = out if first is None else first
        ae = float((out - ref).abs().max())
        re = ae / float(ref.abs().max())
        row["max_abs_err"] = max(row["max_abs_err"], ae)
        row["max_rel_err"] = max(row["max_rel_err"], re)
        require(re < LEX_TOLS[dt], f"kernel E {label} {form} {dt}: "
                f"relative error {re:.3e} >= {LEX_TOLS[dt]}")
    return list(forms)


def time_e(label, n, tabs, card):
    """One sweep of kernel E in each form that fits (m = 1), beside its
    byte bound (idx, dinv, the rows, b, x read and written) and its chain
    bound (cells x the probe's warp round).  Returns {form: entry}, the
    first the call's own."""
    from mgtpu_torch.ops.cuda import vanka
    idx, dinv, ri, rv = tabs
    dt = rv.dtype
    item = torch.empty((), dtype=dt).element_size()
    ditem = 8 if dt.is_complex else 4
    L, bs = idx.shape
    K = ri.shape[-1]
    add = 0.5j if dt.is_complex else 0
    sets = [tuple(torch.tensor(np.random.RandomState(SEED + j + k).rand(
        n, 1) + add, dtype=dt, device="cuda") for k in (0, 9))
        for j in range(2)]
    fbytes = (L * bs * 4 + L * bs * bs * ditem + L * bs * K * (4 + item)
              + 3 * n * item)
    flops = (8 if dt.is_complex else 2) * L * bs * (K + bs)
    peak = FP32_FLOPS if dt in (torch.float32, torch.complex64) \
        else FP64_FLOPS
    bound = max(fbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
    chain = L * PROBE_NS["warp"] * 1e-6
    out = {}
    for form, need in e_forms(n, tabs, 1).items():
        ms, host_ms = Timer(reps=10)([lambda s=s: e_call(
            s[0], s[1], tabs, 1, need) for s in sets])
        log(f"[time] E lex sweep, {label} ({L} cells, bs {bs}, K {K}, {dt}, "
            f"m=1), form {form}: kernel {ms:.4f} ms ({ms * 1e3 / L:.3f} us "
            f"a cell), byte bound {bound:.4f} ms ({fbytes / 1e6:.2f} MB), "
            f"chain bound {chain:.4f} ms ({L} x {PROBE_NS['warp']:.1f} ns, "
            f"warp), host per call {host_ms:.3f} ms ({card})")
        bound_by = "bytes" if fbytes / HBM_BYTES_PER_S >= flops / peak \
            else "operations"
        out[form] = dict(ms=ms, host_ms=host_ms, us_per_cell=ms * 1e3 / L,
                         chain_bound_ms=chain, bound_ms=bound,
                         bound_by=bound_by, limited_by="chain"
                         if chain > bound else bound_by)
    log(f"[time] E ptxas: {ptxas('vanka', 'vanka_lex_kernel')}")
    return out


def e_row(row, times, plain_ms, shape):
    """The kernels line's fields of a kernel E row from `time_e`'s
    entries (the call's own form first)."""
    form, e = next(iter(times.items()))
    row.update(ms=e["ms"], plain_ms=plain_ms, bound_ms=e["bound_ms"],
               library_ms=None, library_call="none: no PyTorch call "
               "computes a Vanka sweep", host_ms=e["host_ms"],
               us_per_cell=e["us_per_cell"],
               chain_bound_ms=e["chain_bound_ms"], form=form,
               forms={f: round(v["ms"], 4) for f, v in times.items()},
               bound_by=e["bound_by"], limited_by=e["limited_by"],
               timed_shape=shape, ptxas=ptxas("vanka", "vanka_lex_kernel"))


def phase_lex_kernel(lex_state, rows, card):
    """Kernel E against its plain version (the per-cell loop) on a 32^2
    mixed problem and on every level of the 64^2 lex hierarchy, f32
    (1e-5) and f64 (1e-12), two sweeps, in every form that fits; its
    device time on the 64^2 fine level in each form beside its byte bound,
    its chain bound and the plain loop's time."""
    from mgtpu_torch.ops.cuda import vanka
    from mgtpu_torch.setup.smoothers import setup_vanka
    M, A, _ = elasticity(2, 32, True)
    cases = []
    for dt in (np.float32, np.float64):
        vr = setup_vanka(A, M, 0.75, True, "vanka-lex", dtype=dt).to(
            torch.float32 if dt == np.float32 else torch.float64, "cuda")
        cases.append(("32^2 level 0", A.shape[0],
                      (vr.idx[0], vr.dinv[0], vr.rows_idx[0],
                       vr.rows_val[0])))
    st = lex_state
    for l in range(len(st.hier.levels) - 1):
        t32 = lex_tables(st, l)
        cases.append((f"64^2 level {l}", st.As[l].shape[0], t32))
        cases.append((f"64^2 level {l}", st.As[l].shape[0],
                      t32[:3] + (t32[3].double(),)))
    row = rows["vanka_lex"]
    seen = set()
    for label, n, tabs in cases:
        seen.update(check_e(label, n, tabs, row, SEED + n))
    require(seen == set(E_FORMS), f"kernel E: forms {seen} ran, want all "
            f"of {E_FORMS}")
    log(f"[kernel] E (lexicographic Vanka): {len(cases)} cases (32^2 and "
        f"every level of the 64^2 lex hierarchy, f32 and f64, two sweeps, "
        f"every form) match the per-cell loop; forms bitwise one another")
    # more right-hand sides than one warp walks a cell with (bs 5, m 7):
    # launches of at most 32 // bs columns
    label, n, tabs = cases[1]
    rng = np.random.RandomState(SEED)
    x, b = (torch.tensor(rng.rand(n, 7), device="cuda") for _ in range(2))
    n0 = vanka.LAUNCHES["float64"]
    out = vanka.lex_sweep(x, b, *tabs, 2)
    ref = vanka.lex_sweep_plain(x, b, *tabs, 2)
    re = float((out - ref).abs().max() / ref.abs().max())
    require(vanka.LAUNCHES["float64"] == n0 + 2 and re < LEX_TOLS[
        torch.float64], f"kernel E {label} m=7: {vanka.LAUNCHES['float64'] - n0}"
        f" launches, relative error {re:.3e}")
    log(f"[kernel] E {label} f64 m=7: two launches (6 + 1 columns) match "
        f"the per-cell loop (rel {re:.2e})")
    tabs = lex_tables(st, 0)
    n = st.As[0].shape[0]
    L, bs = tabs[0].shape
    K = tabs[2].shape[-1]
    times = time_e("64^2 fine level", n, tabs, card)
    sets = [(torch.tensor(np.random.RandomState(SEED + j).rand(n, 1),
                          dtype=torch.float32, device="cuda"),
             torch.tensor(np.random.RandomState(SEED + 9 + j).rand(n, 1),
                          dtype=torch.float32, device="cuda"))
            for j in range(1)]
    plain_ms = loop_ms(lambda: vanka.lex_sweep_plain(
        sets[0][0], sets[0][1], *tabs, 1))
    log(f"[time] E plain version, 64^2 fine level: {plain_ms:.1f} ms "
        f"({card})")
    e_row(row, times, plain_ms, f"64^2 fine level: {L} cells, "
          f"bs {bs}, K {K}, m=1, one sweep")


def phase_systems(card):
    """V-2d, E-2d and V-3d set up on the card (host seconds by stage),
    E-cg on E-2d's hierarchy, and the five Vanka variants at 64^2, all
    solved inside one launch-counter window: each to mgtpu's count +- 1
    and a true f64 relres below 1e-8; kernel D in f32 and f64 in each
    systems-engine solve, kernel E in the lex solve, no plain version
    anywhere.  Every solve is held against its eager run (the captured
    phase).  Returns (the states, the lex state, the window's launches)."""
    from dataclasses import replace
    from mgtpu_torch import solve_cg_mg
    states = {}
    for key, label, dim, cells, mixed, relax, nu, levels, _ in SYSTEMS:
        states[key] = systems_setup(label, dim, cells, mixed, relax, 0.75,
                                    nu, levels, card)
    variants = {}
    for key, relax, w, nu, engine, _ in VARIANTS:
        st, A, b = systems_setup(f"({key}) 64^2 mixed, {relax} {w}", 2, 64,
                                 True, relax, w, nu, 4, card)
        require(type(st.hier).__name__ == engine,
                f"{key}: {type(st.hier).__name__}, want {engine}")
        variants[key] = (st, A, b)
    reset_counters()                       # ---- main path window ----
    for key, label, *_, want in SYSTEMS:
        st, A, b = states[key]
        before = dict(stencil_counters()[0], **block_counters())
        refined(st, A, b, want, label, card, max_iter=60)
        d_l = {k: v - before[k] for k, v in
               dict(stencil_counters()[0], **block_counters()).items()}
        log(f"[path] {key}: kernel D launches in this solve: {d_l}")
        for k in ("stencil_block.float32", "stencil_block.float64"):
            require(d_l[k] > 0, f"{key}: {k} was never launched")
    st, A, b = states["E-2d"]
    cfg = st.config
    st.config = replace(cfg, max_outer_iter=100, relative_tol=1e-8)
    try:
        before = dict(stencil_counters()[0], **block_counters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solve_cg_mg(st, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rr, iters = true_relres(A, b, x), int(info["iters"])
        d_l = {k: v - before[k] for k, v in
               dict(stencil_counters()[0], **block_counters()).items()}
        log(f"[path] (E-cg) E-2d's hierarchy, solve_cg_mg: {iters} "
            f"iterations (want {E_CG} +- 1), true f64 relres {rr:.3e}, time "
            f"to 1e-8 {wall:.1f} ms (host clock, synchronised; {card}); "
            f"kernel D launches {d_l}")
        require(abs(iters - E_CG) <= 1, f"E-cg: {iters} iterations")
        require(rr < 1e-8, f"E-cg: true relres {rr:.3e} >= 1e-8")
        for k in ("stencil_block.float32", "stencil_block.float64"):
            require(d_l[k] > 0, f"E-cg: {k} was never launched")
        compare_krylov(st, A, b, "(E-cg) E-2d's hierarchy, solve_cg_mg",
                       solve_cg_mg, {}, x, info, wall, card)
    finally:
        st.config = cfg
    for key, relax, w, nu, engine, want in VARIANTS:
        st, A, b = variants[key]
        count = lambda: dict(stencil_counters()[0], **vanka_counters()[0],
                             **block_counters())
        before = count()
        refined(st, A, b, want, f"({key}) 64^2 mixed, {relax} {w} "
                f"V({nu},{nu}), {engine}", card, max_iter=60)
        got = {k: v - before[k] for k, v in count().items()}
        log(f"[path] ({key}): kernel launches in this solve: {got}")
        if engine == "SystemsGridHierarchy":
            for k in ("stencil_block.float32", "stencil_block.float64"):
                require(got[k] > 0, f"{key}: {k} was never launched")
        if key == "lex":
            require(got["vanka.float32"] > 0,
                    "lex: kernel E was never launched")
    launches, plain = stencil_counters()   # ---- end of window ----
    e_l, e_p = vanka_counters()
    more_l, more_p = counters()
    line_l, line_p = line_counters()
    launches.update(e_l, **block_counters())
    plain.update(e_p, **more_p, **line_p)
    log(f"[path] systems window kernel D and E launches: {launches}; other "
        f"kernels {dict(more_l, **line_l)}; E by form "
        f"{form_counters()}")
    log(f"[path] systems window plain-version calls on the card: {plain}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    # every systems level's apply and residual is one block-form launch:
    # no block runs alone on the cross or halo form
    require(not any(v for k, v in launches.items()
                    if k.startswith(("cross.", "halo."))),
            f"systems window: kernel D's cross or halo form ran: {launches}")
    for key, *_ in SYSTEMS:
        st, A, b = states[key]
        ev_ms, _ = vcycle_ms(st, b, card, label=key)
        vcycle_profile(st, b, ev_ms, card, label=key)
    return states, variants["lex"][0], launches


def chunk_sweep(jac, f, card):
    """Time to 1e-8 of the 3D Jacobi refined solve and of (f)'s CG, by the
    host clock (synchronised), at 1, 2, 4, 8 and 16 iterations a recorded
    program: the first call (with its recordings) and the best of two
    warm ones; counts equal at every size."""
    from mgtpu_torch import solve_cg_mg, solve_mg_refined
    from mgtpu_torch.krylov import _loop
    cases = (("3D Jacobi V(1,1) refined", jac,
              lambda st, b: solve_mg_refined(st, b, tol=1e-8, max_iter=40)),
             ("(f) CG", f, solve_cg_mg))
    out = []
    saved = _loop.CHUNK
    try:
        with uncounted():
            for label, (st, b), solve in cases:
                counts = set()
                for c in (1, 2, 4, 8, 16):
                    _loop.CHUNK = c
                    t = []
                    for _ in range(3):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        _, info = solve(st, b)
                        torch.cuda.synchronize()
                        t.append((time.perf_counter() - t0) * 1e3)
                    counts.add(int(info["iters"]))
                    out.append(dict(path=label, chunk=c,
                                    iters=int(info["iters"]), first_ms=t[0],
                                    warm_ms=min(t[1:])))
                    log(f"[chunk] {label}: {c:2d} iterations a program, "
                        f"{int(info['iters'])} iterations, time to 1e-8 "
                        f"{min(t[1:]):.2f} ms warm, {t[0]:.1f} ms first call "
                        f"(host clock, synchronised; {card})")
                require(len(counts) == 1, f"{label}: counts {counts} differ "
                        "between chunk sizes")
    finally:
        _loop.CHUNK = saved
    return out


def coarsest_ms(st, cycle_ms, card, label):
    """One coarsest solve of the cycle's type on the card, by the host
    clock (synchronised; SparseLUCoarse is a round trip to the host's
    SuperLU), the median of five."""
    c = st.hier.coarse
    bc = torch.tensor(np.random.RandomState(SEED).rand(st.As[-1].shape[0], 1),
                      dtype=torch.float32, device="cuda")
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.solve(bc)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = sorted(times[1:])[2]
    log(f"[path] {label}: one coarsest solve ({type(c).__name__} of "
        f"{st.As[-1].shape[0]} dofs) {ms:.3f} ms host clock, of the "
        f"cycle's {cycle_ms:.3f} ms ({card})")


# ---------------------------------------------------------------------------
# the façade, the direct tier, DD and hybrid Kaczmarz (kernel F)
# ---------------------------------------------------------------------------

# mgtpu's counts on the CPU (scripts/facade_reference.py; ROADMAP North star)
FACADE = {"W": {"gmres": 4, "pcg": 15, "bicgstab": 10}, "W-3d": 7,
          "W-amg": {"SAAMGSolver": 15, "ClassicalAMGSolver": 9},
          "W-adj": (1, 1, 1), "R": 16, "R-sigma": 20, "D-coarse": 16,
          "DD-256": 6, "DD-coarse": 16, "K-mg": 17, "K-prec": 3, "bf16": 22,
          "RD": 11}
F_TOLS = {torch.float32: 2e-5, torch.float64: 1e-12, torch.complex64: 2e-5,
          torch.complex128: 1e-12}
E_FORMS = ("smem_b", "smem", "global")     # kernel E's forms, in order
DTYPES_TOL = [(np.float64, 1e-8), (np.float32, 1e-4),
              (np.complex128, 1e-8), (np.complex64, 1e-4)]


def rhs_of(A, m=None, seed=4):
    """b = A RandomState(seed).rand(n) normalised (m columns: each column
    normalised)."""
    rng = np.random.RandomState(seed)
    if m is None:
        b = A @ rng.rand(A.shape[0])
        return b / np.linalg.norm(b)
    B = A @ rng.rand(A.shape[0], m)
    return B / np.linalg.norm(B, axis=0)


def col_relres(A, B, X) -> float:
    """The largest true f64 relres over the columns of X."""
    xh = X.detach().cpu().numpy().astype(np.float64)
    require(xh.shape == B.shape and np.isfinite(xh).all(),
            "solution has the wrong shape or non-finite values")
    return float(np.max(np.linalg.norm(B - A @ xh, axis=0)
                        / np.linalg.norm(B, axis=0)))


def kmg_state(card):
    """K-mg: 256^2, sigma = exp(0.3 RandomState(3).randn) + 1e-4 shift, 4
    levels, float64, hybrid Kaczmarz [4, 4] omega 0.8 num_it 2, V(1,1)."""
    from mgtpu_torch import get_mg_param, mg_setup
    from mgtpu_torch.dd.indices import nodal_indices_of_box
    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    from mgtpu_torch import get_regular_mesh
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [256, 256])
    sig = np.exp(0.3 * np.random.RandomState(3).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-4 * abs(A).sum(axis=0).max() * sp.identity(A.shape[0])
         ).tocsr()
    cfg, _ = get_mg_param(levels=4, relax_type="hybridKaczmarzNodal",
                          nu_pre=1, nu_post=1, relative_tol=1e-8,
                          max_outer_iter=60)
    rp = {"num_domains": [4, 4], "omega": 0.8, "num_it": 2,
          "index_fn": nodal_indices_of_box}
    t0 = time.perf_counter()
    st = mg_setup(A, M, cfg, rp)
    log(f"[facade] (K-mg) setup {time.perf_counter() - t0:.2f} s (host "
        f"clock), {type(st.hier).__name__}, levels "
        f"{[a.shape[0] for a in st.As]}, Kaczmarz steps a sweep "
        f"{[lv.relax.arr.shape[0] for lv in st.hier.levels[:-1]]} over "
        f"{st.hier.levels[0].relax.arr.shape[1]} domains ({card})")
    require(type(st.hier).__name__ == "Hierarchy", "K-mg: want the flat "
            "engine")
    return st, A, rhs_of(A)


def kprec_state():
    """K-prec: test_dd.py:115 at 256^2 (sigma = exp(RandomState(3).randn),
    + 0.2 shift), [4, 4] domains, omega 0.8, num_it 5."""
    from mgtpu_torch.cycle.kaczmarz import setup_hybrid_kaczmarz
    from mgtpu_torch.dd.indices import nodal_indices_of_box
    M, A = divsig((256, 256), shift=2e-1)
    kz = setup_hybrid_kaczmarz(A, M, [4, 4], nodal_indices_of_box, 0.8, 5)
    return A, kz.to(torch.float64, "cuda")


def f_tables(kz, dtype):
    """A Kaczmarz state's tables as kernel F takes them, in `dtype`."""
    real = dtype.to_real()
    return (kz.arr, kz.mask.to(real), kz.invd.to(real), kz.ell_idx,
            kz.ell_val.to(dtype), kz.link)


def f_call(kz, x, b, tabs, it):
    """One launch of kernel F on the state's plan (with its records where
    the values are the state's own)."""
    from mgtpu_torch.ops.cuda import kaczmarz as kf
    rec = kz.records if tabs[4] is kz.ell_val else None
    return kf.kaczmarz_sweep_kernel(x, b, *tabs, it, plan=kz.plan,
                                    records=rec)


def check_f(label, kz, dt, m, it, row, seed, complex_=False):
    """Kernel F against its plain version (F_TOLS, relative); a second
    launch bitwise the first."""
    from mgtpu_torch.ops.cuda import kaczmarz as kf
    tabs = f_tables(kz, dt)
    n = kz.ell_idx.shape[0]
    rng = np.random.RandomState(seed)
    draw = (lambda: rng.rand(n, m) + 1j * rng.rand(n, m)) if complex_ \
        else (lambda: rng.rand(n, m))
    x, b = (torch.tensor(draw(), dtype=dt, device="cuda") for _ in range(2))
    ref = kf.kaczmarz_sweep_plain(x, b, *tabs[:-1], it)
    out = f_call(kz, x, b, tabs, it)
    out2 = f_call(kz, x, b, tabs, it)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out).all()), f"kernel F {label}: "
            "non-finite output")
    require(torch.equal(out, out2), f"kernel F {label}: two launches "
            "differ")
    ae = float((out - ref).abs().max())
    re = ae / float(ref.abs().max())
    row["max_abs_err"] = max(row["max_abs_err"], ae)
    row["max_rel_err"] = max(row["max_rel_err"], re)
    require(re < F_TOLS[dt], f"kernel F {label} {dt} m={m}: relative "
            f"error {re:.3e} >= {F_TOLS[dt]}")


def time_f(label, kz, dt, it, card):
    """Kernel F's device time (m = 1) beside the byte bound (what
    row_step reads and writes: arr, the real mask and invd, the ELL rows,
    b, and x read and written; F's own tables left out) and the chain
    bound (steps x the probe's __syncwarp round).  Returns the entry."""
    tabs = f_tables(kz, dt)
    max_len, nd = kz.arr.shape
    n, K = kz.ell_idx.shape
    steps = it * max_len
    complex_ = dt.is_complex
    item = torch.empty((), dtype=dt).element_size()
    real = item // 2 if complex_ else item
    fbytes = (max_len * nd * (4 + real) + n * real + n * K * (4 + item)
              + 3 * n * item)
    flops = it * max_len * nd * ((16 * K + 6) if complex_ else (4 * K + 3))
    peak = FP32_FLOPS if real == 4 else FP64_FLOPS
    add = 1j if complex_ else 0
    sets = [tuple(torch.tensor(np.random.RandomState(SEED + j + k).rand(
        n, 1) + add, dtype=dt, device="cuda") for k in (0, 9))
        for j in range(2)]
    bound = max(fbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
    bound_by = "bytes" if fbytes / HBM_BYTES_PER_S >= flops / peak \
        else "operations"
    chain = steps * PROBE_NS["warp"] * 1e-6
    ms, host_ms = Timer(reps=10)([lambda s=s: f_call(kz, s[0], s[1], tabs,
                                                      it) for s in sets])
    log(f"[time] F Kaczmarz launch, {label} ({n} rows, {max_len} steps x "
        f"{nd} domains, K {K}, {it} sweeps, {dt}, m=1): kernel {ms:.4f} ms "
        f"({ms * 1e3 / steps:.3f} us a step), byte bound {bound:.4f} ms "
        f"({fbytes / 1e6:.2f} MB), chain bound {chain:.4f} ms ({steps} x "
        f"{PROBE_NS['warp']:.1f} ns, warp), host per call {host_ms:.3f} ms "
        f"({card})")
    log(f"[time] F ptxas: {ptxas('kaczmarz', 'kaczmarz_kernel')}")
    return dict(ms=ms, host_ms=host_ms, us_per_step=ms * 1e3 / steps,
                chain_bound_ms=chain, bound_ms=bound, bound_by=bound_by,
                limited_by="chain" if chain > bound else bound_by)


def f_row(row, e, plain_ms, shape):
    """The kernels line's fields of a kernel F row from `time_f`'s
    entry."""
    row.update(ms=e["ms"], plain_ms=plain_ms, bound_ms=e["bound_ms"],
               library_ms=None, library_call="none: no PyTorch call "
               "computes a sweep", host_ms=e["host_ms"],
               us_per_step=e["us_per_step"],
               chain_bound_ms=e["chain_bound_ms"], bound_by=e["bound_by"],
               limited_by=e["limited_by"], timed_shape=shape,
               ptxas=ptxas("kaczmarz", "kaczmarz_kernel"))


def phase_kaczmarz_kernel(kmg, kprec, rows, card):
    """Kernel F against its plain version (mgtpu's row_step in torch) on
    every level of the K-mg hierarchy, the K-prec level and a ragged 255^2
    mesh (padded domains, unequal max_len), f32 (2e-5) and f64 (1e-12),
    m = 1-3, a second launch bitwise the first; then its device time on
    the K-mg fine level (one main-path launch: two sweeps, f64, m = 1) and
    on level 1 beside its byte bound, its dependency-chain bound (the
    probe's warp round a step) and the plain version."""
    from mgtpu_torch.cycle.kaczmarz import setup_hybrid_kaczmarz
    from mgtpu_torch.dd.indices import nodal_indices_of_box
    from mgtpu_torch.ops.cuda import kaczmarz as kf
    st = kmg[0]
    M_r, A_r = divsig((255, 255), shift=1e-4)
    ragged = setup_hybrid_kaczmarz(A_r, M_r, [4, 4], nodal_indices_of_box,
                                   0.8, 2).to(torch.float64, "cuda")
    require(bool((ragged.mask == 0).any()), "the 255^2 case has no padding")
    cases = []
    for l, lv in enumerate(st.hier.levels[:-1]):
        cases.append((f"K-mg level {l}", lv.relax, torch.float64, 1 + l % 3,
                      1 if l == 0 else 2))
        cases.append((f"K-mg level {l}", lv.relax, torch.float32,
                      3 - l % 3, 1 if l == 0 else 2))
    cases += [("K-prec 257^2", kprec[1], torch.float64, 2, 1),
              ("ragged 255^2", ragged, torch.float32, 1, 1),
              ("ragged 255^2", ragged, torch.float64, 3, 1)]
    row = rows["kaczmarz"]
    for label, kz, dt, m, it in cases:
        n = kz.ell_idx.shape[0]
        check_f(label, kz, dt, m, it, row, SEED + n + m)
        log(f"[kernel] F {label} {dt} m={m}: matches the plain version; a "
            f"second launch is bitwise the first")
    log(f"[kernel] F (hybrid Kaczmarz): {len(cases)} cases (every K-mg "
        f"level, K-prec, a ragged 255^2 mesh; f32 and f64, m = 1-3) match "
        f"the plain version (max rel {row['max_rel_err']:.2e}); a second "
        f"launch is bitwise the first")
    kz = st.hier.levels[0].relax
    max_len, nd = kz.arr.shape
    n, K = kz.ell_idx.shape
    it = st.config.nu_pre[0] * kz.num_it
    times = time_f("K-mg fine level", kz, torch.float64, it, card)
    tabs = f_tables(kz, torch.float64)
    sets = [(torch.tensor(np.random.RandomState(SEED + j).rand(n, 1),
                          device="cuda"),
             torch.tensor(np.random.RandomState(SEED + 9 + j).rand(n, 1),
                          device="cuda")) for j in range(1)]
    plain_ms = loop_ms(lambda: kf.kaczmarz_sweep_plain(
        sets[0][0], sets[0][1], *tabs[:-1], it))
    log(f"[time] F plain version, K-mg fine level: {plain_ms:.1f} ms "
        f"({card})")
    f_row(row, times, plain_ms,
          f"K-mg fine level: {n} rows, {max_len} steps x {nd} domains, K "
          f"{K}, {it} sweeps, f64, m=1")
    time_f("K-mg level 1", st.hier.levels[1].relax, torch.float64, it, card)


def captured_row(label, iters, x_rel, relres, first_ms, solve_ms, eager_ms,
                 pair=None):
    """A CAPTURED row for a path held against its eager run by its own
    loop; `pair` the cycle pair's fields, or none."""
    row = dict(label=label, iters=iters, x_rel=x_rel, relres=relres,
               first_ms=first_ms, solve_ms=solve_ms, eager_ms=eager_ms,
               solve_dev_ms=None, solve_busy=None, **(pair or NO_PAIR))
    CAPTURED.append(row)
    log_captured(row, card_name())
    return row


_CARD = []


def card_name():
    return _CARD[0] if _CARD else "?"


def timed(fn):
    """fn() and its host-clock ms (synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def facade_wrappers(M3, L3, card):
    """W (MGSolver gmres / pcg / bicgstab on (f)'s operator, 4 columns;
    the second pcg call reuses the setup), W-3d (MGSolver pcg on 128^3,
    kernels A and B), W-amg (SAAMGSolver, ClassicalAMGSolver)."""
    import mgtpu_torch as mt
    from mgtpu_torch.ops.cuda import const3d, fused3d
    M, A = divsig((1024, 1024))
    B = rhs_of(A, 4)
    cfg, rp = mt.get_mg_param(levels=6, dtype=np.float32, relative_tol=1e-8,
                              max_outer_iter=100)
    for k, want in FACADE["W"].items():
        s = mt.MGSolver(cfg, rp, mesh=M, krylov=k)
        before = stencil_counters()[0]
        X, ms = timed(lambda: s.solve_linear_system(A, B))
        per_col, rr = s.n_iter // 4, col_relres(A, B, X)
        d_l = {key: v - before[key] for key, v in stencil_counters()[0].items()}
        log(f"[facade] (W) MGSolver({k}) 1024^2 SPAI V(2,2), 4 columns: "
            f"{per_col} iterations a column (want {want} +- 1), true f64 "
            f"relres <= {rr:.3e}, setup {s.time_setup:.2f} s, solve "
            f"{ms:.1f} ms incl. setup and recording (host clock; {card}); "
            f"kernel D {d_l}")
        require(abs(per_col - want) <= 1, f"W {k}: {per_col} iterations")
        require(rr < 1e-8, f"W {k}: relres {rr:.3e}")
        require(d_l["stencil.float32"] > 0 and d_l["stencil.float64"] > 0,
                f"W {k}: kernel D idle")
        if k == "pcg":
            ts, hier = s.time_setup, s.state.hier
            X2, ms2 = timed(lambda: s.solve_linear_system(A, B))
            require(s.time_setup == ts and s.state.hier is hier,
                    "W: the second call set up anew")
            require(s.n_iter == 2 * per_col * 4, "W: second call's count")
            log(f"[facade] (W) second pcg call: the setup reused, "
                f"{ms2:.1f} ms (host clock; {card})")
            x, info = mt.solve_cg_mg(s.state, B)
            compare_krylov(s.state, A, B, "(W) MGSolver(pcg) 1024^2 SPAI "
                           "V(2,2), 4 columns", mt.solve_cg_mg, {}, x, info,
                           ms2, card)
        s.clear()
    del A, B
    cfg, rp = mt.get_mg_param(levels=5, dtype=np.float32, relative_tol=1e-8,
                              max_outer_iter=100)
    b3 = rhs_of(L3)
    s = mt.MGSolver(cfg, rp, mesh=M3, krylov="pcg")
    b_l = dict(const3d.LAUNCHES, **fused3d.LAUNCHES)
    x, ms = timed(lambda: s.solve_linear_system(L3, b3))
    rr = true_relres(L3, b3, x)
    ab = {k: v - b_l[k] for k, v in dict(const3d.LAUNCHES,
                                          **fused3d.LAUNCHES).items()}
    log(f"[facade] (W-3d) MGSolver(pcg) 128^3 SPAI V(2,2): {s.n_iter} "
        f"iterations (want {FACADE['W-3d']} +- 1), true f64 relres "
        f"{rr:.3e}, {ms:.1f} ms incl. setup (host clock; {card}); kernels "
        f"A and B {ab}")
    require(abs(s.n_iter - FACADE["W-3d"]) <= 1, f"W-3d: {s.n_iter}")
    require(rr < 1e-8, f"W-3d: relres {rr:.3e}")
    require(ab["jacobi_residual3d"] > 0 and sum(ab.values()) > ab[
        "jacobi_residual3d"], f"W-3d: kernels A and B not both launched")
    x, info = mt.solve_cg_mg(s.state, b3)
    compare_krylov(s.state, L3, b3, "(W-3d) MGSolver(pcg) 128^3 SPAI V(2,2)",
                   mt.solve_cg_mg, {}, x, info, ms, card)
    s.clear()
    M, A = divsig((512, 512), seed=5)
    B = rhs_of(A, 4, seed=6)
    cfg, rp = mt.get_mg_param(levels=4, dtype=np.float32, relative_tol=1e-8,
                              max_outer_iter=100)
    for cls in (mt.SAAMGSolver, mt.ClassicalAMGSolver):
        want = FACADE["W-amg"][cls.__name__]
        s = cls(cfg, rp, krylov="pcg")
        X, ms = timed(lambda: s.solve_linear_system(A, B))
        per_col, rr = s.n_iter // 4, col_relres(A, B, X)
        log(f"[facade] (W-amg) {cls.__name__}(pcg) 512^2, 4 columns: "
            f"{per_col} iterations a column (want {want} +- 1), true f64 "
            f"relres <= {rr:.3e}, setup {s.time_setup:.2f} s, "
            f"{ms:.1f} ms incl. setup (host clock; {card})")
        require(abs(per_col - want) <= 1, f"W-amg {cls.__name__}: "
                f"{per_col}")
        require(rr < 1e-8, f"W-amg {cls.__name__}: relres {rr:.3e}")
        s.clear()


def facade_adjoint(card):
    """W-adj: MGSolver(sym=0) on the nonsymmetric 1024^2 operator: solve,
    adjoint solve (the hierarchy transposed), solve; the third x bitwise
    the first."""
    import mgtpu_torch as mt
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [1024, 1024])
    L = nodal_laplacian(M)
    n = L.shape[0]
    opn1 = abs(L).sum(axis=0).max()
    C = sp.diags([np.ones(n - 1)], [1], shape=(n, n)) * (0.05 * opn1 / 8)
    A = (L + 1e-3 * opn1 * sp.identity(n) + C).tocsr()
    b = rhs_of(A)
    cfg, rp = mt.get_mg_param(levels=6, max_outer_iter=20, relative_tol=1e-8,
                              relax_type="jacobi", relax_param=0.7,
                              nu_pre=1, nu_post=1, dtype=np.float32)
    s = mt.MGSolver(cfg, rp, mesh=M, sym=0, krylov="gmres", gmres_inner=10)
    xs = []
    for i, (tr, want) in enumerate(zip((False, True, False),
                                       FACADE["W-adj"])):
        before = s.n_iter
        x, ms = timed(lambda: s.solve_linear_system(A, b, transpose=tr))
        got = s.n_iter - before
        rr = true_relres(A.conj().T.tocsr() if tr else A, b, x)
        log(f"[facade] (W-adj) solve {i + 1} (transpose={tr}): {got} "
            f"restarts (want {want} +- 1), true f64 relres {rr:.3e}, "
            f"{ms:.1f} ms incl. setup or transposition (host clock; "
            f"{card}), {type(s.state.hier).__name__}")
        require(abs(got - want) <= 1, f"W-adj {i + 1}: {got} restarts")
        require(rr < 1e-6, f"W-adj {i + 1}: relres {rr:.3e}")
        xs.append(x)
    require(torch.equal(xs[0], xs[2]), "W-adj: the third solve is not "
            "bitwise the first (a stale recorded program?)")
    log("[facade] (W-adj) the third x is bitwise the first")
    s.clear()


def nodal_laplacian(M):
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    return nodal_laplacian_matrix(M)


def facade_replace(st2d, card):
    """R: bench.py:269-280 on the 2D path's state (1.7 L, L, 1.7 L, L),
    min seconds, CUDA memory after the fourth replace within 5 % of after
    the first, then refined Jacobi 16 +- 1; R-sigma: (f)'s Jacobi state
    replaced by sigma', solve_cg_mg, against a fresh setup."""
    import gc
    import mgtpu_torch as mt
    M, L, b, st = st2d
    L_alt = (1.7 * L).tocsr()
    secs, mem = [], []
    for A_new in (L_alt, L, L_alt, L):
        _, ms = timed(lambda: mt.replace_matrix_in_hierarchy(st, A_new))
        secs.append(ms / 1e3)
        gc.collect()
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
    log(f"[facade] (R) replace_matrix_in_hierarchy 1024^2, 6 levels: "
        f"min {min(secs):.3f} s of {[round(v, 3) for v in secs]} (host "
        f"clock, synchronised; {card}); CUDA memory after each "
        f"{[round(v / 2**20, 1) for v in mem]} MiB")
    require(mem[3] <= 1.05 * mem[0], f"R: memory grew {mem[0]} -> {mem[3]}")
    refined(st, L, b, FACADE["R"], "(R) 2D 1024^2 after four replaces, "
            "Jacobi 0.8 V(1,1)", card)
    M, A = divsig((1024, 1024))
    _, A2 = divsig((1024, 1024), seed=7)
    b2 = rhs_of(A2)
    cfg, rp = mt.get_mg_param(levels=6, relax_type="jacobi", relax_param=0.8,
                              nu_pre=1, nu_post=1, dtype=np.float32,
                              relative_tol=1e-8, max_outer_iter=100)
    st = mt.mg_setup(A, M, cfg, rp)
    _, ms = timed(lambda: mt.replace_matrix_in_hierarchy(st, A2))
    (x, info), ms_s = timed(lambda: mt.solve_cg_mg(st, b2))
    fresh = mt.mg_setup(A2, M, cfg, rp)
    (xf, info_f), _ = timed(lambda: mt.solve_cg_mg(fresh, b2))
    rr = true_relres(A2, b2, x)
    log(f"[facade] (R-sigma) (f)'s state replaced by sigma' in "
        f"{ms / 1e3:.2f} s: solve_cg_mg {int(info['iters'])} iterations "
        f"(a fresh setup {int(info_f['iters'])}, want {FACADE['R-sigma']} "
        f"+- 1), true f64 relres {rr:.3e}, {ms_s:.1f} ms (host clock; "
        f"{card})")
    require(int(info["iters"]) == int(info_f["iters"]), "R-sigma: the "
            "replaced and the fresh hierarchy differ")
    require(abs(int(info["iters"]) - FACADE["R-sigma"]) <= 1,
            f"R-sigma: {info['iters']}")
    require(rr < 1e-8, f"R-sigma: relres {rr:.3e}")


def facade_direct(st2d, card):
    """D: DirectSolver dense (on the card) and host on the 65^2 Laplacian
    + 1e-1 shift, all four value types, 1 and 5 right-hand sides, A and
    A^H; D-coarse and DD-coarse: the 2D operator with a DirectSolver and
    a DDSolver coarsest (the flat engine), refined."""
    import mgtpu_torch as mt
    from mgtpu_torch.cycle.coarse import DenseLU
    from mgtpu_torch.dd.schwarz import DDSolver
    Ls = nodal_laplacian(mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0],
                                             [64, 64]))
    A0 = (Ls + 1e-1 * abs(Ls).sum(axis=0).max() * sp.identity(Ls.shape[0])
          ).tocsr()
    for backend in ("dense", "host"):
        worst = 0.0
        for dtype, tol in DTYPES_TOL:
            A = A0.astype(dtype)
            if np.issubdtype(dtype, np.complexfloating):
                P = sp.random(*A.shape, density=0.001, random_state=2)
                A = (A + 1j * 0.1 * abs(A).sum() / A.nnz * (P - P.T)
                     ).tocsr().astype(dtype)
            ds = mt.DirectSolver(backend, dtype=dtype)
            for nrhs in (1, 5):
                bb = (A @ np.random.RandomState(nrhs).rand(A.shape[0], nrhs)
                      ).astype(dtype)
                bb = bb[:, 0] if nrhs == 1 else bb
                for tr in (False, True):
                    x = (ds.solve(bb, transpose=True) if tr
                         else ds.solve_linear_system(A, bb))
                    require(x.is_cuda == (backend == "dense"),
                            f"D {backend}: x on the wrong device")
                    Ax = A.conj().T if tr else A
                    err = float(np.abs(Ax @ x.cpu().numpy() - bb).max()
                                / np.abs(bb).max())
                    worst = max(worst, err / tol)
                    require(err < tol, f"D {backend} {np.dtype(dtype)} "
                            f"nrhs {nrhs} transpose {tr}: {err:.3e}")
            require(ds.n_fac == 1 and ds.n_solve == 4, f"D: counters "
                    f"{ds.n_fac} / {ds.n_solve}")
        log(f"[facade] (D) DirectSolver({backend}) 4225 dofs: f64, f32, "
            f"c128, c64, 1 and 5 right-hand sides, A and A^H within "
            f"test_solvers.py's DTYPES_TOL (worst {worst:.2e} of the "
            f"bound)")
    M, L, b, _ = st2d
    cfg, rp = mt.get_mg_param(levels=6, relax_type="jacobi", relax_param=0.8,
                              nu_pre=1, nu_post=1, dtype=np.float32)
    for key, coarse in (("D-coarse", mt.DirectSolver("dense")),
                        ("DD-coarse", DDSolver(None, [2, 2], [1, 1]))):
        st, ms = timed(lambda: mt.mg_setup(L, M, cfg, rp,
                                           coarse_solver=coarse))
        kinds = [type(lv.A).__name__ for lv in st.hier.levels]
        log(f"[facade] ({key}) setup {ms / 1e3:.2f} s (host clock), "
            f"{type(st.hier).__name__}, levels {kinds}, coarsest "
            f"{type(st.hier.coarse).__name__} of {st.As[-1].shape[0]} dofs")
        require(type(st.hier).__name__ == "Hierarchy" and kinds[0] == "DIA",
                f"{key}: want the flat engine with DIA levels")
        if key == "D-coarse":
            require(isinstance(st.hier.coarse, DenseLU), "D-coarse: want a "
                    "DenseLU coarsest")
        before = stencil_counters()[0]
        refined(st, L, b, FACADE[key], f"({key}) 2D 1024^2 Jacobi 0.8 "
                f"V(1,1), {type(coarse).__name__} coarsest", card, max_iter=60)
        d_l = {k: v - before[k] for k, v in stencil_counters()[0].items()}
        require(d_l["stencil.float32"] > 0, f"{key}: kernel D idle")
        del st


def facade_schur_dd(card):
    """S: the Schur solver on 64^2 mixed elasticity (dense inner to 1e-10
    with the counters; the Kaczmarz inner below 0.5 on kernel F); DD-256:
    DDSolver([8, 8], [2, 2]) under FGMRES(5), recorded against eager."""
    import mgtpu_torch as mt
    from mgtpu_torch.dd.schwarz import DDSolver
    from mgtpu_torch.solvers.schur import SchurComplementSolver
    from mgtpu_torch.models.operators import linear_elasticity_operator_mixed
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [64, 64])
    mu = np.ones(M.num_cells)
    A = linear_elasticity_operator_mixed(M, mu, 10.0 * mu)
    A = (A + 1e-3 * abs(A).sum(axis=0).max() * sp.identity(A.shape[0])
         ).tocsr()
    b = rhs_of(A)
    S = SchurComplementSolver(inner="dense")
    x, ms = timed(lambda: S.solve_linear_system(A, b, mesh=M))
    rr = true_relres(A, b, x)
    log(f"[facade] (S) SchurComplementSolver(dense) 64^2 mixed: true relres "
        f"{rr:.3e}, n_fac {S.n_fac}, n_solve {S.n_solve}, factor "
        f"{S.fac_time:.2f} s, {ms:.1f} ms with setup (host clock; {card})")
    require(rr < 1e-10 and S.n_fac == 1 and S.n_solve == 1, "S dense")
    f_before = kaczmarz_counters()[0]
    S2 = SchurComplementSolver(inner="kaczmarz", kaczmarz_opts={
        "num_domains": [2, 2], "omega": 0.8, "num_it": 2, "inner": 20})
    x, ms = timed(lambda: S2.solve_linear_system(A, b, mesh=M))
    rr = true_relres(A, b, x)
    f_l = {k: v - f_before[k] for k, v in kaczmarz_counters()[0].items()}
    log(f"[facade] (S) SchurComplementSolver(kaczmarz, 20 steps): true "
        f"relres {rr:.3e} (bound 0.5), {ms:.1f} ms with setup (host clock; "
        f"{card}); kernel F {f_l}")
    require(rr < 0.5 and f_l["kaczmarz.float64"] == 20, "S kaczmarz")
    Mdd, Ldd = shifted_laplacian((256, 256))
    Ldd = Ldd.astype(np.float64)
    bdd = rhs_of(Ldd)
    dd, ms_s = timed(lambda: DDSolver(Mdd, [8, 8], [2, 2],
                                      layout="nodal").setup(Ldd))
    (x, info), ms = timed(lambda: dd.solve_linear_system(
        Ldd, bdd, tol=1e-8, max_iter=200, restart=5))
    rr = true_relres(Ldd, bdd, x)
    k = dd.state.lu.shape[-1]
    log(f"[facade] (DD-256) DDSolver([8, 8], [2, 2]) 256^2: "
        f"{info['iters']} restarts (want {FACADE['DD-256']} +- 1), true f64 "
        f"relres {rr:.3e}; setup {ms_s / 1e3:.2f} s (64 blocks of {k}), "
        f"solve {ms:.1f} ms incl. recording (host clock; {card})")
    require(abs(info["iters"] - FACADE["DD-256"]) <= 1 and rr < 1e-8,
            f"DD-256: {info['iters']} restarts, relres {rr:.3e}")
    with uncounted():
        (x2, i2), ms2 = timed(lambda: dd.solve_linear_system(
            Ldd, bdd, tol=1e-8, max_iter=200, restart=5))
        (xe, ie), ms_e = timed(lambda: dd.solve_linear_system(
            Ldd, bdd, tol=1e-8, max_iter=200, restart=5, device_loop=False))
    require(torch.equal(x2, x) and i2["iters"] == info["iters"],
            "DD-256: two recorded runs differ")
    require(ie["iters"] == info["iters"], "DD-256: eager count differs")
    captured_row("(DD-256) DDSolver FGMRES(5) 256^2", info["iters"],
                 same_x("DD-256", x, xe), rr, ms, ms2, ms_e)


def eager_solve_mg(st, b):
    """solve_mg's loop with eager cycles (the recorded one's comparison)."""
    from mgtpu_torch.solvers.mg_solver import _norm, _runtime
    cfg = st.config
    to_field, to_flat, cycle, matvec = _runtime(st, captured=False)
    bv = to_field(torch.as_tensor(b, device="cuda")[:, None])
    xv = torch.zeros_like(bv)
    res0 = _norm(bv)
    it = 0
    for it in range(1, cfg.max_outer_iter + 1):
        xv = cycle(bv, xv)
        if _norm(bv - matvec(xv)) / res0 < cfg.relative_tol:
            break
    return to_flat(xv)[:, 0], it


def facade_kaczmarz(kmg, kprec, card):
    """K-mg (solve_mg through recorded cycles on kernel F, against the
    eager loop and one eager cycle bitwise) and K-prec (FGMRES with the
    Kaczmarz preconditioner)."""
    import mgtpu_torch as mt
    from mgtpu_torch.cycle.kaczmarz import make_kaczmarz_precond
    from mgtpu_torch.krylov import fgmres
    from mgtpu_torch.ops.ell import ell_from_scipy
    st, A, b = kmg
    f_before = kaczmarz_counters()[0]
    (x, info), ms = timed(lambda: mt.solve_mg(st, b))
    rr = true_relres(A, b, x)
    f_l = {k: v - f_before[k] for k, v in kaczmarz_counters()[0].items()}
    log(f"[facade] (K-mg) solve_mg 256^2 hybrid Kaczmarz: {info['iters']} "
        f"cycles (want {FACADE['K-mg']} +- 1), true f64 relres {rr:.3e}, "
        f"{ms:.1f} ms incl. recording (host clock; {card}); kernel F {f_l}")
    require(abs(info["iters"] - FACADE["K-mg"]) <= 1 and rr < 1e-8,
            f"K-mg: {info['iters']} cycles, relres {rr:.3e}")
    require(f_l["kaczmarz.float64"] > 0, "K-mg: kernel F idle")
    with uncounted():
        (x2, i2), ms2 = timed(lambda: mt.solve_mg(st, b))
        (xe, ie), ms_e = timed(lambda: eager_solve_mg(st, b))
    require(torch.equal(x2, x) and i2["iters"] == info["iters"],
            "K-mg: two recorded runs differ")
    require(ie == info["iters"], f"K-mg: eager loop {ie} cycles")
    captured_row("(K-mg) solve_mg 256^2 hybrid Kaczmarz", info["iters"],
                 same_x("K-mg", x, xe), rr, ms, ms2, ms_e,
                 cycle_pair(st, b, card))
    A2, kz = kprec
    B = A2 @ np.random.RandomState(4).rand(A2.shape[0], 2)
    B /= np.linalg.norm(B)
    E = ell_from_scipy(A2, device="cuda")
    prec = make_kaczmarz_precond(kz)
    f_before = kaczmarz_counters()[0]
    (X, info), ms = timed(lambda: fgmres(
        lambda v: E.matvec(v.T).T, torch.tensor(B.T.copy(), device="cuda"),
        restart=5, prec=lambda v: prec(v.T).T, tol=1e-10, max_iter=3))
    rr = float(np.linalg.norm(A2 @ X.T.cpu().numpy() - B)
               / np.linalg.norm(B))
    f_l = {k: v - f_before[k] for k, v in kaczmarz_counters()[0].items()}
    log(f"[facade] (K-prec) FGMRES(5) with Kaczmarz sweeps 256^2: "
        f"{info['iters']} restarts (want {FACADE['K-prec']} +- 1), relres "
        f"{rr:.3e}, {ms:.1f} ms incl. recording (host clock; {card}); "
        f"kernel F {f_l}")
    # the count is capped by max_iter=3, so the residual decides: below
    # FGMRES's tol, as mgtpu's 5.0e-11 is
    require(abs(info["iters"] - FACADE["K-prec"]) <= 1 and rr < 1e-10,
            f"K-prec: {info['iters']}, {rr:.3e}")
    require(f_l["kaczmarz.float64"] > 0, "K-prec: kernel F idle")


def facade_bf16_rd(L3, st_jac, card):
    """bf16: refined Jacobi on the 3D 128^3 path with bfloat16 cycles (the
    kernels' plain versions, counted); RD: mixed elasticity at 512^2
    re-discretized with coefficient coarsening, Vanka, refined.  Returns
    the bf16 solve's plain calls (left out of the window's check)."""
    import mgtpu_torch as mt
    from mgtpu_torch.models.operators import linear_elasticity_operator_mixed
    from mgtpu_torch.setup.transfers import restrict_cell_centered_variables
    b3 = rhs_of(L3)
    with uncounted():
        p_before = counters()[1]
    refined(st_jac, L3, b3, FACADE["bf16"], "(bf16) 3D 128^3 Jacobi 0.8 "
            "V(1,1), bfloat16 cycles", card, max_iter=60,
            kw=dict(cycle_dtype=torch.bfloat16), pair=False)
    plain = {k: v - p_before[k] for k, v in counters()[1].items()
             if v != p_before[k]}
    log(f"[facade] (bf16) plain calls of the kernels (bfloat16 is no "
        f"kernel's type): {plain}")
    require(plain.get("matvec", 0) > 0, "bf16: no counted plain call")
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [512, 512])
    mu0 = 1.0 + (np.arange(M.num_cells) % 4) * 0.25
    scale = {}

    def get_op(m, mu):
        A = linear_elasticity_operator_mixed(m, mu, mu)
        if "s" not in scale:
            scale["s"] = 1e-3 * abs(A).sum(axis=0).max()
        return A + scale["s"] * sp.identity(A.shape[0])

    ctor = mt.OperatorConstructor(
        mu0, get_op, lambda mf, mc, mu, lvl:
        restrict_cell_centered_variables(mu, list(mf.n)))
    cfg, rp = mt.get_mg_param(levels=6, relax_type="VankaFaces",
                              relax_param=0.75, nu_pre=1, nu_post=1,
                              dtype=np.float32,
                              transfer_type="SystemsFacesMixedLinear")
    st, ms = timed(lambda: mt.mg_setup(ctor, M, cfg, rp))
    A = get_op(M, mu0).tocsr()
    b = rhs_of(A)
    log(f"[facade] (RD) re-discretized setup {ms / 1e3:.2f} s (host clock),"
        f" {type(st.hier).__name__}, levels {[a.shape[0] for a in st.As]}")
    before = stencil_counters()[0]
    refined(st, A, b, FACADE["RD"], "(RD) 512^2 mixed elasticity "
            "re-discretized, VankaFaces 0.75 V(1,1)", card, max_iter=60)
    d_l = {k: v - before[k] for k, v in stencil_counters()[0].items()}
    require(d_l["stencil.float32"] > 0 and d_l["stencil.float64"] > 0,
            f"RD: kernel D {d_l}")
    return plain


def phase_facade(M3, L3, st_jac, st2d, kmg, kprec, card):
    """Every façade / direct / DD / Kaczmarz contract inside one
    launch-counter window: kernels A, B, D and F launched, no plain
    version (the bf16 row's counted plain calls left out).  Returns the
    window's kernel F launches."""
    t0 = time.perf_counter()
    reset_counters()                       # ---- main path window ----
    facade_wrappers(M3, L3, card)
    facade_adjoint(card)
    facade_replace(st2d, card)
    facade_direct(st2d, card)
    facade_schur_dd(card)
    facade_kaczmarz(kmg, kprec, card)
    bf16_plain = facade_bf16_rd(L3, st_jac, card)
    launches, plain = counters()           # ---- end of window ----
    d_l, d_p = stencil_counters()
    f_l, f_p = kaczmarz_counters()
    line_l, line_p = line_counters()
    e_l, e_p = vanka_counters()
    launches.update(d_l, **f_l)
    for k, v in bf16_plain.items():
        plain[k] -= v
    plain.update(d_p, **f_p, **line_p, **e_p)
    log(f"[facade] window launches: {launches}; other kernels "
        f"{dict(line_l, **e_l)}; E by form {form_counters()} "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"[facade] window plain-version calls on the card (the bf16 "
        f"row's left out): {plain}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    for k in ("jacobi_residual3d", "stencil.float32", "stencil.float64",
              "kaczmarz.float64"):
        require(launches[k] > 0, f"the window never launched {k}")
    return f_l


# ---------------------------------------------------------------------------
# complex hierarchies (phase 17)
# ---------------------------------------------------------------------------

# mgtpu's counts (scripts/complex_reference.py's rows): refined iterations,
# Krylov iterations or FGMRES(5) restarts, solve_mg cycles
COMPLEX = {"H-2d": 17, "H-bicg": 6, "H-gmres": 3, "H-K": 14, "H-3d": 23,
           "H-3d-bicg": 7, "H-3d-gmres": 3, "Z-sa": 20, "Z-cl": 10,
           "K-c": 18}
# Z-sa / Z-cl's level sizes and operator complexities: the port's host
# setup's at 512^2 (first read on the card; the host setup is held to
# mgtpu's bit for bit at 64^2, tests/test_torch_complex.py)
Z_LEVELS = {"Z-sa": ([263169, 50246, 10031, 2997], 1.9319),
            "Z-cl": ([263169, 131587, 49096, 22895], 2.6500)}


def helmholtz(dims, kh):
    """A = L - (1 - 0.5i) diag(k^2), k = (kh / h) / c, c =
    exp(0.2 RandomState(3).randn(n)): the heterogeneous shifted-Laplacian
    Helmholtz operator of scripts/complex_reference.py."""
    from mgtpu_torch import get_regular_mesh
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    M = get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    L = nodal_laplacian_matrix(M)
    c = np.exp(0.2 * np.random.RandomState(3).randn(L.shape[0]))
    return M, (L - (1 - 0.5j) * sp.diags((kh * dims[0] / c) ** 2)).tocsr()


def complex_setup(label, build, card):
    """A complex state, with its host seconds by stage: the operator, the
    hierarchy, the complex128 residual operator of the refined and Krylov
    solves."""
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    (st, A, M), stages = build()
    t0 = time.perf_counter()
    high_precision_fine_operator(st, np.complex128)
    stages["c128 residual operator"] = time.perf_counter() - t0
    lv = ([lvl.A.grid for lvl in st.hier.levels]
          if type(st.hier).__name__ == "GridHierarchy"
          else [a.shape[0] for a in st.As])
    log(f"[complex] ({label}) {type(st.hier).__name__} "
        f"{st.config.dtype.__name__}, "
        f"levels {lv}, coarsest {type(st.hier.coarse).__name__}, op. "
        f"complexity {st.operator_complexity():.4f}; host setup "
        + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
        + f" ({card})")
    return st, A


def complex_states(card):
    """H-2d (1024^2, kh 0.125, Jacobi 0.8 V(1,1), 5 levels), H-K (the same
    operator, Jac-GMRES K-cycles), H-3d (128^3), Z-sa / Z-cl (512^2
    complex-shifted rough DivSigGrad, SPAI V(2,2), 4 levels) in
    complex64, K-c (256^2, kh 0.25, hybrid Kaczmarz) in complex128."""
    import mgtpu_torch as mt
    from mgtpu_torch.dd.indices import nodal_indices_of_box

    def grid(dims, lv, **kw):
        def build():
            t0 = time.perf_counter()
            M, A = helmholtz(dims, 0.125)
            t1 = time.perf_counter()
            cfg, rp = mt.get_mg_param(levels=lv, nu_pre=1, nu_post=1,
                                      dtype=np.complex64, max_outer_iter=100,
                                      relative_tol=1e-8, **kw)
            st = mt.mg_setup(A, M, cfg, rp)
            return (st, A, M), {"operator": t1 - t0,
                                "mg_setup": time.perf_counter() - t1}
        return build

    def amg(setup):
        def build():
            t0 = time.perf_counter()
            M, A = divsig((512, 512), shift=1e-2 + 1e-2j, seed=5)
            t1 = time.perf_counter()
            cfg, rp = mt.get_mg_param(levels=4, relax_type="spai",
                                      dtype=np.complex64)
            st = setup(A, cfg, rp)
            return (st, A, M), {"operator": t1 - t0,
                                setup.__name__: time.perf_counter() - t1}
        return build

    def kc():
        t0 = time.perf_counter()
        M, A = helmholtz((256, 256), 0.25)
        t1 = time.perf_counter()
        cfg, _ = mt.get_mg_param(levels=4, relax_type="hybridKaczmarzNodal",
                                 nu_pre=1, nu_post=1, relative_tol=1e-8,
                                 max_outer_iter=60, dtype=np.complex128)
        rp = {"num_domains": [4, 4], "omega": 0.8, "num_it": 2,
              "index_fn": nodal_indices_of_box}
        st = mt.mg_setup(A, M, cfg, rp)
        return (st, A, M), {"operator": t1 - t0,
                            "mg_setup": time.perf_counter() - t1}

    jac = dict(relax_type="jacobi", relax_param=0.8)
    builds = {"H-2d": grid((1024, 1024), 5, **jac),
              "H-K": grid((1024, 1024), 5, relax_type="jac-gmres",
                          relax_param=1.0, cycle_type="K"),
              "H-3d": grid((128, 128, 128), 5, **jac),
              "Z-sa": amg(mt.sa_amg_setup),
              "Z-cl": amg(mt.classical_amg_setup),
              "K-c": kc}
    states = {k: complex_setup(k, b, card) for k, b in builds.items()}
    for key, (sizes, oc) in Z_LEVELS.items():
        st = states[key][0]
        got = [a.shape[0] for a in st.As]
        require(got == sizes and abs(st.operator_complexity() - oc) <= 0.01,
                f"{key}: levels {got}, op. complexity "
                f"{st.operator_complexity():.4f}; want {sizes}, {oc}")
    require(type(states["H-2d"][0].hier).__name__ == "GridHierarchy"
            and type(states["Z-sa"][0].hier.levels[0].A).__name__ == "DIA"
            and type(states["K-c"][0].hier).__name__ == "Hierarchy",
            "complex states: want the grid engine for H-*, DIA on Z-sa's "
            "fine level, the flat engine for K-c")
    return states


def sa_stride2(st, A, dtype):
    """The level-0 smoothed-aggregation prolongator of H-2d's operator
    (structured aggregates on its 1025^2 grid: 1025^2 -> 513^2, SPAI
    smoothing, as setup/sa_amg.py builds it), packed for kernel D."""
    from mgtpu_torch.ops.grid_stencil import stride2_transfer_from_scipy
    from mgtpu_torch.setup import smoothers as sm
    from mgtpu_torch.setup.sa_amg import _rho_estimate, structured_tentative_p
    nodes = [int(v) + 1 for v in np.asarray(st.meshes[0].n)]
    P0, nc = structured_tentative_p(nodes)
    DA = sp.diags(sm.spai_diag(A, 1.0)) @ A
    P = (P0 - (4.0 / 3.0) / _rho_estimate(DA) * (DA @ P0)).tocsr()
    return P, stride2_transfer_from_scipy(P, nodes, nc, dtype=dtype,
                                          device="cuda")


def phase_complex_kernels(states, rows, card):
    """Kernel D's complex64 / complex128 instantiations against their plain
    versions (2e-5 / 1e-12 relative to the plain version's largest entry):
    the apply on H-2d's 1025^2 and H-3d's 129^3 fine levels (m = 1, 2)
    and their complex128 residual operators, the stride-2 prolong and
    restrict between 1025^2 and 513^2 (H-2d's operator under structured
    SA; restrict = P^H), the DIA form on Z-sa's fine level and its
    complex128 residual operator; kernel F's complex128 and complex64 on
    K-c's fine level (m = 1, 2); then their times
    beside their bounds, plain versions and torch.sparse.mm."""
    from mgtpu_torch.ops.cuda import kaczmarz as kf
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    timer = Timer()
    cases = []
    for key in ("H-2d", "H-3d"):
        st, A = states[key]
        cases += [(f"({key}) fine", "grid", st.hier.levels[0].A, st.As[0]),
                  (f"({key}) c128 fine", "grid",
                   high_precision_fine_operator(st, np.complex128),
                   st.A_input)]
    st, A = states["H-2d"]
    for dt in (np.complex64, np.complex128):
        P, T = sa_stride2(st, A, dt)
        cases += [(f"(H-2d) SA prolong {np.dtype(dt).name}", "prolong", T, P),
                  (f"(H-2d) SA restrict {np.dtype(dt).name}", "restrict", T,
                   P.conj().T.tocsr())]
    st, A = states["Z-sa"]
    cases += [("(Z-sa) DIA fine", "dia", st.hier.levels[0].A, st.As[0]),
              ("(Z-sa) c128 DIA fine", "dia",
               high_precision_fine_operator(st, np.complex128), st.A_input)]
    for label, kind, op, csr in cases:
        dt = op.dtype
        for m in (1, 2):
            _, shape, run, plain_fn, *_ = d_case(kind, op, csr)
            rng = np.random.RandomState(SEED + m)
            shp = ((shape[0], m) if kind == "dia" else (m,) + shape[1:])
            x = torch.tensor(rng.rand(*shp) + 1j * rng.rand(*shp), dtype=dt,
                             device="cuda")
            check_d(rows, f"{label} m={m}", run(x), plain_fn(x))
        if kind in ("prolong", "restrict"):
            x = torch.tensor(np.random.RandomState(3).rand(*shape[1:]),
                             dtype=torch.complex128, device="cuda")
            y = run(x.to(dt)[None])[0].reshape(-1).to(torch.complex128)
            want = torch.tensor(csr.astype(np.complex128) @ x.cpu().numpy()
                                .reshape(-1), device="cuda")
            rel = float((y - want).abs().max() / want.abs().max())
            require(rel < (1e-5 if dt == torch.complex64 else 1e-12),
                    f"D {label}: {rel:.2e} from its CSR product")
        entry, _ = time_d(label, kind, op, csr, timer, card)
        name = f"stencil.{str(dt).split('.')[-1]}"
        rows[name].setdefault("times", {})[label] = entry
        if label in ("(H-2d) fine", "(H-2d) c128 fine"):
            rows[name].update(
                {k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "host_ms",
                                       "plan")},
                timed_shape=f"{label}: {entry['shape']} m=1",
                library_call="torch.sparse.mm(CSR, x)")
        log(f"[kernel] D {label}: {entry['shape']} {dt}: matches its plain "
            f"version, m = 1, 2")
    # kernel F on K-c's fine level
    st, A = states["K-c"]
    kz = st.hier.levels[0].relax
    row = rows["kaczmarz.complex128"]
    it = st.config.nu_pre[0] * kz.num_it
    for dt in (torch.complex128, torch.complex64):
        for m in (1, 2):
            scratch = {"max_abs_err": 0.0, "max_rel_err": 0.0}
            check_f(f"K-c fine {dt}", kz, dt, m, it,
                    row if dt == torch.complex128 else scratch, SEED + m,
                    complex_=True)
            log(f"[kernel] F K-c fine level {dt} m={m}: matches the plain "
                f"version; a second launch is bitwise the first")
    max_len, nd = kz.arr.shape
    n, K = kz.ell_idx.shape
    times = time_f("K-c fine level", kz, torch.complex128, it, card)
    tabs = f_tables(kz, torch.complex128)
    sets = [tuple(torch.tensor(np.random.RandomState(SEED + j + k).rand(n, 1)
                               + 0j, device="cuda") for k in (0, 9))
            for j in range(1)]
    plain_ms = loop_ms(lambda: kf.kaczmarz_sweep_plain(
        sets[0][0], sets[0][1], *tabs[:-1], it))
    log(f"[time] F plain version, K-c fine level: {plain_ms:.1f} ms; no "
        f"PyTorch call computes a Kaczmarz sweep ({card})")
    f_row(row, times, plain_ms,
          f"K-c fine level: {n} rows, {max_len} steps x {nd} domains, K "
          f"{K}, {it} sweeps, complex128, m=1")


def complex_krylov(st, A, b, label, fn, want, card, compare):
    """A Krylov contract: its count (mgtpu's +- 1) and a true complex128
    relres below 1e-8; with `compare`, held against its eager loop."""
    import mgtpu_torch
    solve = getattr(mgtpu_torch, fn)
    (x, info), wall = timed(lambda: solve(st, b))
    iters = int(info["iters"])
    rr = true_relres(A, b, x)
    log(f"[complex] ({label}) {fn}: {iters} (mgtpu {want}), true c128 "
        f"relres {rr:.3e}, time to 1e-8 {wall:.1f} ms (host clock; {card})")
    require(abs(iters - want) <= 1, f"{label}: {iters}, want {want} +- 1")
    require(rr < 1e-8, f"{label}: true relres {rr:.3e} >= 1e-8")
    if compare:
        compare_krylov(st, A, b, label, solve, {}, x, info, wall, card)


def phase_complex(states, card):
    """Every complex contract inside one launch-counter window, each to
    mgtpu's count +- 1 at a true complex128 relres below 1e-8 computed on
    the host: H-2d refined (held against its eager loop), H-bicg, H-gmres
    (held against its eager restarts), H-K, H-3d refined (held against its
    eager loop), H-3d-bicg, H-3d-gmres, Z-sa, Z-cl, K-c.  Kernel D
    launched in complex64 and complex128, kernel F in complex128, no plain
    version.  Returns the window's launches."""
    t0 = time.perf_counter()
    reset_counters()                       # ---- main path window ----
    for key in ("H-2d", "H-3d"):
        st, A = states[key]
        b = rhs_of(A)
        refined(st, A, b, COMPLEX[key], f"({key})", card, max_iter=60,
                compare=True)
        for suffix, fn in (("bicg", "solve_bicgstab_mg"),
                           ("gmres", "solve_gmres_mg")):
            lab = f"{key}-{suffix}".replace("H-2d-", "H-")
            complex_krylov(st, A, b, f"{lab}", fn, COMPLEX[lab], card,
                           compare=lab == "H-gmres")
    for key in ("H-K", "Z-sa", "Z-cl"):
        st, A = states[key]
        b = rhs_of(A, seed=6 if key.startswith("Z") else 4)
        refined(st, A, b, COMPLEX[key], f"({key})", card,
                max_iter=80 if key.startswith("Z") else 60, compare=False)
    st, A = states["K-c"]
    b = rhs_of(A)
    import mgtpu_torch
    (x, info), wall = timed(lambda: mgtpu_torch.solve_mg(st, b))
    rr = true_relres(A, b, x)
    log(f"[complex] (K-c) solve_mg: {info['iters']} cycles (mgtpu "
        f"{COMPLEX['K-c']}), true c128 relres {rr:.3e}, time to 1e-8 "
        f"{wall:.1f} ms (host clock; {card})")
    require(abs(info["iters"] - COMPLEX["K-c"]) <= 1 and rr < 1e-8,
            f"(K-c): {info['iters']} cycles, relres {rr:.3e}")
    d_l, d_p = stencil_counters()          # ---- end of window ----
    f_l, f_p = kaczmarz_counters()
    launches, plain = counters()
    line_l, line_p = line_counters()
    e_l, e_p = vanka_counters()
    launches.update(d_l, **f_l)
    plain.update(d_p, **f_p, **line_p, **e_p)
    log(f"[complex] window launches: {launches}; other kernels "
        f"{dict(line_l, **e_l)}; E by form {form_counters()} "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"[complex] window plain-version calls on the card: {plain}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    for k in ("stencil.complex64", "stencil.complex128",
              "kaczmarz.complex128"):
        require(launches[k] > 0, f"the complex window never launched {k}")
    return launches


# ---------------------------------------------------------------------------
# phase 18: the rest of complex — line relaxation, semicoarsening, the
# staggered-systems engine, device aggregation, a lower cycle type
# ---------------------------------------------------------------------------

REST = {
    # key: (label, mgtpu's refined count at full width on the CPU
    # (scripts/complex_rest_reference.py, JAX 0.9.0), max_iter)
    "CL-2d": ("(CL-2d) eps=100 shifted, kh 0.125, 1024^2, line Jacobi 0.8 "
              "V(1,1), 5 levels", 11, 60),
    "CL-3d": ("(CL-3d) 3D eps=50 on grid axis 0 shifted, kh 0.125, 128^3, "
              "line Jacobi 0.8 V(1,1), 5 levels", 11, 60),
    "CS-2d": ("(CS-2d) eps=0.01 shifted, kh 0.01, 1024^2, semicoarsening + "
              "line Jacobi 0.9 V(1,1), 7 levels", 6, 60),
    "CV-2d": ("(CV-2d) mixed elasticity + (1e-3 + 1e-3i), 1024^2, "
              "VankaFaces 0.75 V(1,1), 6 levels", 9, 60),
    "CE-2d": ("(CE-2d) elasticity + (1e-3 + 1e-3i), 1024^2, SPAI 0.75 "
              "V(2,2), 6 levels", 28, 60),
    "C-lex": ("(C-lex) CV-2d's operator at 64^2, VankaFacesLex 0.75 V(1,1), "
              "4 levels", 9, 60),
    "C-kacz": ("(C-kacz) the same, hybridVankaFacesKaczmarz 0.9 V(2,2), 4 "
               "levels", 18, 60),
    "Z-dev": ("(Z-dev) Z-sa's operator, 512^2, MIS-2 aggregation on the card "
              "(MGTPU_AGG=device), SPAI 1.0 V(2,2), 4 levels", 12, 80),
    "H-cd": ("(H-cd) H-2d in a complex128 hierarchy, complex64 cycles "
             "(cycle_dtype), 5 levels", 16, 60),
    # the complex128 instantiations of kernels C and E on a path: the same
    # rows in complex128 hierarchies, held to the complex64 rows' count
    "CL-2d-c128": ("(CL-2d-c128) CL-2d in a complex128 hierarchy", 11, 60),
    "C-lex-c128": ("(C-lex-c128) C-lex in a complex128 hierarchy", 9, 60),
}
Z_DEV_MGTPU = [263169, 69425, 18219, 7665]   # mgtpu's level sizes (CPU)
REST_ROWS = [f"{k}.{c}" for k in ("tridiag", "stencil_block", "vanka_lex")
             for c in ("complex64", "complex128")]


def cshift(A, kh, n):
    """A - (1 - 0.5i) diag(k^2), k = (kh n) / c, c = exp(0.2
    RandomState(3).randn(n_nodes)): the Helmholtz shift of
    scripts/complex_rest_reference.py."""
    c = np.exp(0.2 * np.random.RandomState(3).randn(A.shape[0]))
    return (A - (1 - 0.5j) * sp.diags((kh * n / c) ** 2)).tocsr()


def rest_problem(key):
    """(mesh, operator, get_mg_param keywords, b) of a phase-18 row."""
    z = 1e-3 + 1e-3j
    dt = np.complex128 if key.endswith("c128") else np.complex64
    line = dict(relax_type="line-jacobi", nu_pre=1, nu_post=1)
    if key.startswith("CL-2d"):
        M, A = aniso2d(1024, 100.0)
        return M, cshift(A, 0.125, 1024), dict(levels=5, relax_param=0.8,
                                               dtype=dt, **line)
    if key == "CL-3d":
        M, A = aniso3d([128] * 3, 0)
        return M, cshift(A, 0.125, 128), dict(levels=5, relax_param=0.8,
                                              dtype=dt, **line)
    if key == "CS-2d":
        M, A = aniso2d(1024, 0.01)
        return M, cshift(A, 0.01, 1024), dict(
            levels=7, relax_param=0.9, transfer_type="semicoarsening",
            dtype=dt, **line)
    if key in ("CV-2d", "CE-2d"):
        mixed = key == "CV-2d"
        M, A, _ = elasticity(2, 1024, mixed, shift=z)
        return M, A, dict(
            levels=6, relax_type="VankaFaces" if mixed else "SPAI",
            relax_param=0.75, nu_pre=1 if mixed else 2,
            nu_post=1 if mixed else 2, dtype=dt,
            transfer_type="SystemsFacesMixedLinear" if mixed
            else "SystemsFacesLinear")
    if key.startswith(("C-lex", "C-kacz")):
        M, A, _ = elasticity(2, 64, True, shift=z)
        lex = key.startswith("C-lex")
        return M, A, dict(
            levels=4, relax_type="VankaFacesLex" if lex
            else "hybridVankaFacesKaczmarz", relax_param=0.75 if lex else 0.9,
            nu_pre=1 if lex else 2, nu_post=1 if lex else 2, dtype=dt,
            transfer_type="SystemsFacesMixedLinear")
    if key == "Z-dev":
        M, A = divsig((512, 512), shift=1e-2 + 1e-2j, seed=5)
        return M, A, dict(levels=4, relax_type="spai", relax_param=1.0,
                          nu_pre=2, nu_post=2, dtype=dt)
    M, A = helmholtz((1024, 1024), 0.125)
    return M, A, dict(levels=5, relax_type="jacobi", relax_param=0.8,
                      nu_pre=1, nu_post=1, dtype=np.complex128)


def rest_states(card):
    """Every phase-18 row set up on the card (Z-dev's aggregation by the
    device loops), with its host seconds by stage and its complex128
    residual operator built once."""
    import os
    import mgtpu_torch as mt
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    states = {}
    for key in REST:
        t0 = time.perf_counter()
        M, A, kw = rest_problem(key)
        b = rhs_of(A, seed=6 if key == "Z-dev" else 4)
        t1 = time.perf_counter()
        cfg, rp = mt.get_mg_param(max_outer_iter=60, **kw)
        torch.cuda.synchronize()
        if key == "Z-dev":
            os.environ["MGTPU_AGG"] = "device"
            try:
                st = mt.sa_amg_setup(A, cfg, rp)
            finally:
                os.environ.pop("MGTPU_AGG", None)
        else:
            st = mt.mg_setup(A, M, cfg, rp)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        high_precision_fine_operator(st, np.complex128)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        sizes = [a.shape[0] for a in st.As]
        stages = ", ".join(f"{k} {v:.2f} s"
                           for k, v in st.setup_times.items())
        log(f"[rest] {REST[key][0]}: {A.shape[0]} unknowns, "
            f"{type(st.hier).__name__} {st.config.dtype.__name__}, levels "
            f"{sizes}; operator and b {t1 - t0:.2f} s, setup {t2 - t1:.2f} s"
            f" host clock ({stages}), c128 residual operator {t3 - t2:.2f} s"
            f" ({card})")
        if key == "Z-dev":
            log(f"[rest] (Z-dev) level sizes {sizes}: mgtpu's on the CPU "
                f"{Z_DEV_MGTPU} ({'equal' if sizes == Z_DEV_MGTPU else 'NOT equal'})")
        states[key] = (st, A, b)
    engines = {k: type(v[0].hier).__name__ for k, v in states.items()}
    want = {"CV-2d": "SystemsGridHierarchy", "CE-2d": "SystemsGridHierarchy",
            "C-lex": "Hierarchy", "C-kacz": "Hierarchy", "Z-dev": "Hierarchy",
            "CL-2d": "GridHierarchy", "CS-2d": "GridHierarchy"}
    require(all(engines[k] == v for k, v in want.items()),
            f"phase 18 engines {engines}, want {want}")
    return states


def rest_line_cases(states):
    """(label, LineRelax) of the fine-level lines of CL-2d (contiguous),
    CL-3d (strided, 129^3) and CS-2d (every level's axis), complex64 from
    the hierarchies and complex128 from CL-2d-c128 or widened."""
    from mgtpu_torch.cycle.relax import LineRelax
    out = []
    for key in ("CL-2d", "CL-3d", "CS-2d"):
        st = states[key][0]
        lvls = st.hier.levels[:-1] if key == "CS-2d" else st.hier.levels[:1]
        for l, lv in enumerate(lvls):
            lr = lv.line
            wide = LineRelax(*(getattr(lr, k).to(torch.complex128) for k in
                               ("alpha", "pivot", "cprime")), lr.axis,
                             lr.omega)
            lab = f"({key}) level {l} {tuple(lr.alpha.shape)} axis {lr.axis}"
            out += [(lab, lr), (lab, wide)]
    out.append(("(CL-2d-c128) level 0", states["CL-2d-c128"][0].hier
                .levels[0].line))
    return out


def phase_rest_kernels(states, rows, card):
    """Kernel C, kernel D's cross form and kernel E in complex64 and
    complex128 against their plain versions on the card at the phase's
    shapes: C (solve and correct, m = 1, 2; 2e-4 / 1e-10 relative) on
    CL-2d's contiguous, CL-3d's strided and every CS-2d level's lines; D's
    cross form (2e-5 / 1e-12) on every block of CV-2d's fine level and its
    complex128 residual operator, m = 1, 2; E (1e-5 / 1e-12, two sweeps)
    on every level of C-lex and C-lex-c128; D's block form (check_block)
    on every level of CV-2d and its complex128 residual operator.  Then
    their device times beside their bounds, plain versions and (D)
    torch.sparse.mm; the block form's (time_block) on CV-2d's fine level
    and its complex128 residual operator."""
    from mgtpu_torch.cycle.relax import LineRelax
    from mgtpu_torch.ops.cuda import stencil, tridiag, vanka
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    tols = {torch.complex64: 2e-4, torch.complex128: 1e-10}
    cases = rest_line_cases(states)
    for label, lr in cases:
        dt = lr.alpha.dtype
        row = rows[f"tridiag.{str(dt).split('.')[-1]}"]
        for m in (1, 2):
            rng = np.random.RandomState(SEED + m)
            shape = (m,) + tuple(lr.alpha.shape)
            r, x = (torch.tensor(rng.rand(*shape) + 1j * rng.rand(*shape),
                                 dtype=dt, device="cuda") for _ in range(2))
            for name in ("tridiag.solve", "tridiag.correct"):
                o = run_line(name, lr, r, x, plain=False)
                ref = run_line(name, lr, r, x, plain=True)
                torch.cuda.synchronize()
                require(o.shape == ref.shape and o.dtype == dt
                        and bool(torch.isfinite(o).all()),
                        f"C {label}: bad output")
                ae = float((o - ref).abs().max())
                re = ae / float(ref.abs().max())
                row["max_abs_err"] = max(row["max_abs_err"], ae)
                row["max_rel_err"] = max(row["max_rel_err"], re)
                require(re < tols[dt], f"kernel C {label} {name} m={m} "
                        f"{dt}: relative error {re:.3e} >= {tols[dt]}")
    log(f"[kernel] C complex: {len(cases)} line sets (CL-2d contiguous, "
        "CL-3d strided, every CS-2d level; complex64 and complex128) match "
        "the plain version in both modes, m = 1, 2")
    st = states["CV-2d"][0]
    hi = high_precision_fine_operator(st, np.complex128)
    fine = st.hier.levels[0].A
    nb = 0
    for (ci, cj), S, S128 in zip(fine.pairs, fine.stencils, hi.stencils):
        for S_ in (S, S128):
            for m in (1, 2):
                rng = np.random.RandomState(SEED + m)
                shape = (m,) + tuple(S_.in_grid)
                x = torch.tensor(rng.rand(*shape) + 1j * rng.rand(*shape),
                                 dtype=S_.coeff.dtype, device="cuda")
                y = stencil.cross_apply(S_.coeff, S_.offsets, S_.in_grid, x)
                check_d(rows, f"(CV-2d) block ({ci},{cj}) m={m}", y,
                        stencil.cross_apply_plain(S_.coeff, S_.offsets,
                                                  S_.in_grid, x),
                        "stencil_cross")
            nb += 1
    log(f"[kernel] D cross form complex: {nb} blocks of CV-2d's fine level "
        "(complex64) and its complex128 residual operator match the plain "
        "version, m = 1, 2")
    blocks = {f"(CV-2d) level {l}": lv.A
              for l, lv in enumerate(st.hier.levels)}
    blocks["(CV-2d) complex128 residual operator"] = hi
    for label, op in blocks.items():
        check_block(rows, label, op, stencil.cross_apply)
    log(f"[kernel] D block form complex: {len(blocks)} level operators of "
        "CV-2d (complex64) and its complex128 residual operator, apply and "
        "residual, m = 1, 2, 5, bitwise the per-block path, within 2e-5 / "
        "1e-12 of the plain version")
    lex = []
    for key in ("C-lex", "C-lex-c128"):
        st = states[key][0]
        for l in range(len(st.hier.levels) - 1):
            lex.append((f"({key}) level {l}", st.As[l].shape[0],
                        lex_tables(st, l)))
    for label, n, tabs in lex:
        dt = tabs[3].dtype
        row = rows[f"vanka_lex.{str(dt).split('.')[-1]}"]
        forms = check_e(label, n, tabs, row, SEED + n, complex_=True)
        log(f"[kernel] E {label} {dt}: forms {forms} match the per-cell "
            f"loop and one another bitwise")
    log(f"[kernel] E complex: {len(lex)} levels of C-lex (complex64) and "
        "C-lex-c128 match the per-cell loop, two sweeps, every form")

    # times: C correct on CL-2d's fine lines (and the strided shapes), D's
    # cross form on CV-2d's fine (0, 2) block, E one sweep of C-lex's fine
    timer = Timer()
    for label, lr in cases:
        if "level 0" not in label:
            continue
        dt = lr.alpha.dtype
        key = str(dt).split(".")[-1]
        item = torch.empty((), dtype=dt).element_size()
        nodes = lr.alpha.numel()
        sets = [(LineRelax(lr.alpha.clone(), lr.pivot.clone(),
                           lr.cprime.clone(), lr.axis, lr.omega),
                 *(torch.tensor(np.random.RandomState(SEED + 10 + j).rand(
                     1, *lr.alpha.shape) + 0.5j, dtype=dt, device="cuda")
                   for _ in range(2))) for j in range(4)]
        name = "tridiag.correct"
        ms, host_ms = timer([lambda s=s: run_line(name, *s, False)
                             for s in sets])
        plain_ms, _ = timer([lambda s=s: run_line(name, *s, True)
                             for s in sets])
        # r, x, out and three coefficients; 26 real flops a node
        fbytes = 6 * item * nodes
        flops = 26 * nodes
        peak = FP32_FLOPS if dt == torch.complex64 else FP64_FLOPS
        bound = max(fbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
        grid = tuple(lr.alpha.shape)
        inner = int(np.prod(grid[lr.axis + 1:]))
        plan = tridiag.line_plan(nodes // (grid[lr.axis] * inner),
                                 grid[lr.axis], inner, item, "correct")
        log(f"[time] C {label} ({'contiguous' if inner == 1 else 'strided'})"
            f" {dt} correct: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {bound:.4f} ms ({fbytes / 1e6:.1f} MB)  kernel/bound "
            f"{ms / bound:.1f}x  host per call {host_ms:.3f} ms  plan "
            f"{tuple(plan)} ({card})")
        row = rows[f"tridiag.{key}"]
        row.setdefault("times", {})[label] = dict(ms=ms, plain_ms=plain_ms,
                                                  bound_ms=bound)
        if label.startswith("(CL-2d)") or (label.startswith("(CL-2d-c128)")
                                           and "ms" not in row):
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by="bytes" if fbytes / HBM_BYTES_PER_S
                       >= flops / peak else "operations", library_ms=None,
                       library_call="none: no PyTorch call solves "
                       "tridiagonal lines", host_ms=host_ms, plan=tuple(plan),
                       timed_shape=f"{label}, correct, m=1")
    for S_, tag in ((fine.stencils[fine.pairs.index((0, 2))], "complex64"),
                    (hi.stencils[fine.pairs.index((0, 2))], "complex128")):
        label = f"(CV-2d) fine block (0,2) {tag}"
        entry, _ = time_d(label, "cross", S_, S_.to_scipy(), timer, card)
        rows[f"stencil_cross.{tag}"].update(
            {k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "host_ms", "plan")},
            timed_shape=f"{label}: {entry['shape']} m=1",
            library_call="torch.sparse.mm(CSR, x)")
    for label in ("(CV-2d) level 0", "(CV-2d) complex128 residual operator"):
        entry = time_block(label, blocks[label], states["CV-2d"][1], timer,
                           card)
        rows[f"stencil_block.{str(blocks[label].dtype).split('.')[-1]}"
             ].setdefault("times", {})[label] = entry
        block_row(rows, blocks[label].dtype, label, entry)
    for key in ("C-lex", "C-lex-c128"):
        st = states[key][0]
        tabs = lex_tables(st, 0)
        dt = tabs[3].dtype
        n = st.As[0].shape[0]
        L, bs = tabs[0].shape
        K = tabs[2].shape[-1]
        times = time_e(f"({key}) 64^2 fine level", n, tabs, card)
        sets = [tuple(torch.tensor(np.random.RandomState(SEED + j + k).rand(
            n, 1) + 0.5j, dtype=dt, device="cuda") for k in (0, 9))
            for j in range(1)]
        plain_ms = loop_ms(lambda: vanka.lex_sweep_plain(
            sets[0][0], sets[0][1], *tabs, 1))
        log(f"[time] E plain version, ({key}) 64^2 fine level: "
            f"{plain_ms:.1f} ms ({card})")
        key_row = f"vanka_lex.{str(dt).split('.')[-1]}"
        e_row(rows[key_row], times, plain_ms, f"{key} 64^2 fine "
              f"level: {L} cells, bs {bs}, K {K}, m=1, one sweep")


def phase_rest(states, card):
    """Every phase-18 row inside one launch-counter window, each to
    mgtpu's count +- 1 at a true complex128 relres below 1e-8 computed on
    the host, each held against its eager run (the captured phase):
    kernel C in complex64 (line rows) and complex128 (CL-2d-c128), kernel
    D's cross form in complex64 and complex128 (the systems rows' cycles
    and residuals), kernel E in complex64 (C-lex) and complex128 (C-lex
    c128); no plain version.  Returns the window's launches."""
    from mgtpu_torch.ops.cuda import stencil
    t0 = time.perf_counter()
    reset_counters()                       # ---- main path window ----
    for key, (label, want, max_iter) in REST.items():
        st, A, b = states[key]
        kw = {"cycle_dtype": torch.complex64} if key == "H-cd" else None
        refined(st, A, b, want, label, card, max_iter=max_iter, compare=True,
                kw=kw)
    line_l, line_p = line_counters()       # ---- end of window ----
    d_l, d_p = stencil_counters()
    e_l, e_p = vanka_counters()
    f_l, f_p = kaczmarz_counters()
    launches, plain = counters()
    launches.update(line_l, **d_l, **e_l, **f_l)
    plain.update(line_p, **d_p, **e_p, **f_p)
    for c in ("complex64", "complex128"):
        launches[f"stencil_block.{c}"] = stencil.BLOCK_LAUNCHES[c]
        launches[f"stencil_cross.{c}"] = stencil.CROSS_LAUNCHES[c]
        launches[f"vanka_lex.{c}"] = launches[f"vanka.{c}"]
    log(f"[rest] window launches: {launches}; E by form "
        f"{form_counters()} ({time.perf_counter() - t0:.1f} s)")
    log(f"[rest] window plain-version calls on the card: {plain}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    for k in REST_ROWS + ["stencil.complex64", "stencil.complex128"]:
        require(launches[k] > 0, f"the phase-18 window never launched {k}")
    # the systems rows' levels run the block form, no block alone
    require(not any(stencil.CROSS_LAUNCHES.values()), "the phase-18 window "
            f"launched kernel D's cross form: {stencil.CROSS_LAUNCHES}")
    return launches


# ---------------------------------------------------------------------------
# phase 19: the multi-device grid tier (parallel/, dd/parallel.py)
# ---------------------------------------------------------------------------

# ROADMAP's multi-device contracts: count wanted (+- 1) at a true f64
# relres below 1e-8; MS-2d is 20 slab cycles and holds its norms instead
MULTI = {"MG-2d": 16, "MG-pen": 16, "MG-3d": 23, "MG-cg": 19,
         "MG-bicg": 12, "DD-par": 6}
MULTI_DEADLINE_S = 300.0       # a rank group past this fails the phase
EPS32 = 2.0 ** -24
N2, N3, NDD = 1024, 128, 256   # cells a side: MS/MG-2d and (f), MG-3d, DD
LEVELS2, LEVELS3 = 6, 5
MS_AT = (1, 10, 20)            # MS-2d's cycles whose x is held


def halo_case(coeff, offsets, shift):
    """A block's coefficients (nd, *out_grid) as the CrossGridStencil of its
    halo apply: the taps shifted by `shift` planes along each axis (1 along
    a sharded axis, 0 along another), the input the block with that many
    planes each side."""
    from mgtpu_torch.ops.cross_stencil import CrossGridStencil
    out_grid = tuple(int(g) for g in coeff.shape[1:])
    in_grid = tuple(g + 2 * s for g, s in zip(out_grid, shift))
    taps = tuple(tuple(int(d) + s for d, s in zip(off, shift))
                 for off in offsets)
    return CrossGridStencil(coeff.contiguous().to("cuda"), taps, out_grid,
                            in_grid)


def _block(coeff, divs, index):
    """The block `index` (one per grid axis) of a padded coefficient array
    (nd, *grid) split `divs` ways along each axis."""
    coeff = torch.as_tensor(coeff)
    return coeff[(slice(None),) + tuple(
        slice(i * (g // d), (i + 1) * (g // d))
        for g, d, i in zip(coeff.shape[1:], divs, index))]


def halo_cases(L2, L3):
    """Kernel D's halo apply at the shapes phase 19 gives it, f32 and f64,
    each the block of rank 1 of the 4-rank slab or rank (1, 1) of the
    2 x 2 pencil: MS-2d's fine slab (288 of the 1152 padded rows of 1025^2,
    5 taps); MG-2d's fine block (257 of 1028 rows; f64 is its refined
    residual's operator) and its 9-tap Galerkin level 1 (129 x 513); MG-pen's
    fine block (513 x 513) and level 1 (257 x 257), both shifted along both
    axes, which carries the corners; MG-3d's fine block (33 of 132 planes
    of 129^3, 7 taps).  The MG levels come from the padded hierarchy of
    mgtpu_torch.parallel.grid_sharded, as on the ranks."""
    from mgtpu_torch import get_mg_param, get_regular_mesh, mg_setup
    from mgtpu_torch.ops.grid_stencil import grid_stencil_from_csr
    from mgtpu_torch.parallel.grid_sharded import _pad_to, pad_grid_hierarchy
    from mgtpu_torch.parallel.sharded import slab_sizes
    from mgtpu_torch.parallel.stencil import stencil_from_banded
    n2, n3 = N2 + 1, N3 + 1
    S = slab_sizes([N2 // 2 ** l + 1 for l in range(LEVELS2)], 4)[0]
    B = -(-n3 // 4)
    st2 = mg_setup(L2, get_regular_mesh([0.0, 1.0] * 2, [N2, N2]),
                   *get_mg_param(levels=LEVELS2, relax_type="jacobi",
                                 relax_param=0.8, nu_pre=1, nu_post=1,
                                 dtype=np.float32), device="cpu")
    layouts = [(row, divs, index, pad_grid_hierarchy(st2.hier, divs))
               for row, divs, index in (("MG-2d", (4, 1), (1, 0)),
                                        ("MG-pen", (2, 2), (1, 1)))]
    f64 = grid_stencil_from_csr(L2, [n2, n2], dtype=np.float64)
    out = []
    for dt in (np.float32, np.float64):
        tdt = torch.float32 if dt == np.float32 else torch.float64
        sl = stencil_from_banded(L2, [n2, n2], 0.8, dtype=dt)
        c = np.pad(sl.coeff, ((0, 0), (0, 4 * S - n2), (0, 0)))
        out.append((f"MS-2d fine slab {S} x {n2}", halo_case(
            _block(c, (4, 1), (1, 0)), tuple(zip(sl.dj, sl.di)), (1, 0))))
        for row, divs, index, gh in layouts:
            A0, A1 = gh.levels[0].A, gh.levels[1].A
            ops = [(A0.coeff, A0.offsets), (A1.coeff, A1.offsets)]
            if dt == np.float64:        # the refined residual's operator
                ops[0] = (_pad_to(torch.as_tensor(f64.coeff), A0.grid,
                                  (1, 2)), f64.offsets)
            for l, (coeff, offsets) in enumerate(ops):
                blk = _block(coeff, divs, index).to(tdt)
                out.append((f"{row} level {l} block "
                            f"{blk.shape[1]} x {blk.shape[2]}, "
                            f"{len(offsets)} taps",
                            halo_case(blk, offsets, index)))
        gs = grid_stencil_from_csr(L3, [n3] * 3, dtype=dt)
        c = np.pad(gs.coeff, ((0, 0), (0, 4 * B - n3), (0, 0), (0, 0)))
        out.append((f"MG-3d fine block {B} x {n3} x {n3}", halo_case(
            _block(c, (4, 1, 1), (1, 0, 0)), gs.offsets, (1, 0, 0))))
    return out


def halo_form_case(op):
    """A halo case in the halo form's terms: (axis, width, taps).  The
    halo axis is the last one the case extends (the pencil's first axis
    stays catted, as on the ranks); the taps are unshifted along it."""
    shift = [(i - o) // 2 for i, o in zip(op.in_grid, op.out_grid)]
    h = max(a for a, v in enumerate(shift) if v)
    taps = tuple(tuple(v - (shift[h] if a == h else 0)
                       for a, v in enumerate(off)) for off in op.offsets)
    return h, shift[h], taps


def halo_split(x, h, w, live=(True, True)):
    """The extended input x (m, *in_grid) cut along axis h into (left,
    owned, right) pieces of the halo form, a piece None where `live` says
    there is no neighbour, and the old path's extended block (zero planes
    there)."""
    dim, n = 1 + h, x.shape[1 + h]
    own = x.narrow(dim, w, n - 2 * w).contiguous()
    left = x.narrow(dim, 0, w).contiguous() if live[0] else None
    right = x.narrow(dim, n - w, w).contiguous() if live[1] else None
    zero = torch.zeros_like(own.narrow(dim, 0, w))
    xe = torch.cat([zero if left is None else left, own,
                    zero if right is None else right], dim=dim)
    return left, own, right, xe


def check_halo_form(rows, label, op):
    """Kernel D's halo form on a halo case: apply, residual and, where the
    output is the owned block, the Jacobi update, m = 1, 2, 5, with random
    neighbour planes, with one end's zeros and with both: bit for bit the
    old path (the planes catted, halo_apply, torch's b - y or x + d (b -
    y)); with live planes within 2e-5 / 1e-12 of its plain version (the
    row stencil_halo_form.<type> keeps the largest errors) and, radius 1,
    the overlapped slab's two launches (interior rows, then both edge rows
    into the same tensor) bitwise the whole."""
    from mgtpu_torch.ops.cuda import stencil
    h, w, taps = halo_form_case(op)
    dt = op.coeff.dtype
    own_grid = tuple(g - (2 * w if a == h else 0)
                     for a, g in enumerate(op.in_grid))
    jac = own_grid == tuple(op.out_grid)
    n = op.out_grid[h]
    for m in (1, 2, 5):
        rng = np.random.RandomState(SEED + 40 + m)
        t = lambda *shape: torch.tensor(rng.rand(*shape), dtype=dt,
                                        device="cuda")
        x, b = t(m, *op.in_grid), t(m, *op.out_grid)
        d = t(*op.out_grid) if jac else None
        forms = [("apply", None, None), ("residual", b, None)]
        forms += [("jacobi", b, d)] if jac else []
        for live in ((True, True), (False, True), (False, False)):
            left, own, right, xe = halo_split(x, h, w, live)
            y = stencil.halo_apply(op.coeff, op.offsets, op.in_grid, xe)
            for form, bb, dd in forms:
                old = (y if bb is None else bb - y if dd is None
                       else own + dd * (bb - y))
                new = stencil.halo_stencil(op.coeff, taps, own, left, right,
                                           h, b=bb, d=dd)
                torch.cuda.synchronize()
                require(torch.equal(new, old), f"halo form {form} {label} "
                        f"m={m} planes {live}: not bitwise the old path")
                if live != (True, True):
                    continue
                check_d(rows, f"halo form {form} {label} m={m}", new,
                        stencil.halo_stencil_plain(op.coeff, taps, own, left,
                                                   right, h, b=bb, d=dd),
                        "stencil_halo_form")
                if w == 1 and n > 2:
                    part = stencil.halo_stencil(
                        op.coeff, taps, own, None, None, h, b=bb, d=dd,
                        rows=(1, n - 1, n - 1, n - 1))
                    part = stencil.halo_stencil(
                        op.coeff, taps, own, left, right, h, b=bb, d=dd,
                        rows=(0, 1, n - 1, n), out=part)
                    torch.cuda.synchronize()
                    require(torch.equal(part, old), f"halo form {form} "
                            f"{label} m={m}: interior and edge rows not "
                            "bitwise the whole")
    log(f"[kernel] D halo form, {label}, {dt}: apply, residual"
        f"{', jacobi' if jac else ''} bit for bit the old path (cat, "
        "halo_apply, torch) with live planes, one end's zeros and both, "
        "m = 1, 2, 5; interior + edge rows bitwise the whole; within "
        f"{D_TOLS[dt]:.0e} of its plain version")


def time_halo_form(label, op, timer, card):
    """Kernel D's halo form, the residual b - A x of a rank's block (m = 1,
    four input sets, live planes): its device time by CUDA events and in a
    CUDA graph, beside its least time (the coefficients, the owned block and
    its planes once, b read and r written), the old path it replaces
    (the planes catted, halo_apply, torch's b - y), its plain version and
    b - torch.sparse.mm of the block's CSR on the extended block."""
    from mgtpu_torch.ops.cuda import stencil
    h, w, taps = halo_form_case(op)
    dt = op.coeff.dtype
    item = torch.empty((), dtype=dt).element_size()
    sets = []
    for j in range(4):
        rng = np.random.RandomState(SEED + 60 + j)
        x = torch.tensor(rng.rand(1, *op.in_grid), dtype=dt, device="cuda")
        b = torch.tensor(rng.rand(1, *op.out_grid), dtype=dt, device="cuda")
        left, own, right, _ = halo_split(x, h, w)
        sets.append((own, left, right, b, x.reshape(-1, 1),
                     b.reshape(-1, 1)))
    calls = lambda fn: [lambda s=s: fn(*s[:4]) for s in sets]
    new = lambda own, left, right, b: stencil.halo_stencil(
        op.coeff, taps, own, left, right, h, b=b)
    old = lambda own, left, right, b: b - stencil.halo_apply(
        op.coeff, op.offsets, op.in_grid,
        torch.cat([left, own, right], dim=1 + h))
    plain = lambda own, left, right, b: stencil.halo_stencil_plain(
        op.coeff, taps, own, left, right, h, b=b)
    ms, host_ms = timer(calls(new))
    g_ms = graph_ms(calls(new))
    no, nd = int(np.prod(op.out_grid)), len(taps)
    plan = stencil.halo_plan(box3(op.out_grid), no, nd, 1, dt)
    old_ms, old_host_ms = timer(calls(old))
    old_g_ms = graph_ms(calls(old))
    plain_ms = timer(calls(plain))[0]
    Tm = sparse_mm_yardstick(op.to_scipy(), dt)
    lib_ms = timer([lambda s=s: s[5] - torch.sparse.mm(Tm, s[4])
                    for s in sets])[0]
    ni = int(np.prod(op.in_grid))
    fbytes = (nd * no + ni + 2 * no) * item
    flops = 2 * nd * no + no
    peak = FP32_FLOPS if dt == torch.float32 else FP64_FLOPS
    bound = max(fbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
    log(f"[time] D halo form {label} {dt} residual: kernel {ms:.4f} ms "
        f"(graph {g_ms:.4f}; plan split {plan.split} blocks "
        f"{plan.blocks})  "
        f"old path {old_ms:.4f} ms (graph {old_g_ms:.4f}: cat, halo_apply, "
        f"b - y)  plain {plain_ms:.4f} ms  sparse.mm + b - y {lib_ms:.4f} ms"
        f"  bound {bound:.4f} ms ({fbytes / 1e6:.2f} MB)  kernel/bound "
        f"{ms / bound:.1f}x  host per call {host_ms:.3f} ms (old "
        f"{old_host_ms:.3f})  {op.in_grid} -> {op.out_grid} nd={nd} "
        f"({card})")
    return dict(shape=f"{op.in_grid} -> {op.out_grid} nd={nd}", ms=ms,
                graph_ms=g_ms, plan=plan._asdict(),
                old_path_ms=old_ms, old_path_graph_ms=old_g_ms,
                old_path_host_ms=old_host_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, host_ms=host_ms,
                bound_by="bytes" if fbytes / HBM_BYTES_PER_S >= flops / peak
                else "operations")


def phase_halo_kernels(L2, L3, rows, card):
    """Kernel D's halo apply (the cross form on the extended block) against
    its plain version (m = 1, 2; f32 2e-5, f64 1e-12) on every block of
    `halo_cases`, then its device time there beside its byte bound, the
    plain version and torch.sparse.mm of the block's CSR; kernel D's halo
    form on every block (`check_halo_form`), and its residual's device
    time on MS-2d's slab and MG-3d's block (`time_halo_form`)."""
    from mgtpu_torch.ops.cuda import stencil
    timer = Timer()
    for label, op in halo_cases(L2, L3):
        for m in (1, 2):
            x = torch.tensor(np.random.RandomState(SEED + m).rand(
                m, *op.in_grid), dtype=op.coeff.dtype, device="cuda")
            check_d(rows, f"halo {label} m={m}",
                    stencil.halo_apply(op.coeff, op.offsets, op.in_grid, x),
                    stencil.cross_apply_plain(op.coeff, op.offsets,
                                              op.in_grid, x), "stencil_halo")
        log(f"[kernel] D halo apply, {label}, {op.in_grid} -> "
            f"{op.out_grid}, {len(op.offsets)} taps, {op.coeff.dtype}: "
            "matches its plain version, m = 1, 2")
        check_halo_form(rows, label, op)
        entry, _ = time_d(f"halo {label}", "halo", op, op.to_scipy(),
                          timer, card)
        dt = str(op.coeff.dtype).split('.')[-1]
        rows[f"stencil_halo.{dt}"].setdefault("times", {})[label] = entry
        if label.startswith("MS-2d"):
            rows[f"stencil_halo.{dt}"].update(
                {k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "host_ms",
                                       "plan")},
                timed_shape=f"{label}: {entry['shape']} m=1",
                library_call="torch.sparse.mm(CSR, x)")
        if not label.startswith(("MS-2d", "MG-3d")):
            continue
        entry = time_halo_form(label, op, timer, card)
        row = rows[f"stencil_halo_form.{dt}"]
        row.setdefault("times", {})[label] = entry
        if label.startswith("MS-2d"):
            row.update({k: entry[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "host_ms", "old_path_ms", "graph_ms", "plan")},
                timed_shape=f"{label}: {entry['shape']}, residual, m=1",
                library_call="b - torch.sparse.mm(CSR, x)",
                ptxas=ptxas("halo_stencil", "halo_kernel"))


def device_ops_note(ops) -> str:
    """`cycle_kernels`'s result in a log line."""
    if ops is None:
        return "not measured (taken on 1 rank only)"
    return (f"{ops['ops']} ({ops['copies']} copies), {ops['device_ms']:.3f} "
            f"ms of device time, most {ops['most'][:3]}")


def cycle_kernels(fn, device):
    """Device operations of one call of `fn` by torch.profiler: kernels
    and copies (count, by name) and their device ms; None when the
    profiler saw no device events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    if not ev:
        return None
    copies = sum(e.count for e in ev if e.key.startswith(("Memcpy",
                                                          "Memset")))
    top = sorted(ev, key=lambda e: -e.count)[:6]
    return dict(ops=int(sum(e.count for e in ev)), copies=int(copies),
                device_ms=sum(e.self_device_time_total for e in ev) / 1e3,
                most=[(e.key[:60], int(e.count)) for e in top])


def multi_rank(rank, world, device, transport):
    """Phase 19 on one rank (spawned by mgtpu_torch/parallel/launch.py):
    the host setups and the sharded states, the overlapped slab apply held
    bitwise against the fused one, then every row inside one window of
    kernel D's counters.  Returns each row's count, times (host clock,
    synchronised), bytes a cycle by collective kind and kernel D launches;
    rank 0 also its x."""
    from mgtpu_torch import get_mg_param, mg_setup
    from mgtpu_torch.dd.parallel import dd_parallel_preconditioner
    from mgtpu_torch.dd.schwarz import DDSolver
    from mgtpu_torch.krylov import fgmres
    from mgtpu_torch.ops.cuda import stencil as sk
    from mgtpu_torch.ops.ell import ell_from_scipy
    from mgtpu_torch.parallel import stencil as ps
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.sharded import make_sharded_solver
    from mgtpu_torch.parallel.sharded_solve import ShardedGridSolver
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    comm = RankGrid(None, transport)
    pencil = RankGrid((2, 2), transport) if world == 4 else None
    jac = dict(relax_type="jacobi", relax_param=0.8, nu_pre=1, nu_post=1,
               dtype=np.float32)
    M2, L2 = shifted_laplacian((N2, N2))
    st2 = mg_setup(L2, M2, *get_mg_param(levels=LEVELS2, max_outer_iter=20,
                                         relative_tol=1e-6, **jac),
                   device="cpu")
    M3, L3 = shifted_laplacian((N3, N3, N3))
    st3 = mg_setup(L3, M3, *get_mg_param(levels=LEVELS3, **jac),
                   device="cpu")
    Mf, Af = divsig((N2, N2))
    stf = mg_setup(Af, Mf, *get_mg_param(levels=LEVELS2, max_outer_iter=100,
                                         relative_tol=1e-8, **jac),
                   device="cpu")
    Mdd, Ldd = shifted_laplacian((NDD, NDD))
    Ldd = Ldd.astype(np.float64)
    dd = DDSolver(Mdd, [8, 8], [2, 2], layout="nodal",
                  device=device).setup(Ldd)
    slab = make_sharded_solver(st2, comm, device=device)
    solvers = {"MG-2d": ShardedGridSolver(st2, comm, (0,), device),
               "MG-3d": ShardedGridSolver(st3, comm, (0,), device),
               "MG-cg": ShardedGridSolver(stf, comm, (0,), device)}
    if pencil is not None:
        solvers["MG-pen"] = ShardedGridSolver(st2, pencil, (0, 1), device)
    prec = dd_parallel_preconditioner(dd, comm, device)
    ell = ell_from_scipy(Ldd, dtype=np.float64, device=device)
    b2 = L2 @ np.random.RandomState(SEED).rand(L2.shape[0])
    b2 /= np.linalg.norm(b2)
    b3 = L3 @ np.random.RandomState(SEED).rand(L3.shape[0])
    b3 /= np.linalg.norm(b3)
    bf, bdd = rhs_of(Af), rhs_of(Ldd)
    # the overlapped slab apply (kernel D's halo form: interior rows, then
    # both edge rows) against the fused one (the extended slab, the cross
    # form), on real halos; its residual and Jacobi update against the
    # fused apply and torch's subtraction or update
    mg, step, to_grid, from_grid = slab
    lvl = mg.levels[0]
    xs = to_grid(np.random.RandomState(SEED + 7).rand(L2.shape[0]))
    bs = to_grid(np.random.RandomState(SEED + 8).rand(L2.shape[0]))
    fused = lambda: ps.stencil_matvec_local(lvl.coeff, lvl.di, lvl.dj,
                                            ps.exchange_halo(xs, comm))
    over = lambda b=None, d=None: ps.stencil_matvec_overlapped(
        lvl.coeff, lvl.di, lvl.dj, xs, comm, b=b, d=d)
    y = fused()
    bitwise = bool(torch.equal(y, over())
                   and torch.equal(bs - y, over(bs))
                   and torch.equal(xs + lvl.d * (bs - y), over(bs, lvl.d)))
    apply_ms = {}
    for form, fn in (
            ("fused", fused), ("overlapped", over),
            ("residual, fused", lambda: bs - fused()),
            ("residual, overlapped", lambda: over(bs)),
            ("jacobi, fused", lambda: xs + lvl.d * (bs - fused())),
            ("jacobi, overlapped", lambda: over(bs, lvl.d))):
        fn()
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize(device)
        apply_ms[form] = (time.perf_counter() - t) * 1e3 / 20
    setup_s = time.perf_counter() - t0

    def sync():
        torch.cuda.synchronize(device)

    def clock(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    def d_count():
        out = {t: sk.LAUNCHES[t] for t in ("float32", "float64")}
        out.update({f"{k}.{t}": dct[t] for k, dct in (
            ("halo", sk.HALO_LAUNCHES), ("cross", sk.CROSS_LAUNCHES))
            for t in ("float32", "float64")})
        out.update({f"form.{k}": v
                    for k, v in sk.HALO_FORM_LAUNCHES.items()})
        return out

    def one_cycle(c, fn):
        """A cycle's host-clock ms (median of three), bytes by kind and,
        on one rank, its device operations (`cycle_kernels`)."""
        ms = []
        for _ in range(3):
            c.reset_counts()
            _, t = clock(fn)
            ms.append(t)
        ops = cycle_kernels(fn, device) if world == 1 else None
        return float(np.median(ms)), dict(c.sent), ops

    out = {"rank": rank, "setup_s": setup_s, "bitwise": bitwise,
           "apply_ms": apply_ms, "rows": {}}
    for dct in (sk.LAUNCHES, sk.PLAIN_CALLS, sk.HALO_LAUNCHES,
                sk.HALO_FORM_LAUNCHES, sk.CROSS_LAUNCHES,
                sk.BLOCK_LAUNCHES):
        for k in dct:
            dct[k] = 0
    d0 = d_count()

    def row(label, iters, x, solve_ms, cycle, before, **more):
        after = d_count()
        out["rows"][label] = dict(
            iters=iters, solve_ms=solve_ms, cycle_ms=cycle[0],
            bytes=cycle[1], device_ops=cycle[2], x=x if rank == 0 else None,
            launches={k: after[k] - before[k] for k in after}, **more)

    # MS-2d: 20 slab cycles (step_fn), one at a time
    before = d_count()
    bg = to_grid(b2)
    xg, times, rns, xs = torch.zeros_like(bg), [], [], {}
    for k in range(1, 21):
        (xg, rn), ms = clock(lambda: step(mg, bg, xg))
        times.append(ms)
        rns.append(float(rn))
        if k in MS_AT:
            xs[k] = from_grid(xg)[:, 0].cpu().numpy()
    row("MS-2d", 20, None, float(sum(times)),
        one_cycle(comm, lambda: step(mg, bg, xg)), before, rn=rns,
        xs=xs if rank == 0 else None)
    # the refined and Krylov solves on the grid-sharded engine
    for label, key, call in (
            ("MG-2d", "MG-2d", lambda s: s.solve_refined(b2, tol=1e-8,
                                                         max_iter=40)),
            ("MG-pen", "MG-pen", lambda s: s.solve_refined(b2, tol=1e-8,
                                                           max_iter=40)),
            ("MG-3d", "MG-3d", lambda s: s.solve_refined(b3, tol=1e-8,
                                                         max_iter=40)),
            ("MG-cg", "MG-cg", lambda s: s.solve_cg(bf)),
            ("MG-bicg", "MG-cg", lambda s: s.solve_bicgstab(bf))):
        if key not in solvers:
            continue
        s = solvers[key]
        before = d_count()
        (x, info), ms = clock(lambda: call(s))
        rv = s.to_grid(b2 if key in ("MG-2d", "MG-pen") else
                       b3 if key == "MG-3d" else bf)[0]
        z = torch.zeros_like(rv)
        row(label, int(info["iters"]), x, ms,
            one_cycle(s.comm, lambda: s.cycle(s.gh, rv, z, True)), before)
    # DD-par: FGMRES(5) on replicated rows, the sweep spread over the ranks
    before = d_count()
    B = torch.tensor(bdd, device=device)[None]
    mv = lambda v: ell.matvec(v.T).T
    (X, info), ms = clock(lambda: fgmres(
        mv, B, restart=5, prec=lambda v: prec(v.T).T, tol=1e-8,
        max_iter=200, device_loop=False))
    row("DD-par", int(info["iters"]), X[0].cpu().numpy(), ms,
        one_cycle(comm, lambda: prec(B[0])), before)
    after = d_count()
    out["window"] = {k: after[k] - d0[k] for k in after}
    out["plain"] = dict(sk.PLAIN_CALLS)
    return out


MULTI_RUNS = (("1 NCCL rank", 1, ["cuda:0"], "nccl"),
              ("4 gloo ranks sharing the card", 4, "cuda:0", "gloo"))


def phase_multi(L2, L3, card, layouts=MULTI_RUNS):
    """Phase 19: the single-device references on the card, then the rows
    on each layout of `layouts` (label, ranks, devices, transport): by
    default 1 NCCL rank and 4 gloo ranks sharing the card (a host-staged
    exchange on one card: its times say nothing of NVLink), each held to
    its contract; x of the 4-rank layout against 1 rank's within 1e-6.
    Returns each run's rows (x dropped) and kernel D's launches in each
    window, summed over the ranks."""
    from mgtpu_torch import get_mg_param, mg_setup
    from mgtpu_torch.cycle.grid_cycle import grid_cycle
    from mgtpu_torch.ops.grid_stencil import flat_to_grid, grid_to_flat
    from mgtpu_torch.parallel.launch import run_ranks
    M2 = shifted_laplacian((N2, N2))[0]
    st = mg_setup(L2, M2, *get_mg_param(
        levels=LEVELS2, max_outer_iter=20, relative_tol=1e-6,
        relax_type="jacobi", relax_param=0.8, nu_pre=1, nu_post=1,
        dtype=np.float32))
    b2 = L2 @ np.random.RandomState(SEED).rand(L2.shape[0])
    b2 /= np.linalg.norm(b2)
    bg = flat_to_grid(torch.tensor(b2, dtype=torch.float32,
                                   device="cuda")[:, None],
                      st.hier.fine_grid)
    xg = torch.zeros_like(bg)
    single = {}
    for k in range(1, 21):
        xg = grid_cycle(st.config, st.hier, bg, xg)
        if k in MS_AT:
            single[k] = grid_to_flat(xg)[:, 0].cpu().numpy()
    host = lambda x: float(np.linalg.norm(b2 - L2 @ x.astype(np.float64)))
    r_single = {k: host(x) for k, x in single.items()}
    del st, bg, xg
    torch.cuda.empty_cache()
    b3 = L3 @ np.random.RandomState(SEED).rand(L3.shape[0])
    Af = divsig((N2, N2))[1]
    Ldd = shifted_laplacian((NDD, NDD))[1].astype(np.float64)
    problems = {"MG-2d": (L2, b2), "MG-pen": (L2, b2),
                "MG-3d": (L3, b3 / np.linalg.norm(b3)),
                "MG-cg": (Af, rhs_of(Af)), "MG-bicg": (Af, rhs_of(Af)),
                "DD-par": (Ldd, rhs_of(Ldd))}
    runs, halo = {}, {}
    for label, world, devices, transport in layouts:
        t0 = time.perf_counter()
        outs = run_ranks(multi_rank, world, devices, transport,
                         MULTI_DEADLINE_S, args=(transport,))
        wall = time.perf_counter() - t0
        r0 = outs[0]
        log(f"[multi] {label} ({transport}): {wall:.1f} s wall, setups "
            f"{max(o['setup_s'] for o in outs):.1f} s a rank; MS-2d's fine "
            f"slab with its halo exchange, fused (cat, cross form, torch) / "
            f"overlapped (the halo form), ms a rank: "
            + "; ".join(", ".join(f"{k} {v:.3f}" for k, v in
                                  o["apply_ms"].items()) for o in outs)
            + f" (host clock, synchronised, mean of 20; {card})")
        require(all(o["bitwise"] for o in outs), f"{label}: the overlapped "
                "slab apply, residual or Jacobi update is not bitwise the "
                "fused one")
        require(all(not any(o["plain"].values()) for o in outs),
                f"{label}: kernel D's plain version ran: "
                f"{[o['plain'] for o in outs]}")
        # every sharded level apply, residual and slab sweep on the halo
        # form: the slab GMG's residual and Jacobi update, the grid
        # engine's f32 residuals and the refined f64 residual; no cross
        # form (the extended block) on the path
        for key in ("halo.float32", "halo.float64", "form.residual.float32",
                    "form.jacobi.float32", "form.residual.float64"):
            require(all(o["window"][key] > 0 for o in outs),
                    f"{label}: kernel D's halo form ({key}) never launched")
        require(all(not o["window"]["cross.float32"]
                    and not o["window"]["cross.float64"] for o in outs),
                f"{label}: kernel D's cross form ran on the path: "
                f"{[o['window'] for o in outs]}")
        halo[label] = {k: sum(o["window"][k] for o in outs)
                       for k in r0["window"]}
        # MS-2d: one cycle against the single-device cycle; the reduced
        # norms against the host's f64 norms of the same x; the residuals
        # against the single-device cycles'
        ms = r0["rows"]["MS-2d"]
        xs = ms.pop("xs")
        rel1 = float(np.abs(xs[1] - single[1]).max()
                     / np.abs(single[1]).max())
        h = {k: host(x) for k, x in xs.items()}
        # f32 residual rounding: |fl(b - A x) - (b - A x)| <= 6 eps (|b| +
        # |A| |x|) node by node (5 taps and b)
        floor = {k: 6 * EPS32 * float(np.linalg.norm(
            np.abs(b2) + abs(L2) @ np.abs(x.astype(np.float64))))
            for k, x in xs.items()}
        log(f"[multi] (MS-2d) {label}: 20 slab cycles; after one, x within "
            f"{rel1:.2e} of the single-device cycle; reduced norm against "
            f"the host's f64 norm of the same x (and the f32 rounding bound "
            f"of the reduced one) after "
            + ", ".join(f"{k}: {ms['rn'][k - 1]:.6e} / {h[k]:.6e} "
                        f"({floor[k]:.1e})" for k in MS_AT)
            + "; the single-device f64 residuals "
            + ", ".join(f"{k}: {r_single[k]:.6e}" for k in MS_AT)
            + f"; {ms['solve_ms']:.1f} ms for 20, {ms['cycle_ms']:.2f} ms a "
            f"cycle, bytes a cycle {ms['bytes']}, kernel D "
            f"{ms['launches']}; device operations a cycle "
            f"{device_ops_note(ms['device_ops'])} (host clock, "
            f"synchronised; {card})")
        require(rel1 <= 1e-5, f"MS-2d {label}: one cycle {rel1:.2e} off")
        # the reduced norm is held only where f32's rounding bound is below
        # a tenth of it (cycle 1 at least); deeper it is printed, not held
        held = [k for k in MS_AT if floor[k] < 0.1 * h[k]]
        log(f"[multi] (MS-2d) {label}: reduced norm held after {held}, "
            f"printed only after {[k for k in MS_AT if k not in held]}")
        require(1 in held, f"MS-2d {label}: the rounding bound "
                f"{floor[1]:.1e} is not below a tenth of the first norm")
        for k in held:
            require(abs(ms["rn"][k - 1] - h[k]) <= 1e-5 * h[k] + floor[k],
                    f"MS-2d {label}: reduced norm {ms['rn'][k - 1]:.6e} "
                    f"after {k}, host {h[k]:.6e}")
        # above f32's floor the residuals agree within 1 %; at 20 cycles
        # both sit on it (ROADMAP queue 3): no worse than 1.2x the single
        # device's
        require(abs(h[10] - r_single[10]) <= 0.01 * r_single[10],
                f"MS-2d {label}: 10-cycle residual {h[10]:.6e}, single "
                f"device {r_single[10]:.6e}")
        require(h[20] <= 1.2 * r_single[20],
                f"MS-2d {label}: 20-cycle residual {h[20]:.6e}, single "
                f"device {r_single[20]:.6e}")
        ms.update(x1_rel=rel1, host_norms=h, rounding_bounds=floor,
                  norms_held=held,
                  single_residuals=r_single)
        runs[label] = {}
        for key, want in MULTI.items():
            if key not in r0["rows"]:
                continue
            rw = r0["rows"][key]
            A, b = problems[key]
            rr = true_relres(A, b, torch.as_tensor(rw["x"]))
            log(f"[multi] ({key}) {label}: {rw['iters']} "
                f"{'restarts' if key == 'DD-par' else 'iterations'} (want "
                f"{want} +- 1), true f64 relres {rr:.3e}; "
                f"{rw['solve_ms']:.1f} ms a solve, {rw['cycle_ms']:.2f} ms a "
                f"{'sweep' if key == 'DD-par' else 'cycle'}, bytes a "
                f"{'sweep' if key == 'DD-par' else 'cycle'} {rw['bytes']}, "
                f"kernel D {rw['launches']}; device operations a "
                f"{'sweep' if key == 'DD-par' else 'cycle'} "
                f"{device_ops_note(rw['device_ops'])} (host clock, "
                f"synchronised; {card})")
            require(abs(rw["iters"] - want) <= 1 and rr < 1e-8,
                    f"{key} {label}: {rw['iters']} iterations (want {want} "
                    f"+- 1), relres {rr:.3e}")
            runs[label][key] = dict(rw, relres=rr)
        runs[label]["MS-2d"] = ms
    one, four = (runs[k] for k in runs)
    for key in MULTI:
        x4 = four[key]["x"]
        x1 = one["MG-2d" if key == "MG-pen" else key]["x"]
        rel = float(np.abs(x4 - x1).max() / np.abs(x1).max())
        log(f"[multi] ({key}) x on 4 ranks within {rel:.2e} of 1 rank's")
        require(rel <= 1e-6, f"{key}: x on 4 ranks {rel:.2e} from 1 rank's")
    for label in runs:
        for key in runs[label]:
            runs[label][key].pop("x", None)
    return runs, halo



# ---------------------------------------------------------------------------
# phase 20: the systems and row-sharded flat tiers (parallel/
# systems_sharded.py, sharded_amg.py, sharded_solve.py)
# ---------------------------------------------------------------------------

# ROADMAP's systems and flat multi-device contracts: row -> (the state
# it shards, mgtpu's count +- 1); SY-3d runs on four ranks only; MA-fg is
# MA-sa's hierarchy under FGMRES (its count printed, a true relres below
# 1e-4)
MULTI2 = {"SY-2d": ("V-2d", 9), "SE-2d": ("E-2d", 28), "SY-3d": ("V-3d", 12),
          "MA-sa": ("SA-f", 50), "MA-cl": ("C-pmis", 13)}
MULTI2_FOUR_ONLY = ("SY-3d",)
MULTI2_CYCLE = ("SY-2d", "MA-sa")        # one cycle against one device
HANDOFF = {}            # state key -> what phases 20 and 21 read of it
_HANDOFF_DIR = []


def save_handoff(key, st, A, b):
    """Keep a state an earlier phase set up on the card for phases 20 and
    21: what the sharded solvers read of it (config, device hierarchy, the
    cached float64 fine operator of a systems state, the original operator
    of a flat or grid one, the host matrices of a flat one) in a file the
    ranks load, its operator and b for the host's relres, and the
    single-device correction cycle from zero on b.  A host SuperLU coarsest
    cannot be pickled: the ranks that need it factor its matrix again (the
    same factor)."""
    import dataclasses
    import os
    import tempfile
    from types import SimpleNamespace
    from mgtpu_torch import recursive_cycle
    from mgtpu_torch.cycle.coarse import SparseLUCoarse
    from mgtpu_torch.cycle.grid_cycle import GridHierarchy
    from mgtpu_torch.cycle.systems_grid import (SystemsGridHierarchy,
                                                block_to_fields,
                                                fields_to_block,
                                                systems_grid_cycle)
    if not _HANDOFF_DIR:
        _HANDOFF_DIR.append(tempfile.mkdtemp(prefix="mgtpu_multi2_"))
    t0 = time.perf_counter()
    systems = isinstance(st.hier, SystemsGridHierarchy)
    grid = isinstance(st.hier, GridHierarchy)
    flat = not (systems or grid)
    hier, lu = st.hier, None
    if isinstance(hier.coarse, SparseLUCoarse):
        hier, lu = dataclasses.replace(hier, coarse=None), st.As[-1]
    lean = SimpleNamespace(
        config=st.config, hier=hier, b=b,
        _outer_ops={"float64": st._outer_ops["float64"]} if systems else {},
        A_input=None if systems else (st.A_input if st.A_input is not None
                                      else st.As[0]),
        As=st.As if flat else None, Ps=st.Ps if flat else None,
        Rs=st.Rs if flat else None, coarse_matrix=lu)
    path = os.path.join(_HANDOFF_DIR[0], f"{key}.pt")
    torch.save(lean, path)
    if systems:
        bf = block_to_fields(torch.tensor(b[:, None], dtype=torch.float32,
                                          device="cuda"), st.hier.fine_grids)
        ref = fields_to_block(systems_grid_cycle(
            st.config, st.hier, bf, tuple(torch.zeros_like(t) for t in bf),
            x_zero=True))[:, 0].cpu().numpy()
        ell = None
    elif grid:
        b2 = torch.tensor(b[:, None], dtype=torch.float32, device="cuda")
        ref = recursive_cycle(st.config, st.hier, b2, torch.zeros_like(b2),
                              x_zero=True)[:, 0].cpu().numpy()
        ell = None
    else:
        # the state's cycle (its DIA levels on kernel D) and the same
        # hierarchy with every level as the padded ELL the flat tier shards
        # (one device, no pad): they differ in the fine apply's rounding only
        # (phase 20); and phase 21's one device: the partitioned tier's own
        # ELL levels (from the host matrices) on one rank of no group
        from mgtpu_torch.parallel.part_amg import PartitionedAMGSolver
        from mgtpu_torch.parallel.sharded_amg import pad_flat_hierarchy
        b2 = torch.tensor(b[:, None], dtype=torch.float32, device="cuda")
        part = PartitionedAMGSolver(st, _OneRank(), "cuda").hier
        ref, ell, part = (recursive_cycle(st.config, h, b2,
                                          torch.zeros_like(b2),
                                          x_zero=True)[:, 0].cpu().numpy()
                          for h in (st.hier, pad_flat_hierarchy(st.hier, 1),
                                    part))
    HANDOFF[key] = dict(path=path, A=A, b=b, cycle=ref, cycle_ell=ell,
                        cycle_part=None if systems or grid else part)
    log(f"[multi2] {key} kept for phases 20 and 21 in "
        f"{os.path.getsize(path) / 2 ** 20:.0f} MB, "
        f"{time.perf_counter() - t0:.1f} s")


def multi2_states(card):
    """Set up and keep (save_handoff) the five states phase 20 shards, for
    a run of phase 20 alone (scripts/multi_card.py): V-2d, E-2d and V-3d
    as phase 13 sets them up, SA-f as phase 11, C-pmis as phase 12 (SA-f's
    operator, b seed 6).  chip_smoke.py keeps those phases' own states."""
    for key, label, dim, cells, mixed, relax, nu, levels, _ in SYSTEMS:
        save_handoff(key, *systems_setup(label, dim, cells, mixed, relax,
                                         0.75, nu, levels, card))
        torch.cuda.empty_cache()
    amg_handoffs()


def amg_handoffs():
    """Set up and keep SA-f (as phase 11) and C-pmis (as phase 12: SA-f's
    operator, b seed 6)."""
    from mgtpu_torch import get_mg_param, sa_amg_setup
    _, label, seed, _, opts, *_ = AMG[2]
    _, A = divsig((AMG_CELLS, AMG_CELLS), seed=seed)
    b = A @ np.random.RandomState(seed + 1).rand(A.shape[0])
    b /= np.linalg.norm(b)
    cfg, rp = get_mg_param(levels=4, dtype=np.float32, **opts)
    save_handoff("SA-f", sa_amg_setup(A, cfg, rp), A, b)
    save_handoff("C-pmis", classical_setup("C-pmis", "classical",
                                           dict(coarsening="pmis"), A)[0],
                 A, b)


def drop_handoffs():
    """Remove the files save_handoff wrote."""
    import shutil
    for d in _HANDOFF_DIR:
        shutil.rmtree(d, ignore_errors=True)


def load_handoff(path, device, factor: bool = True):
    """A state kept by save_handoff, on `device`; a SuperLU coarsest
    factored again on the host, or (factor False: a rank that never solves
    it) held without its factor."""
    import dataclasses
    from mgtpu_torch.cycle.coarse import SparseLUCoarse, sparse_lu_from_scipy
    st = torch.load(path, map_location=device, weights_only=False)
    if st.coarse_matrix is not None:
        A_c = st.coarse_matrix
        st.hier = dataclasses.replace(st.hier, coarse=(
            sparse_lu_from_scipy(A_c, dtype=st.config.dtype) if factor else
            SparseLUCoarse(None, int(A_c.shape[0]),
                           str(np.dtype(st.config.dtype)))))
    return st


class _OneRank:
    """The collectives of a group of one rank, without a process group:
    phase 21's single-device reference runs the partitioned tier's levels
    through them (each is the identity there, as on one NCCL rank)."""
    rank = 0
    shape = (1,)

    def axis_size(self, axis=0):
        return 1

    def axis_index(self, axis=0):
        return 0

    def psum(self, t):
        return t

    def all_gather(self, t, axis=0):
        return t[None]

    def broadcast(self, t, src=0, axis=None):
        return t


class _RankOf:
    """The layout questions a RankGrid answers, for rank k of a 1D grid of
    D ranks (no process group: the kernel checks build one rank's blocks)."""

    def __init__(self, D, k):
        self.shape, self._k = (D,), k

    def axis_size(self, axis=0):
        return self.shape[0]

    def axis_index(self, axis=0):
        return self._k


def stag_cases(key, st, D=4, k=1):
    """Kernel D's halo apply at the shapes phase 20 gave it before the block
    form: every block of `key`'s fine level (f32) and of its float64
    residual operator (`st`, the state load_handoff gives), as rank k of D
    builds them (parallel/systems_sharded.py: the padded embedding,
    the cell-aligned blocks; the input the block's owned planes with the
    halo of its radius, the taps shifted by it).  A face component has one
    plane more than a cell component, so in_grid != out_grid."""
    from mgtpu_torch.ops.cross_stencil import CrossGridStencil
    from mgtpu_torch.parallel.systems_sharded import (pad_block_operator,
                                                      pad_systems_hierarchy,
                                                      shard_block_operator)
    gh_pad, pg = pad_systems_hierarchy(st.hier, D)
    out = []
    for op in (gh_pad.levels[0].A,
               pad_block_operator(st._outer_ops["float64"], pg)):
        sop = shard_block_operator(op, _RankOf(D, k), "cuda")
        for (ci, cj), coeff, offs in zip(sop.pairs, sop.coeffs, sop.offsets):
            r = sop.radius[cj]
            taps = tuple((o[0] + r,) + tuple(o[1:]) for o in offs)
            g = sop.grids[cj]
            in_grid = ((sop.layout.owned[cj] + 2 * r,) + tuple(g[1:])
                       if r else tuple(g))
            out.append((f"{key} rank {k} of {D} block ({ci}, {cj})",
                        CrossGridStencil(coeff, taps, tuple(coeff.shape[1:]),
                                         in_grid)))
    return out


def phase_stag_halo_kernels(rows, card):
    """Kernel D's halo apply against its plain version (m = 1, 2; f32
    2e-5, f64 1e-12) on every block of `stag_cases` for SY-2d (V-2d's
    hierarchy) and SY-3d (V-3d's), then its device time beside its byte
    bound, the plain version and torch.sparse.mm of the block's CSR on
    V-2d's largest fine block in both types (since the block form no
    systems level runs it block by block).  Then kernel D's block form
    on SY-2d's sharded levels (V-2d's hierarchy, f32, and its f64 residual
    operator) as every rank of 1 and of 4 builds them, bit for bit the
    per-block halo applies, adds and subtraction (check_block)."""
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.parallel.systems_sharded import (pad_block_operator,
                                                      pad_systems_hierarchy,
                                                      shard_block_operator)
    timer = Timer()
    for key in ("V-2d", "V-3d"):
        st = load_handoff(HANDOFF[key]["path"], "cuda")
        widest = {}
        for label, op in stag_cases(key, st):
            dt = op.coeff.dtype
            for m in (1, 2):
                x = torch.tensor(np.random.RandomState(SEED + m).rand(
                    m, *op.in_grid), dtype=dt, device="cuda")
                check_d(rows, f"staggered halo {label} m={m}",
                        stencil.halo_apply(op.coeff, op.offsets, op.in_grid,
                                           x),
                        stencil.cross_apply_plain(op.coeff, op.offsets,
                                                  op.in_grid, x),
                        "stencil_halo_stag")
            log(f"[kernel] D staggered halo apply, {label}, {op.in_grid} -> "
                f"{op.out_grid}, {len(op.offsets)} taps, {dt}: matches its "
                "plain version, m = 1, 2")
            size = op.coeff.numel() + int(np.prod(op.in_grid))
            if key == "V-2d" and size > widest.get(dt, ("", None, 0))[2]:
                widest[dt] = (label, op, size)
        # the rows' headline: V-2d's largest fine block (the most bytes)
        for dt, (label, op, _) in widest.items():
            entry, _ = time_d(f"stag {label}", "halo", op, op.to_scipy(),
                              timer, card)
            row = rows[f"stencil_halo_stag.{str(dt).split('.')[-1]}"]
            row.setdefault("times", {})[label] = entry
            row.update({k: entry[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "host_ms", "plan")},
                timed_shape=f"{label}: {entry['shape']} m=1",
                library_call="torch.sparse.mm(CSR, x)")
        if key == "V-2d":
            n = 0
            for D in (1, 4):
                gh_pad, pg = pad_systems_hierarchy(st.hier, D)
                ops = [(f"level {l}", lv.A)
                       for l, lv in enumerate(gh_pad.levels)]
                ops.append(("f64 residual operator",
                            pad_block_operator(st._outer_ops["float64"], pg)))
                for label, op in ops:
                    for k in range(D):
                        sop = shard_block_operator(op, _RankOf(D, k), "cuda")
                        check_block(rows, f"SY-2d {label}, rank {k} of {D}",
                                    sop, stencil.halo_apply)
                        n += 1
            log(f"[kernel] D block form on SY-2d's sharded levels: {n} rank "
                "operators (every level and the f64 residual operator, every "
                "rank of 1 and of 4; apply and residual, m = 1, 2, 5) bitwise "
                "the per-block halo applies, adds and subtraction")
        del st
        torch.cuda.empty_cache()


def _gathered_pad_zero(solver, xs, comm) -> bool:
    """Every plane of the gathered padded fine fields past the true grids
    (the pad, the dead slots among them) is exactly zero."""
    lay = solver.gh.levels[0].A.layout
    return all(bool((lay.gather(x, c, comm)[:, g[0]:] == 0).all())
               for c, (x, g) in enumerate(zip(xs, solver.true_grids)))


def multi2_rank(rank, world, device, transport, paths):
    """Phase 20 on one rank (spawned by mgtpu_torch/parallel/launch.py):
    for each row its state loaded (save_handoff), the sharded solver built,
    the refined solve, one correction cycle from zero (its ms, bytes and, on
    rank 0, its x for SY-2d and MA-sa) and whether the pad of that cycle's
    x is zero; MA-fg after MA-sa.  Kernel D's counters are read around each
    row.  Returns the rows; rank 0 also its x."""
    from mgtpu_torch import recursive_cycle
    from mgtpu_torch.ops.cuda import stencil as sk
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.sharded_amg import ShardedAMGSolver
    from mgtpu_torch.parallel.sharded_solve import ShardedSystemsSolver
    torch.backends.cuda.matmul.allow_tf32 = False
    comm = RankGrid(None, transport)

    def sync():
        torch.cuda.synchronize(device)

    def clock(fn):
        sync()
        t = time.perf_counter()
        res = fn()
        sync()
        return res, (time.perf_counter() - t) * 1e3

    def d_count():
        return {f"{kind}.{t}": dct[t] for kind, dct in (
            ("apply", sk.LAUNCHES), ("halo", sk.HALO_LAUNCHES),
            ("block", sk.BLOCK_LAUNCHES)) for t in ("float32", "float64")}

    def one_cycle(fn):
        """A cycle's host-clock ms (median of three) and bytes by kind."""
        ms = []
        for _ in range(3):
            comm.reset_counts()
            _, t = clock(fn)
            ms.append(t)
        return float(np.median(ms)), dict(comm.sent)

    for dct in (sk.LAUNCHES, sk.PLAIN_CALLS, sk.HALO_LAUNCHES,
                sk.CROSS_LAUNCHES, sk.BLOCK_LAUNCHES):
        for k in dct:
            dct[k] = 0
    d0 = d_count()
    out = {"rank": rank, "rows": {}}
    for row, (key, _) in MULTI2.items():
        if row in MULTI2_FOUR_ONLY and world == 1:
            continue
        t0 = time.perf_counter()
        st = load_handoff(paths[key], device)
        systems = row.startswith("S")
        solver = (ShardedSystemsSolver if systems
                  else ShardedAMGSolver)(st, comm, device)
        sync()
        setup_s = time.perf_counter() - t0
        b = st.b
        before = d_count()
        (x, info), ms = clock(lambda: solver.solve_refined(
            b, tol=1e-8, max_iter=60))
        if systems:
            bf = solver.to_fields(b)[0]
            z = tuple(torch.zeros_like(t) for t in bf)
            run = lambda: solver.cycle(solver.gh, bf, z, True)
            cyc = one_cycle(run)
            xc = run()
            pad_zero = _gathered_pad_zero(solver, xc, comm)
            xc = solver.from_fields(xc, True).cpu().numpy()
        else:
            bv = solver.to_vec(b)[0]
            run = lambda: recursive_cycle(st.config, solver.hier, bv,
                                          torch.zeros_like(bv), x_zero=True)
            cyc = one_cycle(run)
            y = run()
            pad_zero = bool((y[solver.n_true:] == 0).all())
            xc = y[:solver.n_true, 0].cpu().numpy()
        after = d_count()
        out["rows"][row] = dict(
            iters=int(info["iters"]), solve_ms=ms, cycle_ms=cyc[0],
            bytes=cyc[1], setup_s=setup_s, pad_zero=pad_zero,
            launches={k: after[k] - before[k] for k in after},
            x=x if rank == 0 else None,
            cycle_x=xc if rank == 0 and row in MULTI2_CYCLE else None)
        if row == "MA-sa":
            before = d_count()
            (x, info), ms = clock(lambda: solver.solve_fgmres(
                b.astype(np.float32), tol=1e-5, max_iter=30))
            after = d_count()
            out["rows"]["MA-fg"] = dict(
                iters=int(info["iters"]), solve_ms=ms, cycle_ms=cyc[0],
                bytes=cyc[1], setup_s=0.0, pad_zero=pad_zero,
                launches={k: after[k] - before[k] for k in after},
                x=np.asarray(x, np.float64) if rank == 0 else None,
                cycle_x=None)
        del solver, st
        torch.cuda.empty_cache()
    after = d_count()
    out["window"] = {k: after[k] - d0[k] for k in after}
    out["plain"] = dict(sk.PLAIN_CALLS)
    return out


def phase_multi2(card, layouts=MULTI_RUNS):
    """Phase 20: the rows of MULTI2 and MA-fg on each layout of `layouts`
    (by default 1 NCCL rank and 4 gloo ranks sharing the card; SY-3d on
    four ranks only), each at mgtpu's count +- 1 and a true f64 relres
    below 1e-8 (MA-fg below 1e-4); one SY-2d and one MA-sa correction
    cycle within 1e-5 of the single-device cycle, the pad of every row's
    cycle exactly zero; x of the 4-rank layout within 1e-6 of 1 rank's.
    Returns each run's rows (x dropped) and kernel D's halo launches in
    each window, summed over the ranks."""
    from mgtpu_torch.parallel.launch import run_ranks
    paths = {key: HANDOFF[key]["path"] for key, _ in MULTI2.values()}
    runs, halo = {}, {}
    for label, world, devices, transport in layouts:
        t0 = time.perf_counter()
        outs = run_ranks(multi2_rank, world, devices, transport,
                         MULTI_DEADLINE_S, args=(transport, paths))
        wall = time.perf_counter() - t0
        r0 = outs[0]
        log(f"[multi2] {label} ({transport}): {wall:.1f} s wall; state "
            f"loads and sharded setups a rank, s: "
            + ", ".join(f"{row} {max(o['rows'][row]['setup_s'] for o in outs):.1f}"
                        for row in r0["rows"] if row != "MA-fg")
            + f" ({card})")
        require(all(not any(o["plain"].values()) for o in outs),
                f"{label}: kernel D's plain version ran: "
                f"{[o['plain'] for o in outs]}")
        for t in ("float32", "float64"):
            require(all(o["window"][f"block.{t}"] > 0
                        and not o["window"][f"halo.{t}"] for o in outs),
                    f"{label}: kernel D's block form ({t}) never launched, "
                    f"or a block ran alone: {[o['window'] for o in outs]}")
        halo[label] = {k: sum(o["window"][k] for o in outs)
                       for k in r0["window"]}
        runs[label] = {}
        for row, rw in r0["rows"].items():
            key, want = MULTI2.get(row, ("SA-f", None))
            h = HANDOFF[key]
            rr = true_relres(h["A"], h["b"], torch.as_tensor(rw["x"]))
            systems = row.startswith("S")
            more = ""
            if rw["cycle_x"] is not None:
                # a flat row is held against one device's cycle on the
                # same ELL levels; its distance to the state's own cycle
                # (DIA levels on kernel D) is printed: in f32 the rough-
                # sigma cycle moves ~1e-4 when the fine apply rounds
                # otherwise, which the two single-device cycles show
                ref = h["cycle"] if h["cycle_ell"] is None else h["cycle_ell"]
                dist = lambda a, r: float(np.abs(a - r).max()
                                          / np.abs(r).max())
                rel = dist(rw["cycle_x"], ref)
                more = f"; one cycle within {rel:.2e} of one device's"
                if h["cycle_ell"] is not None:
                    rw["cycle_rel_dia"] = dist(rw["cycle_x"], h["cycle"])
                    rw["single_ell_dia"] = dist(h["cycle_ell"], h["cycle"])
                    more += (f" on the same ELL levels ({rw['cycle_rel_dia']:.2e} "
                             "of the state's cycle on its DIA levels; the two "
                             f"single-device cycles {rw['single_ell_dia']:.2e} "
                             "apart)")
                require(rel <= 1e-5, f"{row} {label}: one cycle {rel:.2e} "
                        "from the single-device cycle")
                rw["cycle_rel"] = rel
            log(f"[multi2] ({row}) {label}: {rw['iters']} "
                f"{'FGMRES restarts' if row == 'MA-fg' else 'iterations'}"
                f"{'' if want is None else f' (want {want} +- 1)'}, true f64 "
                f"relres {rr:.3e}{more}; {rw['solve_ms']:.1f} ms a solve, "
                f"{rw['cycle_ms']:.2f} ms a cycle, bytes a cycle "
                f"{rw['bytes']}"
                + (f", kernel D {rw['launches']}" if systems else "")
                + f"; pad of the cycle's x zero: {rw['pad_zero']} (host "
                f"clock, synchronised; {card})")
            require(all(o["rows"][row]["pad_zero"] for o in outs),
                    f"{row} {label}: the pad of x is not zero after a cycle")
            if want is None:
                require(rr < 1e-4, f"MA-fg {label}: true relres {rr:.3e}")
            else:
                require(abs(rw["iters"] - want) <= 1 and rr < 1e-8,
                        f"{row} {label}: {rw['iters']} iterations (want "
                        f"{want} +- 1), relres {rr:.3e}")
            if systems:
                require(rw["launches"]["block.float32"] > 0
                        and rw["launches"]["block.float64"] > 0,
                        f"{row} {label}: kernel D's block form did not run "
                        f"in both types: {rw['launches']}")
            runs[label][row] = dict(rw, relres=rr)
    one, four = (runs[k] for k in runs)
    for row in four:
        if row not in one:
            continue
        x1, x4 = one[row]["x"], four[row]["x"]
        rel = float(np.abs(x4 - x1).max() / np.abs(x1).max())
        log(f"[multi2] ({row}) x on 4 ranks within {rel:.2e} of 1 rank's")
        if row == "MA-fg":
            # an f32 FGMRES x to tol 1e-5 is determined only to its
            # residual on this operator (the f32 row products round
            # otherwise on 4 ranks): the same count, and each true relres
            # below 1e-4 (held above), not 1e-6 in x
            require(four[row]["iters"] == one[row]["iters"],
                    f"MA-fg: {four[row]['iters']} restarts on 4 ranks, "
                    f"{one[row]['iters']} on 1")
            continue
        require(rel <= 1e-6, f"{row}: x on 4 ranks {rel:.2e} from 1 rank's")
    for label in runs:
        for row in runs[label]:
            runs[label][row].pop("x", None)
            runs[label][row].pop("cycle_x", None)
    return runs, halo


# ---------------------------------------------------------------------------
# phase 21: the partitioned flat tier (parallel/part_amg.py) and the reduce
# hook (Jac-GMRES and K-cycles on the sharded grid and systems engines)
# ---------------------------------------------------------------------------

# ROADMAP's contracts: row -> (the state it takes, the count wanted +- 1;
# None: the port's single-device count of the same solve on the card)
MULTI3 = {"PA-sa": ("SA-f", 50), "PA-cl": ("C-pmis", 13),
          "PA-K": ("PA-K", 62), "GK-2d": ("g5", None),
          "SK-2d": ("V-2d", None)}
# GK-2d runs (g)'s configuration at GK_LEVELS levels, not (g)'s 6, for the
# script's time: a K-cycle visits level l 2^(l-1) times, each visit on 4
# host-staged gloo ranks about as dear, so a sixth level about doubles the
# row; its FGMRES(5) restarts and refined count are held to the
# single-device counts at that depth (K_REFERENCE), as SK-2d's are
GK_LEVELS = 5
# mgtpu's halo entries of A per level on 4 devices, for SA-f's levels
# (scripts/part_reference.py)
PA_LEVELS = [263169, 50246, 7872, 964]
PA_HALO = [1026, 814, 487, 224]
K_REFERENCE = {}        # state key -> the single-device K-cycle's count
                        # and its correction cycle from zero on b


def pa_k_state(card):
    """(PA-K) SA-f's operator and b, Jac-GMRES 1.0 V(1,1) K-cycles, 4
    levels, f32: a new host setup on the card, kept for phase 21."""
    from mgtpu_torch import get_mg_param, sa_amg_setup
    h = HANDOFF["SA-f"]
    cfg, rp = get_mg_param(levels=4, relax_type="jac-gmres", relax_param=1.0,
                           nu_pre=1, nu_post=1, cycle_type="K",
                           dtype=np.float32)
    t0 = time.perf_counter()
    st = sa_amg_setup(h["A"], cfg, rp)
    torch.cuda.synchronize()
    log(f"[multi3] (PA-K) setup {time.perf_counter() - t0:.1f} s (host "
        f"clock), levels {[a.shape[0] for a in st.As]}, coarsest "
        f"{type(st.hier.coarse).__name__} ({card})")
    save_handoff("PA-K", st, h["A"], h["b"])


def gk_state(M, A):
    """(g)'s configuration (Jac-GMRES 1.0 K-cycles, f32) at GK_LEVELS levels
    on its operator: GK-2d's state."""
    from mgtpu_torch import get_mg_param, mg_setup
    cfg, rp = get_mg_param(levels=GK_LEVELS, max_outer_iter=100,
                           relative_tol=1e-8, nu_pre=1, nu_post=1,
                           dtype=np.float32, relax_type="jac-gmres",
                           relax_param=1.0, cycle_type="K")
    return mg_setup(A, M, cfg, rp)


def k_reference(key, st, A, b, max_iter=None, fgmres=False):
    """The single-device K-cycle of a state on the card: a systems state's
    config with cycle_type "K" (the hierarchy does not depend on it), its
    refined count to 1e-8 and one correction cycle from zero on b; with
    `fgmres`, also its solve_gmres_mg(inner=5) count to 1e-8 (GK-2d's
    FGMRES(5) restarts)."""
    import copy
    import dataclasses
    from mgtpu_torch import recursive_cycle, solve_gmres_mg, solve_mg_refined
    if st.config.cycle_type != "K":
        st = copy.copy(st)
        st.config = dataclasses.replace(st.config, cycle_type="K")
    x, info = solve_mg_refined(st, b, tol=1e-8, max_iter=max_iter)
    rr = true_relres(A, b, x)
    b2 = torch.tensor(b[:, None], dtype=torch.float32, device="cuda")
    cyc = recursive_cycle(st.config, st.hier, b2, torch.zeros_like(b2),
                          x_zero=True)[:, 0].cpu().numpy()
    K_REFERENCE[key] = dict(iters=int(info["iters"]), cycle=cyc)
    log(f"[multi3] {key} K-cycles on one device: {int(info['iters'])} "
        f"iterations, true relres {rr:.3e}")
    require(rr < 1e-8, f"{key}: the single-device K-cycle solve reached "
            f"{rr:.3e}")
    if fgmres:
        x, info = solve_gmres_mg(st, b, inner=5)
        rr = true_relres(A, b, x)
        K_REFERENCE[key]["fgmres"] = int(info["iters"])
        log(f"[multi3] {key} solve_gmres_mg(inner=5) on one device: "
            f"{int(info['iters'])} restarts, true relres {rr:.3e}")
        require(rr < 1e-8, f"{key}: the single-device FGMRES(5) reached "
                f"{rr:.3e}")


def multi3_states(card):
    """Set up and keep the states phase 21 takes, for a run of phase 21
    without the phases before it (scripts/multi_card.py): SA-f and C-pmis
    (`amg_handoffs`, unless kept already), V-2d as phase 13 and (g) as
    phase 7 with their single-device K-cycle references, and PA-K."""
    from mgtpu_torch import get_mg_param, mg_setup
    if "SA-f" not in HANDOFF:
        amg_handoffs()
        torch.cuda.empty_cache()
    if "V-2d" not in K_REFERENCE:
        _, label, dim, cells, mixed, relax, nu, levels, _ = SYSTEMS[0]
        st, A, b = systems_setup(label, dim, cells, mixed, relax, 0.75, nu,
                                 levels, card)
        if "V-2d" not in HANDOFF:
            save_handoff("V-2d", st, A, b)
        k_reference("V-2d", st, A, b, max_iter=60)
        del st
        torch.cuda.empty_cache()
    if "g5" not in K_REFERENCE:
        M, A = divsig((N2, N2))
        st, b = gk_state(M, A), rhs_of(A)
        save_handoff("g5", st, A, b)
        k_reference("g5", st, A, b, fgmres=True)
        del st
        torch.cuda.empty_cache()
    pa_k_state(card)


def multi3_rank(rank, world, device, transport, paths, k_iters):
    """Phase 21 on one rank (spawned by mgtpu_torch/parallel/launch.py):
    each row's state loaded (save_handoff) and its sharded solver built,
    its solves, one correction cycle from zero (its ms, bytes a cycle by
    kind, its x on rank 0, whether its pad is zero); for PA-sa also
    MA-sa's replicated cycle (ms, bytes).  Kernel D's counters are read
    around each row.  Returns the rows; rank 0 also its x."""
    import dataclasses
    from mgtpu_torch import recursive_cycle
    from mgtpu_torch.ops.cuda import stencil as sk
    from mgtpu_torch.parallel.comm import RankGrid
    from mgtpu_torch.parallel.grid_sharded import _gather
    from mgtpu_torch.parallel.part_amg import PartitionedAMGSolver
    from mgtpu_torch.parallel.sharded_amg import ShardedAMGSolver
    from mgtpu_torch.parallel.sharded_solve import (ShardedGridSolver,
                                                    ShardedSystemsSolver)
    torch.backends.cuda.matmul.allow_tf32 = False
    comm = RankGrid(None, transport)

    def sync():
        torch.cuda.synchronize(device)

    def clock(fn):
        sync()
        t = time.perf_counter()
        res = fn()
        sync()
        return res, (time.perf_counter() - t) * 1e3

    def d_count():
        return {f"{kind}.{t}": dct[t] for kind, dct in (
            ("apply", sk.LAUNCHES), ("halo", sk.HALO_LAUNCHES),
            ("cross", sk.CROSS_LAUNCHES), ("block", sk.BLOCK_LAUNCHES))
            for t in ("float32", "float64")}

    def one_cycle(fn):
        """(a cycle's host-clock ms and bytes by kind, its output): one
        cycle, after the solve has warmed the path."""
        comm.reset_counts()
        y, t = clock(fn)
        return (t, dict(comm.sent)), y

    for dct in (sk.LAUNCHES, sk.PLAIN_CALLS, sk.HALO_LAUNCHES,
                sk.CROSS_LAUNCHES, sk.BLOCK_LAUNCHES):
        for k in dct:
            dct[k] = 0
    out = {"rank": rank, "rows": {}}
    for row, (key, _) in MULTI3.items():
        t0 = time.perf_counter()
        st = load_handoff(paths[key], device, factor=rank == 0)
        b = st.b
        more = {}
        before = d_count()
        if row.startswith("PA"):
            solver = PartitionedAMGSolver(st, comm, device)
            sync()
            setup_s = time.perf_counter() - t0
            (x, info), ms = clock(lambda: solver.solve_refined(
                b, tol=1e-8, max_iter=80 if row == "PA-K" else 60))
            bl = solver.to_block(b)[0]
            run = lambda: recursive_cycle(st.config, solver.hier, bl,
                                          torch.zeros_like(bl), x_zero=True)
            cyc, y = one_cycle(run)
            pad = solver.n_true - rank * solver.p[0]
            pad_zero = bool((y[max(pad, 0):] == 0).all())
            xc = solver.from_block(y, True)
            more["halo"] = [solver.comm_entries_per_cycle()[l]["A"][
                "halo_entries"] for l in range(len(solver.p))]
            more["levels"] = [int(a.shape[0]) for a in st.As]
            if row == "PA-sa":
                rep = ShardedAMGSolver(st, comm, device)
                bv = rep.to_vec(b)[0]
                rep_run = lambda: recursive_cycle(
                    st.config, rep.hier, bv, torch.zeros_like(bv),
                    x_zero=True)
                rep_run()
                more["ma_sa"] = one_cycle(rep_run)[0]
                del rep
        elif row == "GK-2d":
            solver = ShardedGridSolver(st, comm, (0,), device)
            sync()
            setup_s = time.perf_counter() - t0
            (xf, fi), fms = clock(lambda: solver.solve_fgmres(
                b, restart=5, tol=1e-8))
            more.update(fgmres_iters=int(fi["iters"]), fgmres_ms=fms,
                        fgmres_x=xf if rank == 0 else None)
            (x, info), ms = clock(lambda: solver.solve_refined(b, tol=1e-8))
            rv = solver.to_grid(b)[0]
            run = lambda: solver.cycle(solver.gh, rv, torch.zeros_like(rv),
                                       True)
            cyc, y = one_cycle(run)
            more["device_ops"] = (cycle_kernels(run, device) if world == 1
                                  else None)
            full = _gather(y, comm, solver.gh.levels[0].A.shard, 1)
            n0 = solver.true_grid[0]
            pad_zero = bool((full[:, n0:] == 0).all())
            xc = solver.from_grid(y, True).cpu().numpy()
        else:                               # SK-2d: V-2d's, K-cycles
            st.config = dataclasses.replace(st.config, cycle_type="K")
            solver = ShardedSystemsSolver(st, comm, device)
            sync()
            setup_s = time.perf_counter() - t0
            (x, info), ms = clock(lambda: solver.solve_refined(
                b, tol=1e-8, max_iter=60))
            bf = solver.to_fields(b)[0]
            z = tuple(torch.zeros_like(t) for t in bf)
            run = lambda: solver.cycle(solver.gh, bf, z, True)
            cyc, y = one_cycle(run)
            pad_zero = _gathered_pad_zero(solver, y, comm)
            xc = solver.from_fields(y, True).cpu().numpy()
        after = d_count()
        out["rows"][row] = dict(
            iters=int(info["iters"]), solve_ms=ms, cycle_ms=cyc[0],
            bytes=cyc[1], setup_s=setup_s, pad_zero=pad_zero,
            launches={k: after[k] - before[k] for k in after},
            x=x if rank == 0 else None,
            cycle_x=np.asarray(xc, np.float64) if rank == 0 else None,
            **more)
        del solver, st
        torch.cuda.empty_cache()
    out["plain"] = dict(sk.PLAIN_CALLS)
    return out


def phase_multi3(card, layouts=MULTI_RUNS):
    """Phase 21: the rows of MULTI3 on each layout of `layouts` (by default
    1 NCCL rank and 4 gloo ranks sharing the card): each count +- 1 at a
    true f64 relres below 1e-8 (GK-2d: its FGMRES(5) restarts, then the
    refined solve, each at the single-device count at GK_LEVELS levels);
    PA-sa's halo entries on 4
    ranks mgtpu's; one correction cycle from zero against one device's
    (PA-*: on the tier's own ELL levels, bitwise on 1 rank, 1e-5 on 4; a
    K-cycle where its rounding differs 5e-3), its pad exactly zero; the
    4-rank x within 1e-6 of 1 rank's.  Prints PA-sa's bytes a cycle beside MA-sa's.  Returns
    each run's rows (x dropped) and kernel D's launches of GK-2d and SK-2d
    in each run, summed over the ranks."""
    from mgtpu_torch.parallel.launch import run_ranks
    paths = {key: HANDOFF[key]["path"] for key, _ in MULTI3.values()}
    k_iters = {key: K_REFERENCE[key]["iters"] for key in K_REFERENCE}
    runs, halo = {}, {}
    for label, world, devices, transport in layouts:
        t0 = time.perf_counter()
        outs = run_ranks(multi3_rank, world, devices, transport,
                         MULTI_DEADLINE_S, args=(transport, paths, k_iters))
        wall = time.perf_counter() - t0
        r0 = outs[0]
        log(f"[multi3] {label} ({transport}): {wall:.1f} s wall; state "
            "loads and sharded setups a rank, s: "
            + ", ".join(f"{row} {max(o['rows'][row]['setup_s'] for o in outs):.1f}"
                        for row in r0["rows"]) + "; solves, s: "
            + ", ".join(f"{row} {rw['solve_ms'] / 1e3:.1f}"
                        for row, rw in r0["rows"].items()) + f" ({card})")
        require(all(not any(o["plain"].values()) for o in outs),
                f"{label}: kernel D's plain version ran: "
                f"{[o['plain'] for o in outs]}")
        halo[label] = {row: {k: sum(o["rows"][row]["launches"][k]
                                    for o in outs)
                             for k in r0["rows"][row]["launches"]}
                       for row in ("GK-2d", "SK-2d")}
        runs[label] = {}
        for row, rw in r0["rows"].items():
            key, want = MULTI3[row]
            h = HANDOFF[key]
            rr = true_relres(h["A"], h["b"], torch.as_tensor(rw["x"]))
            if want is None:
                single = K_REFERENCE[key]["iters"]
            dist = lambda a, r: float(np.abs(a - r).max() / np.abs(r).max())
            # a K-cycle's f32 FGMRES projections solve normal equations:
            # another rounding of the same levels moves its x by up to a
            # few 1e-3 (mgtpu's own jitted and eager K-cycles are 3.7e-3
            # apart at 48^2, tests/test_torch_part_amg.py), so K rows are
            # held to 5e-3 where their rounding differs
            kbound = 5e-3
            if row.startswith("PA"):
                # one device on the tier's own ELL levels (from the host
                # matrices); the padded ELL of the state's levels (phase
                # 20's, explicit zeros of a DIA level where they were)
                # rounds the products otherwise by a few 1e-6: printed
                ref = h["cycle_part"]
                rel = dist(rw["cycle_x"], ref)
                rw["cycle_rel_ell"] = dist(rw["cycle_x"], h["cycle_ell"])
                # on 4 ranks every product rounds otherwise (the ELL
                # batches' sizes); a V-cycle is held to 1e-5 or to ten
                # times the spread its fine level's rounding alone makes
                # between the two single-device cycles, whichever is larger
                spread = dist(h["cycle_ell"], ref)
                bound = 0.0 if world == 1 else (
                    kbound if row == "PA-K" else max(1e-5, 10 * spread))
                what = ("its own ELL levels (the padded ELL of the state's "
                        f"levels {rw['cycle_rel_ell']:.2e})")
            else:
                ref = K_REFERENCE[key]["cycle"]
                rel = dist(rw["cycle_x"], ref)
                bound = kbound
                what = "its state's levels"
            rw["cycle_rel"] = rel
            extra = ""
            if row == "GK-2d":
                rf = true_relres(h["A"], h["b"], torch.as_tensor(
                    rw["fgmres_x"]))
                fw = K_REFERENCE[key]["fgmres"]
                extra = (f"; FGMRES(5) {rw['fgmres_iters']} restarts (want "
                         f"{fw} +- 1, one device's at {GK_LEVELS} levels), "
                         f"true f64 relres {rf:.3e}, "
                         f"{rw['fgmres_ms']:.1f} ms")
                rw["fgmres_relres"] = rf
                require(abs(rw["fgmres_iters"] - fw) <= 1 and rf < 1e-8,
                        f"GK-2d {label}: {rw['fgmres_iters']} restarts, "
                        f"relres {rf:.3e}")
            if want is None:
                want = single
            if row.startswith("PA"):
                extra += (f"; halo entries of A a level {rw['halo']} at "
                          f"levels {rw['levels']}")
                if world == 4 and rw["levels"] == PA_LEVELS \
                        and row == "PA-sa":
                    require(rw["halo"] == PA_HALO, f"PA-sa {label}: halo "
                            f"entries {rw['halo']}, mgtpu's {PA_HALO}")
            log(f"[multi3] ({row}) {label}: {rw['iters']} iterations (want "
                f"{want} +- 1), true f64 relres {rr:.3e}{extra}; one cycle "
                f"within {rel:.2e} of one device's on {what}; "
                f"{rw['solve_ms']:.1f} ms a solve, {rw['cycle_ms']:.2f} ms a "
                f"cycle, bytes a cycle {rw['bytes']}"
                + (f", kernel D {rw['launches']}" if row[1] == "K" else "")
                + f"; pad of the cycle's x zero: {rw['pad_zero']} (host "
                f"clock, synchronised; {card})")
            if row == "PA-sa":
                ms, by = rw["ma_sa"]
                log(f"[multi3] (PA-sa) {label}: bytes a cycle, one rank: "
                    f"partitioned {sum(rw['bytes'].values())} "
                    f"{rw['bytes']}, MA-sa's replicated cycle "
                    f"{sum(by.values())} {by}; ms a cycle {rw['cycle_ms']:.2f}"
                    f" / {ms:.2f} (host clock, synchronised; {card})")
            require(rel <= bound, f"{row} {label}: one cycle {rel:.2e} from "
                    f"the single-device cycle on {what} (bound {bound})")
            require(all(o["rows"][row]["pad_zero"] for o in outs),
                    f"{row} {label}: the pad of x is not zero after a cycle")
            require(abs(rw["iters"] - want) <= 1 and rr < 1e-8,
                    f"{row} {label}: {rw['iters']} iterations (want {want} "
                    f"+- 1), relres {rr:.3e}")
            if row[1] == "K":
                # GK-2d's grid levels on the halo form, SK-2d's systems
                # levels on the block form (no block alone)
                kind = "halo" if row == "GK-2d" else "block"
                require(rw["launches"][f"{kind}.float32"] > 0
                        and rw["launches"][f"{kind}.float64"] > 0
                        and (kind == "halo"
                             or not rw["launches"]["halo.float32"]
                             + rw["launches"]["halo.float64"])
                        and not rw["launches"]["cross.float32"]
                        + rw["launches"]["cross.float64"],
                        f"{row} {label}: kernel D's {kind} form did not run "
                        f"in both types, or its cross form ran: "
                        f"{rw['launches']}")
                if row == "GK-2d":
                    log(f"[multi3] (GK-2d) {label}: device operations a "
                        f"cycle {device_ops_note(rw.get('device_ops'))} "
                        f"({card})")
            runs[label][row] = dict(rw, relres=rr)
    one, four = (runs[k] for k in runs)
    for row in four:
        for xk in ("x", "fgmres_x"):
            if one[row].get(xk) is None:
                continue
            x1, x4 = np.asarray(one[row][xk]), np.asarray(four[row][xk])
            rel = float(np.abs(x4 - x1).max() / np.abs(x1).max())
            log(f"[multi3] ({row}) {xk} on 4 ranks within {rel:.2e} of 1 "
                "rank's")
            if xk == "fgmres_x":
                # as MA-fg's (ROADMAP queue 3): a Krylov x to tol fixes its
                # residual, not x; the same restarts, each relres held above
                require(four[row]["fgmres_iters"] == one[row]["fgmres_iters"],
                        f"{row}: {four[row]['fgmres_iters']} restarts on 4 "
                        f"ranks, {one[row]['fgmres_iters']} on 1")
                continue
            require(rel <= 1e-6, f"{row}: x on 4 ranks {rel:.2e} from 1 "
                    "rank's")
    for label in runs:
        for row in runs[label]:
            for xk in ("x", "cycle_x", "fgmres_x"):
                runs[label][row].pop(xk, None)
    return runs, halo


def main() -> int:
    t_start = time.perf_counter()
    smi, name = phase_card()
    card = f"{name}, {smi.split(',')[-1].strip()}"
    _CARD.append(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    phase_probe(card)
    # the process's first profiler run can see no device events
    # (CUPTI starting up): spend it here, not on a path's busy share
    device_ms(lambda: torch.ones(8, device="cuda").sum())

    from mgtpu_torch import get_mg_param, mg_setup
    M3, L3 = shifted_laplacian((128, 128, 128))
    cfg, rp = get_mg_param(levels=5, relax_type="jacobi", relax_param=0.8,
                           nu_pre=1, nu_post=1, dtype=np.float32)
    t0 = time.perf_counter()
    st_jac = mg_setup(L3, M3, cfg, rp)
    log(f"[path] 3D 128^3 setup {time.perf_counter() - t0:.1f} s, grids "
        f"{[lv.A.grid for lv in st_jac.hier.levels]}")

    rows = {k: {"name": k, "route": "cuda", "source": src, "replaces": rep,
                "max_abs_err": 0.0, "max_rel_err": 0.0}
            for k, (rep, src, _) in KERNELS.items()}
    timed = phase_kernels(st_jac, rows)
    phase_timing(timed, rows)
    log(f"[elapsed] phases 1-3 done: {time.perf_counter() - t_start:.1f} s")
    launches = phase_path3d(M3, L3, st_jac, card)
    st2d = phase_path2d(card)

    t0 = time.perf_counter()
    line_ops = {"a": aniso2d(1024, 100.0), "d": aniso3d([128] * 3, 0)}
    log(f"[kernel] line operators built in {time.perf_counter() - t0:.1f} s")
    timed_lines = phase_line_kernels(
        {"1025^2": line_ops["a"], "129^3": line_ops["d"],
         "(19,25,31)": aniso3d([30, 24, 18], 0)}, rows)
    phase_line_edges(rows)
    phase_line_timing(timed_lines, rows)
    aniso = phase_aniso(line_ops, card)
    phase_fmg(card)

    log(f"[elapsed] phases 4-8 done: {time.perf_counter() - t_start:.1f} s")
    ops, kstates, rhs = krylov_states()
    timed_states = {"f": kstates["f"], "h": kstates["h"]}
    phase_stencil_kernels(timed_states, rows)
    phase_stencil_timing(timed_states, rows, card)
    krylov = phase_krylov(ops, kstates, rhs, card)
    st_gk = gk_state(*ops["f"])
    save_handoff("g5", st_gk, ops["f"][1], rhs["g"]["b"])
    k_reference("g5", st_gk, ops["f"][1], rhs["g"]["b"], fgmres=True)
    del st_gk
    cg_iteration(kstates["f"], rhs["f"]["b"], card)
    b3 = L3 @ np.random.RandomState(SEED).rand(L3.shape[0])
    sweep = chunk_sweep((st_jac, b3 / np.linalg.norm(b3)),
                        (kstates["f"], rhs["f"]["b"]), card)
    del ops, kstates, rhs, timed_states

    log(f"[elapsed] phases 9-10 done: {time.perf_counter() - t_start:.1f} s")
    runs = amg_states()
    st3, levels3 = sa3d_levels()
    phase_amg_kernels(runs, st3, levels3, rows)
    phase_d_edges(rows)
    phase_amg_timing(runs, st3, rows, card)
    amg = phase_amg(runs, card)
    require(runs[2][0] == "SA-f", "SA-f is the third AMG state")
    save_handoff("SA-f", *runs[2][2:5])
    classical = phase_classical(runs[2], rows, card)
    del runs, st3, levels3
    torch.cuda.empty_cache()
    log(f"[elapsed] phases 11-12 done: {time.perf_counter() - t_start:.1f} s")
    sys_states, lex_state, systems = phase_systems(card)
    phase_cross_kernels(sys_states, rows, card)
    phase_lex_kernel(lex_state, rows, card)
    for key in ("V-2d", "E-2d", "V-3d"):
        save_handoff(key, *sys_states[key])
    k_reference("V-2d", *sys_states["V-2d"], max_iter=60)
    del sys_states, lex_state
    torch.cuda.empty_cache()
    log(f"[elapsed] phase 13 done: {time.perf_counter() - t_start:.1f} s")
    kmg, kprec = kmg_state(card), kprec_state()
    phase_kaczmarz_kernel(kmg, kprec, rows, card)
    f_launches = phase_facade(M3, L3, st_jac, st2d, kmg, kprec, card)
    del kmg, kprec, st2d
    torch.cuda.empty_cache()
    log(f"[elapsed] phases 15-16 done: {time.perf_counter() - t_start:.1f} s")
    cstates = complex_states(card)
    phase_complex_kernels(cstates, rows, card)
    cplx = phase_complex(cstates, card)
    del cstates
    torch.cuda.empty_cache()
    log(f"[elapsed] phase 17 done: {time.perf_counter() - t_start:.1f} s")
    rstates = rest_states(card)
    phase_rest_kernels(rstates, rows, card)
    rest = phase_rest(rstates, card)
    del rstates
    torch.cuda.empty_cache()
    log(f"[elapsed] phase 18 done: {time.perf_counter() - t_start:.1f} s")
    t19 = time.perf_counter()
    L2 = shifted_laplacian((N2, N2))[1]
    phase_halo_kernels(L2, L3, rows, card)
    multi, multi_d = phase_multi(L2, L3, card)
    log("[multi] " + json.dumps(multi, default=float))
    log(f"[multi] phase 19: {time.perf_counter() - t19:.1f} s")
    t20 = time.perf_counter()
    phase_stag_halo_kernels(rows, card)
    try:
        multi2, multi2_d = phase_multi2(card)
        log("[multi2] " + json.dumps(multi2, default=float))
        log(f"[multi2] phase 20: {time.perf_counter() - t20:.1f} s")
        t21 = time.perf_counter()
        pa_k_state(card)
        multi3, multi3_d = phase_multi3(card)
    finally:
        drop_handoffs()
    log("[multi3] " + json.dumps(multi3, default=float))
    log(f"[multi3] phase 21: {time.perf_counter() - t21:.1f} s")
    for k, row in rows.items():
        # each kernel's launches from the window of its own path (the
        # systems levels' applies and residuals are block-form launches)
        row["launches"] = (
            sum(w["halo." + k.split(".")[1]] for w in multi2_d.values())
            + sum(w["SK-2d"]["halo." + k.split(".")[1]]
                  for w in multi3_d.values())
            if k.startswith("stencil_halo_stag.") else
            sum(w["halo." + k.split(".")[1]] for w in multi_d.values())
            + sum(w["GK-2d"]["halo." + k.split(".")[1]]
                  for w in multi3_d.values())
            if k.startswith("stencil_halo_form.") else
            sum(w["cross." + k.split(".")[1]] for w in multi_d.values())
            + sum(w["GK-2d"]["cross." + k.split(".")[1]]
                  for w in multi3_d.values())
            if k.startswith("stencil_halo.") else
            rest[k] if k in REST_ROWS
            or k in ("stencil_cross.complex64", "stencil_cross.complex128")
            else
            systems[k] + sum(w["block." + k.split(".")[1]]
                             for w in multi2_d.values())
            + sum(w["SK-2d"]["block." + k.split(".")[1]]
                  for w in multi3_d.values())
            if k.startswith("stencil_block.") else
            cplx[k] if "complex" in k else
            aniso[k] if k.startswith("tridiag") else
            krylov[k] if k.startswith("stencil.") else
            systems["cross." + k.split(".")[1]]
            if k.startswith("stencil_cross.") else
            systems["vanka.float32"] if k == "vanka_lex" else
            f_launches["kaczmarz.float64"] if k == "kaczmarz" else
            launches[k])
    for k in ("stencil_halo.float32", "stencil_halo.float64",
              "stencil_halo_form.float32", "stencil_halo_form.float64"):
        kind = "halo." if k.startswith("stencil_halo_form.") else "cross."
        t = k.split(".")[1]
        rows[k]["launches_by_run"] = {
            run: w[kind + t] for run, w in multi_d.items()}
        rows[k]["launches_by_run"].update({
            f"GK-2d, {run}": w["GK-2d"][kind + t]
            for run, w in multi3_d.items()})
    for t in ("float32", "float64"):
        rows[f"stencil_halo_form.{t}"]["launches_by_form"] = {
            f: sum(w[f"form.{f}.{t}"] for w in multi_d.values())
            for f in ("apply", "residual", "jacobi")}
        rows[f"stencil_halo.{t}"]["main_path"] = (
            f"replaced by stencil_halo_form.{t}: a sharded level's apply, "
            "residual or slab Jacobi update is one halo-form launch that "
            "reads the neighbours' planes where they arrived; the cross "
            "form on the extended block stays for halo_apply")
    for k in ("stencil_halo_stag.float32", "stencil_halo_stag.float64"):
        rows[k]["launches_by_run"] = {
            run: w["halo." + k.split(".")[1]] for run, w in multi2_d.items()}
        rows[k]["launches_by_run"].update({
            f"SK-2d, {run}": w["SK-2d"]["halo." + k.split(".")[1]]
            for run, w in multi3_d.items()})
    for k in ("stencil_block.float32", "stencil_block.float64"):
        t = k.split(".")[1]
        rows[k]["launches_by_run"] = dict(
            {"systems window (phase 13)": systems[k]},
            **{f"phase 20, {run}": w["block." + t]
               for run, w in multi2_d.items()},
            **{f"SK-2d, {run}": w["SK-2d"]["block." + t]
               for run, w in multi3_d.items()})
    for k, row in rows.items():
        if k.startswith(("stencil_cross.", "stencil_halo_stag.")):
            # a systems level's blocks run together on the block form;
            # these forms stay for single blocks
            row["main_path"] = (
                "replaced by stencil_block." + k.split(".")[1] + ": a "
                "systems level's apply and residual are one block-form "
                "launch; this form stays for single blocks "
                "(CrossGridStencil.matvec, halo_apply)")
    for k in ("stencil3d_apply.matvec", "stencil.float32", "stencil.float64"):
        rows[k]["launches_aniso"] = aniso[k]
    for k in ("stencil.float32", "stencil.float64"):
        rows[k]["launches_amg"] = amg[k]
        rows[k]["launches_classical"] = classical[k]
        rows[k]["launches_systems"] = systems[k]
    require(len(CAPTURED) == CAPTURED_PATHS, f"the captured phase "
            f"compared {len(CAPTURED)} paths, want {CAPTURED_PATHS}")
    forms = [r.get("loop_form", "not read") for r in CAPTURED]
    log("[captured] loop forms: " + ", ".join(
        f"{forms.count(f)} {f}" for f in sorted(set(forms))) + "; programs: "
        + "; ".join(r["label"] for r in CAPTURED
                    if r.get("loop_form") == "programs"))
    log("[captured] " + json.dumps({"paths": CAPTURED, "chunks": sweep}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: row[k] for k in keys},
         **{k: v for k, v in row.items() if k not in keys}}
        for row in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
