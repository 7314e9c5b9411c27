"""Krylov methods on (m, *space) fields (the KrylovMethods.jl surface the
reference's solve functions use)."""
from .cg import pcg
from .bicgstab import bicgstab
from .fgmres import fgmres, block_fgmres
from .block import block_pcg, block_bicgstab

__all__ = ["pcg", "bicgstab", "fgmres", "block_fgmres",
           "block_pcg", "block_bicgstab"]
