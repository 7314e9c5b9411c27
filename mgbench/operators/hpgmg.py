"""Operator "hpgmg" on the program's side: its nodal DivSigGrad on the cell
conductivities of reference/hpgmg.py's inputs, set up by `mg_setup`."""
from mgbench.operators._nodal import levels, setup  # noqa: F401
