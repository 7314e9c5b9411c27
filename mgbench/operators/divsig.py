"""Operator "divsig" on the program's side: its nodal DivSigGrad on the cell
conductivities of reference/divsig.py's inputs, set up by `mg_setup`."""
from mgbench.operators._nodal import levels, setup  # noqa: F401
