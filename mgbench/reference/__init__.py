"""The benchmark's plain reference: torch (float64) and numpy only.

Imports nothing of the program and takes nothing the program made: the
fine operators are assembled again, matrix-free, from the same mesh sizes
and coefficients the benchmark handed the program, the coarse operators are
worked out again from them through full weighting, and the program's
answers and level operators are only read to be judged.
"""
