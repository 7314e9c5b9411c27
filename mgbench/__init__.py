"""The benchmark of mgtpu_torch: time to a certified solution, driven by
BENCHMARK.json and the files under this folder (see mgbench/run.py)."""
