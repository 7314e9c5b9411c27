"""Build script for mgtpu's native host-setup extension.

The device compute path is JAX/XLA/Pallas and needs no compilation; this
builds the optional C++ host-setup kernels (mgtpu/native/setup_kernels.cpp).
They are also built lazily at import time by mgtpu.utils.native, so running
this is never required — it just pre-builds.

The repository's second package, mgtpu_torch (the PyTorch/CUDA port),
needs no step here: it builds its CUDA kernels (mgtpu_torch/csrc) with nvcc
at first use on a machine with a card (mgtpu_torch/ops/cuda/_build.py).
"""
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).parent / "mgtpu" / "native" / "setup_kernels.cpp"
OUT = SRC.parent / "_build" / "libmgtpu_setup.so"


def build():
    OUT.parent.mkdir(exist_ok=True)
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", str(SRC),
           "-o", str(OUT)]
    print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    print(f"built {OUT}")


if __name__ == "__main__":
    build()
