"""PyTorch/CUDA port of the VLN-GOAT navigation system.

The JAX package `vln_goat_tpu` is the reference; this package keeps its
layout and module names and imports nothing of it.  Entry points take an
explicit `device` (default ``"cuda"``); the hand-written CUDA kernels live
under `ops/csrc/` and are built with nvcc at first use (`ops/_build.py`).
"""
