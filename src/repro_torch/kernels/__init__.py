"""Kernels: CUDA sources in csrc/, their wrappers, and the plain
versions in ref.py."""
