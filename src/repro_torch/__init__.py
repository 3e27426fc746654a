"""PyTorch/CUDA port of the `repro` model stack and serving engine.

The package mirrors `repro`'s file layout so each module's counterpart is
easy to find, imports `torch`, numpy and the standard library only, and
keeps its own copy of the `repro.core` pieces it needs. Kernels that the
JAX package wrote in Pallas for the TPU are hand-written CUDA C++ for
Hopper (`kernels/csrc/`), built with `nvcc` at first use.

Entry points take a `device` that defaults to ``"cuda"`` and raise when
no GPU is present unless the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
