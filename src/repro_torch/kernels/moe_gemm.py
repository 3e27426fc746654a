"""Grouped (per-expert) matmul x [E,C,d] @ w [E,d,f] -> [E,C,f].

Counterpart of `repro/kernels/moe_gemm.py` (`moe_gemm_pallas`). For CUDA
tensors `moe_gemm` launches the hand-written Hopper kernel in
`csrc/moe_gemm.cu` (its note gives the bound and the design); for CPU
tensors it computes the plain version, `ref.moe_gemm_ref`. Nothing sends a
CUDA tensor to the plain version. `moe_gemm.launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import moe_gemm_ref

_ENTRY = {torch.bfloat16: "moe_gemm_bf16", torch.float32: "moe_gemm_f32"}
_MAX_EXPERTS = 65535            # the kernel's grid.y


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("moe_gemm")))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.moe_gemm_error_string.argtypes = [ctypes.c_int]
    lib.moe_gemm_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"moe_gemm wants x [E,C,d] and w [E,d,f], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    e, c, d = x.shape
    if w.shape[0] != e or w.shape[1] != d:
        raise ValueError(f"moe_gemm shapes disagree: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if min(e, c, d, w.shape[2]) == 0 or e > _MAX_EXPERTS:
        raise ValueError(f"moe_gemm takes 1..{_MAX_EXPERTS} experts and "
                         f"non-empty dims, got x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _ENTRY:
        raise TypeError(f"moe_gemm takes bf16 or f32 operands of one dtype, "
                        f"got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"moe_gemm operands on {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gemm takes contiguous operands")


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E,C,d] @ w [E,d,f] -> [E,C,f], f32 accumulation, x's dtype."""
    _check(x, w)
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm runs on cuda or cpu, not {x.device}")
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _ENTRY[x.dtype])(x.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), e, c, d, f, stream)
    if err:
        raise RuntimeError(f"moe_gemm launch failed: "
                           f"{lib.moe_gemm_error_string(err).decode()} ({err})")
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0
