"""Grouped (per-expert) matmul x [E,C,d] @ w [E,d,f] -> [E,C,f].

Counterpart of `repro/kernels/moe_gemm.py` (`moe_gemm_pallas`). For CUDA
tensors `moe_gemm` launches a hand-written Hopper kernel in
`csrc/moe_gemm.cu` (its note gives the bounds and the designs), picked by
dtype: bf16 runs on the tensor cores (`wgmma` fed by TMA), f32 on the CUDA
cores. For CPU tensors it computes the plain version, `ref.moe_gemm_ref`.
Nothing sends a CUDA tensor to the plain version. `moe_gemm.launches`
counts kernel launches of both dtypes. TMA needs 16-byte row strides, so
`pad_for_tma` zero-pads d and f of bf16 operands to multiples of 8 and the
output is sliced back, as the JAX wrapper pads to its blocks. The kernels
have no backward yet: a CUDA call that autograd would have to
differentiate raises rather than return an output that no gradient
reaches.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .ref import moe_gemm_ref

_ENTRY = {torch.bfloat16: "moe_gemm_bf16", torch.float32: "moe_gemm_f32"}
_MAX_EXPERTS = 65535            # the kernels' grid.y (f32) and grid.z (bf16)
_TMA_ALIGN = 8                  # bf16 elements in TMA's 16-byte stride unit


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


def pad_for_tma(x: torch.Tensor, w: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [E,C,d] and w [E,d,f] with d and f zero-padded up to multiples of
    8, and each operand at a 16-byte-aligned address: what the bf16
    kernel's TMA loads need. The padding adds zero products; slice the
    output back to f columns. Operands that already fit are returned as
    they are."""
    d, f = x.shape[2], w.shape[2]
    dp, fp = (-(-n // _TMA_ALIGN) * _TMA_ALIGN for n in (d, f))
    if dp != d:
        x = F.pad(x, (0, dp - d))
    if (dp, fp) != (d, f):
        w = F.pad(w, (0, fp - f, 0, dp - d))
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x, w))


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E,C,d] @ w [E,d,f] -> [E,C,f], f32 accumulation, x's dtype."""
    _check(x, w)
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "moe_gemm's backward is not ported yet: call it under "
            "torch.no_grad() or torch.inference_mode(), or on operands "
            "that do not require grad")
    f = w.shape[2]
    if x.dtype == torch.bfloat16:
        x, w = pad_for_tma(x, w)
    e, c, d = x.shape
    fp = w.shape[2]
    out = torch.empty((e, c, fp), dtype=x.dtype, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _ENTRY[x.dtype])(x.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), e, c, d, fp, stream)
    if err:
        raise RuntimeError(f"moe_gemm launch failed: "
                           f"{lib.moe_gemm_error_string(err).decode()} ({err})")
    moe_gemm.launches += 1
    return out if fp == f else out[..., :f].contiguous()


moe_gemm.launches = 0
