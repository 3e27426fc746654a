"""Grouped (per-expert) matmul x [E,C,d] @ w [E,d,f] -> [E,C,f], and its
gradients.

Counterpart of `repro/kernels/moe_gemm.py` (`moe_gemm_pallas`). For CUDA
tensors `moe_gemm` goes through an autograd Function whose forward and
backward launch hand-written Hopper kernels in `csrc/moe_gemm.cu` (its
note gives the bounds and the designs), picked by dtype: bf16 runs on the
tensor cores (`wgmma` fed by TMA), f32 on the CUDA cores. The backward
launches `moe_gemm_bwd_dx` (dy w^T) and `moe_gemm_bwd_dw` (x^T dy), only
the ones autograd asks for; the JAX package has no backward kernel and
differentiates its jnp oracle. For CPU tensors `moe_gemm` computes the
plain version, `ref.moe_gemm_ref`, which autograd differentiates. Nothing
sends a CUDA tensor to the plain version. `moe_gemm.launches`,
`moe_gemm_bwd_dx.launches` and `moe_gemm_bwd_dw.launches` count kernel
launches of both dtypes. TMA needs 16-byte row strides, so bf16 operands
have d and f zero-padded to multiples of 8 (`pad_for_tma`) and the
outputs are sliced back, as the JAX wrapper pads to its blocks.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .ref import moe_gemm_dw_ref, moe_gemm_dx_ref, moe_gemm_ref

_ROUTE = {torch.bfloat16: "bf16", torch.float32: "f32"}
_KERNELS = ("moe_gemm", "moe_gemm_bwd_dx", "moe_gemm_bwd_dw")
_MAX_EXPERTS = 65535            # the kernels' grid.z (grid.y: forward f32)
_TMA_ALIGN = 8                  # bf16 elements in TMA's 16-byte stride unit


@functools.cache
def _lib() -> ctypes.CDLL:
    return load(_build.build("moe_gemm"))


def load(path) -> ctypes.CDLL:
    """A built moe_gemm library with its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    for kname in _KERNELS:
        for route in _ROUTE.values():
            fn = getattr(lib, f"{kname}_{route}")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.moe_gemm_error_string.argtypes = [ctypes.c_int]
    lib.moe_gemm_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, a: torch.Tensor, b: torch.Tensor,
           e_c_d_f: tuple[int, int, int, int]) -> None:
    """Operands of one of `_KERNELS`, whose problem is (E, C, d, f)."""
    if min(e_c_d_f) == 0 or e_c_d_f[0] > _MAX_EXPERTS:
        raise ValueError(f"{name} takes 1..{_MAX_EXPERTS} experts and "
                         f"non-empty dims, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _ROUTE:
        raise TypeError(f"{name} takes bf16 or f32 operands of one dtype, "
                        f"got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{name} operands on {a.device} and {b.device}")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} takes contiguous operands")


def _dims(name: str, a: torch.Tensor, b: torch.Tensor, a_dims: str,
          b_dims: str) -> tuple[int, int, int, int]:
    """(E, C, d, f) from 3-D operands whose dims are named by `a_dims` and
    `b_dims` (e.g. "ecd", "edf"); raises if they disagree."""
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"{name} wants {a_dims} and {b_dims} operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    sizes = {}
    for dims, t in ((a_dims, a), (b_dims, b)):
        for k, n in zip(dims, t.shape):
            if sizes.setdefault(k, n) != n:
                raise ValueError(f"{name} shapes disagree: {a_dims} "
                                 f"{tuple(a.shape)}, {b_dims} "
                                 f"{tuple(b.shape)}")
    return tuple(sizes[k] for k in "ecdf")


def _up(n: int) -> int:
    return -(-n // _TMA_ALIGN) * _TMA_ALIGN


def _tma_operand(t: torch.Tensor, rows: bool) -> torch.Tensor:
    """t [E,R,K] with K, and R too if `rows`, zero-padded up to multiples
    of 8, at a 16-byte-aligned address; t itself if it already fits."""
    r, k = t.shape[1:]
    rp = _up(r) if rows else r
    if (rp, _up(k)) != (r, k):
        t = F.pad(t, (0, _up(k) - k, 0, rp - r))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def pad_for_tma(x: torch.Tensor, w: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [E,C,d] and w [E,d,f] with d and f zero-padded up to multiples of
    8, and each operand at a 16-byte-aligned address: what the bf16
    kernels' TMA loads need. The padding adds zero products; slice the
    output back to f columns. Operands that already fit are returned as
    they are."""
    return _tma_operand(x, rows=False), _tma_operand(w, rows=True)


def _launch(kname: str, a: torch.Tensor, b: torch.Tensor,
            out: torch.Tensor, e: int, c: int, d: int, f: int) -> None:
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = getattr(lib, f"{kname}_{_ROUTE[a.dtype]}")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), e, c, d, f, stream)
    if err:
        raise RuntimeError(f"{kname} launch failed: "
                           f"{lib.moe_gemm_error_string(err).decode()} ({err})")


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward kernel on CUDA operands that passed the checks."""
    f = w.shape[2]
    if x.dtype == torch.bfloat16:
        x, w = pad_for_tma(x, w)
    e, c, d = x.shape
    fp = w.shape[2]
    out = torch.empty((e, c, fp), dtype=x.dtype, device=x.device)
    _launch("moe_gemm", x, w, out, e, c, d, fp)
    moe_gemm.launches += 1
    return out if fp == f else out[..., :f].contiguous()


def moe_gemm_bwd_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx [E,C,d] = dy [E,C,f] @ w[E,d,f]^T, f32 accumulation, in dy's
    dtype: one kernel launch on CUDA, the plain version on the CPU."""
    e, c, d, f = _dims("moe_gemm_bwd_dx", dy, w, "ecf", "edf")
    _check("moe_gemm_bwd_dx", dy, w, (e, c, d, f))
    if dy.device.type == "cpu":
        return moe_gemm_dx_ref(dy, w)
    if dy.dtype == torch.bfloat16:
        dy, w = _tma_operand(dy, rows=False), _tma_operand(w, rows=True)
    dp, fp = w.shape[1:]
    dx = torch.empty((e, c, dp), dtype=dy.dtype, device=dy.device)
    _launch("moe_gemm_bwd_dx", dy, w, dx, e, c, dp, fp)
    moe_gemm_bwd_dx.launches += 1
    return dx if dp == d else dx[..., :d].contiguous()


def moe_gemm_bwd_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw [E,d,f] = x[E,C,d]^T @ dy [E,C,f], f32 accumulation, in dy's
    dtype: one kernel launch on CUDA, the plain version on the CPU."""
    e, c, d, f = _dims("moe_gemm_bwd_dw", x, dy, "ecd", "ecf")
    _check("moe_gemm_bwd_dw", x, dy, (e, c, d, f))
    if x.device.type == "cpu":
        return moe_gemm_dw_ref(x, dy)
    if x.dtype == torch.bfloat16:
        x, dy = _tma_operand(x, rows=False), _tma_operand(dy, rows=False)
    dp, fp = x.shape[2], dy.shape[2]
    dw = torch.empty((e, dp, fp), dtype=x.dtype, device=x.device)
    _launch("moe_gemm_bwd_dw", x, dy, dw, e, c, dp, fp)
    moe_gemm_bwd_dw.launches += 1
    return dw if (dp, fp) == (d, f) else dw[:, :d, :f].contiguous()


class _MoEGemm(torch.autograd.Function):
    """Forward and backward through the kernels; saves x and w."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = moe_gemm_bwd_dx(dy, w) if ctx.needs_input_grad[0] else None
        dw = moe_gemm_bwd_dw(x, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E,C,d] @ w [E,d,f] -> [E,C,f], f32 accumulation, x's dtype;
    differentiable on both devices."""
    dims = _dims("moe_gemm", x, w, "ecd", "edf")
    _check("moe_gemm", x, w, dims)
    if x.device.type == "cpu":           # autograd over the plain version
        return moe_gemm_ref(x, w)
    return _MoEGemm.apply(x, w)


moe_gemm.launches = 0
moe_gemm_bwd_dx.launches = 0
moe_gemm_bwd_dw.launches = 0
