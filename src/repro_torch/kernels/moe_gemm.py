"""Grouped (per-expert) matmul x [E,C,d] @ w [E,d,f] -> [E,C,f], and its
gradients.

Counterpart of `repro/kernels/moe_gemm.py` (`moe_gemm_pallas`). For CUDA
tensors `moe_gemm` goes through an autograd Function whose forward and
backward launch hand-written Hopper kernels in `csrc/moe_gemm.cu` (its
note gives the bounds and the designs), picked by dtype: bf16 runs on the
tensor cores (`wgmma` fed by TMA), f32 on the CUDA cores, where one tiled
and pipelined GEMM computes the forward, dx and dw. The f32 forward takes
128 x 128 output tiles, or 16 x 256 where an expert has at most
`F32_NARROW_MAX_C` rows (decode; `forward_entry` picks the C entry
point); both sum each output over ascending k in one chain, so a row's
result does not depend on C. The backward launches `moe_gemm_bwd_dx`
(dy w^T) and `moe_gemm_bwd_dw` (x^T dy), only the ones autograd asks for;
the JAX package has no backward kernel and differentiates its jnp oracle.
For CPU tensors `moe_gemm` computes the plain version, `ref.moe_gemm_ref`,
which autograd differentiates. Nothing sends a CUDA tensor to the plain
version. `moe_gemm.launches`, `moe_gemm_bwd_dx.launches` and
`moe_gemm_bwd_dw.launches` count kernel launches of both dtypes. TMA and
cp.async need 16-byte rows, so d and f of the operands are zero-padded to
multiples of 8 (bf16) or 4 (f32) elements (`pad_operands`) and the
outputs are sliced back, as the JAX wrapper pads to its blocks. Each CUDA
call's host side (padding, TMA tensor maps, argument packing) and launch
is one profiler range while a PyTorch profiler records
(`port.kernel.moe_gemm`, `.moe_gemm_dx`, `.moe_gemm_dw`).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..core.trace import span
from . import _build
from .ref import moe_gemm_dw_ref, moe_gemm_dx_ref, moe_gemm_ref

_ROUTE = {torch.bfloat16: "bf16", torch.float32: "f32"}
# the C entry points: each kernel's, by route
ENTRIES = ("moe_gemm_bf16", "moe_gemm_f32", "moe_gemm_f32_narrow",
           "moe_gemm_bwd_dx_bf16", "moe_gemm_bwd_dx_f32",
           "moe_gemm_bwd_dw_bf16", "moe_gemm_bwd_dw_f32")
_MAX_EXPERTS = 65535            # the kernels' grid.z
_TMA_ALIGN = 8                  # bf16 elements in TMA's 16-byte stride unit
# elements in the kernels' 16-byte row unit (TMA; cp.async and float4)
_ALIGN = {torch.bfloat16: _TMA_ALIGN, torch.float32: 4}
# the f32 forward's largest C in 16-row tiles (moe_gemm_f32_narrow); from
# the C sweep that chip_smoke.py prints (phase 3)
F32_NARROW_MAX_C = 64


@functools.cache
def _lib() -> ctypes.CDLL:
    return load(_build.build("moe_gemm"))


def load(path, entries=ENTRIES) -> ctypes.CDLL:
    """A built moe_gemm library with its C entry points `entries` typed."""
    lib = ctypes.CDLL(str(path))
    for entry in entries:
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.moe_gemm_error_string.argtypes = [ctypes.c_int]
    lib.moe_gemm_error_string.restype = ctypes.c_char_p
    return lib


def forward_entry(dtype: torch.dtype, c: int) -> str:
    """The C entry point of the forward for `dtype` operands with `c` rows
    an expert: the f32 forward takes 16-row tiles up to F32_NARROW_MAX_C
    rows, 128-row tiles above."""
    if dtype == torch.float32 and c <= F32_NARROW_MAX_C:
        return "moe_gemm_f32_narrow"
    return f"moe_gemm_{_ROUTE[dtype]}"


def _check(name: str, a: torch.Tensor, b: torch.Tensor,
           e_c_d_f: tuple[int, int, int, int]) -> None:
    """Operands of one of the kernels, whose problem is (E, C, d, f)."""
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


def _up(n: int, align: int) -> int:
    return -(-n // align) * align


def _tma_operand(t: torch.Tensor, rows: bool,
                 align: int = _TMA_ALIGN) -> torch.Tensor:
    """t [E,R,K] with K, and R too if `rows`, zero-padded up to multiples
    of `align` (8: TMA's unit in bf16), at a 16-byte-aligned address; t
    itself if it already fits."""
    r, k = t.shape[1:]
    rp = _up(r, align) if rows else r
    if (rp, _up(k, align)) != (r, k):
        t = F.pad(t, (0, _up(k, align) - k, 0, rp - r))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def pad_for_tma(x: torch.Tensor, w: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [E,C,d] and w [E,d,f] with d and f zero-padded up to multiples of
    8, and each operand at a 16-byte-aligned address: what the bf16
    kernels' TMA loads need. The padding adds zero products; slice the
    output back to f columns. Operands that already fit are returned as
    they are."""
    return _tma_operand(x, rows=False), _tma_operand(w, rows=True)


def pad_operands(a: torch.Tensor, b: torch.Tensor, b_rows: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The operands of a kernel (the forward's x, w; dx's dy, w; dw's x,
    dy) with their last dim, and b's rows too if `b_rows` (w's d), zero-
    padded to 16-byte rows of their dtype (8 bf16 or 4 f32 elements), at
    16-byte-aligned addresses. The padding adds zero products."""
    align = _ALIGN[a.dtype]
    return (_tma_operand(a, rows=False, align=align),
            _tma_operand(b, rows=b_rows, align=align))


def _sliced(out: torch.Tensor, *dims: int) -> torch.Tensor:
    """out with its last len(dims) dims cut back to `dims`: a padded
    kernel output sliced to the caller's shape (out itself if it fits)."""
    if tuple(out.shape[-len(dims):]) == dims:
        return out
    return out[(..., *(slice(0, n) for n in dims))].contiguous()


def _launch(entry: str, a: torch.Tensor, b: torch.Tensor,
            out: torch.Tensor, e: int, c: int, d: int, f: int) -> None:
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = getattr(lib, entry)(a.data_ptr(), b.data_ptr(), out.data_ptr(), e,
                              c, d, f, stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.moe_gemm_error_string(err).decode()} ({err})")


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward kernel on CUDA operands that passed the checks."""
    with span("port.kernel.moe_gemm"):
        f = w.shape[2]
        x, w = pad_operands(x, w, b_rows=True)
        e, c, d = x.shape
        fp = w.shape[2]
        out = torch.empty((e, c, fp), dtype=x.dtype, device=x.device)
        _launch(forward_entry(x.dtype, c), x, w, out, e, c, d, fp)
        moe_gemm.launches += 1
        return _sliced(out, f)


def moe_gemm_bwd_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx [E,C,d] = dy [E,C,f] @ w[E,d,f]^T, f32 accumulation, in dy's
    dtype: one kernel launch on CUDA, the plain version on the CPU."""
    e, c, d, f = _dims("moe_gemm_bwd_dx", dy, w, "ecf", "edf")
    _check("moe_gemm_bwd_dx", dy, w, (e, c, d, f))
    if dy.device.type == "cpu":
        return moe_gemm_dx_ref(dy, w)
    with span("port.kernel.moe_gemm_dx"):
        dy, w = pad_operands(dy, w, b_rows=True)
        dp, fp = w.shape[1:]
        dx = torch.empty((e, c, dp), dtype=dy.dtype, device=dy.device)
        _launch(f"moe_gemm_bwd_dx_{_ROUTE[dy.dtype]}", dy, w, dx, e, c, dp,
                fp)
        moe_gemm_bwd_dx.launches += 1
        return _sliced(dx, d)


def moe_gemm_bwd_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw [E,d,f] = x[E,C,d]^T @ dy [E,C,f], f32 accumulation, in dy's
    dtype: one kernel launch on CUDA, the plain version on the CPU."""
    e, c, d, f = _dims("moe_gemm_bwd_dw", x, dy, "ecd", "ecf")
    _check("moe_gemm_bwd_dw", x, dy, (e, c, d, f))
    if x.device.type == "cpu":
        return moe_gemm_dw_ref(x, dy)
    with span("port.kernel.moe_gemm_dw"):
        x, dy = pad_operands(x, dy, b_rows=False)
        dp, fp = x.shape[2], dy.shape[2]
        dw = torch.empty((e, dp, fp), dtype=x.dtype, device=x.device)
        _launch(f"moe_gemm_bwd_dw_{_ROUTE[x.dtype]}", x, dy, dw, e, c, dp,
                fp)
        moe_gemm_bwd_dw.launches += 1
        return _sliced(dw, d, f)


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
