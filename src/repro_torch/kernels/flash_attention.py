"""Flash attention, forward and backward: q [B,S,nq,hd], k/v [B,T,nkv,hd]
-> o [B,S,nq,hd], with GQA, a causal mask, a sliding window and tanh
softcapping.

Counterpart of `repro/kernels/flash_attention.py` (`flash_attention`). For
CUDA tensors the functions here launch the hand-written Hopper kernels in
`csrc/flash_attention.cu` (its note gives the bound and the designs); the
forward and the backward pick their kernels by dtype: bf16 runs on the
tensor cores (`mma.sync`), f32 on the CUDA cores. For CPU tensors they
compute the plain versions, `ref.flash_attention_ref` and
`ref.flash_attention_bwd_ref`. Nothing sends a CUDA tensor to a plain
version. The kernels of both dtypes copy their inputs 16 bytes at a time
(`cp.async`, and 16-byte loads for the f32 kernels' resident tiles):
`cp_async_ready` hands them a contiguous copy of any input whose base or
strides are not 16-byte aligned.

- `flash_attention` is the differentiable entry point: on CUDA a
  `torch.autograd.Function` whose forward and backward are kernels; on the
  CPU the plain forward under autograd.
- `flash_attention_fwd` -> (o, lse) and `flash_attention_bwd` -> (dq, dk,
  dv) are the kernels' wrappers.

Launch counts: `flash_attention.launches` counts forward kernel launches,
`flash_attention_bwd.launches` backward kernel launches (`BWD_LAUNCHES`
per call: dq, then dk/dv in bf16; dq, dk/dv into one partial per query
head, then their sum over each group in f32). Each also counts its
launches by call in `by_shape`, a Counter keyed by `shape_key` (q's shape,
T, causal, window, softcap).
Each CUDA call of `flash_attention_fwd` or `flash_attention_bwd`, its host
side and its launches, is one profiler range while a PyTorch profiler
records (`port.kernel.flash_fwd`, `port.kernel.flash_bwd`).

As in the JAX kernel, the causal mask is start-aligned (query i sees keys
<= i); it equals the end-aligned mask of `ref.attention_ref` only when
S == T, so a call with a causal mask or a window must have S == T.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from ..core.trace import span
from . import _build
from .ref import flash_attention_bwd_ref, flash_attention_ref

HEAD_DIMS = (16, 64, 128)            # the kernels' instantiations
_DTYPES = (torch.bfloat16, torch.float32)
# backward launches a call: dq, dk/dv (and the f32 group sum)
BWD_LAUNCHES = {torch.bfloat16: 2, torch.float32: 3}
# Grids: bf16 (q tiles, q heads, batch) for the forward and dq and (kv
# heads, batch, k tiles of _KV_TILE keys) for dk/dv; f32 (q heads, batch,
# tiles) for all three, each tile at least _F32_TILE rows or keys, and
# (B * T * hd / 1024, kv heads) for the f32 group sum. Grid y and z take
# at most _MAX_GRID_YZ.
_MAX_GRID_YZ = 65535
_KV_TILE = 64
_F32_TILE = 64


class _Args(ctypes.Structure):
    """Mirror of `FlashArgs` in csrc/flash_attention.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "o", "dout", "out", "lse", "dsum", "dq",
                  "dk", "dv", "dk_part", "dv_part")]
                + [(f"{t}_s{d}", ctypes.c_longlong)
                   for t in ("q", "k", "v", "o", "do") for d in "bsh"]
                + [(n, ctypes.c_int) for n in
                   ("B", "S", "T", "nq", "nkv", "causal", "window")]
                + [("scale", ctypes.c_float), ("softcap", ctypes.c_float)])


_ENTRIES = ("flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkdv", "flash_attention_bwd_sum")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("flash_attention")))
    for name in _ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int], softcap: Optional[float]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q [B,S,nq,hd] and k, v "
                         f"[B,T,nkv,hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, nq, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or min(b, s, t, nq, nkv) == 0 \
            or nq % nkv:
        raise ValueError(f"flash_attention shapes disagree: q "
                         f"{tuple(q.shape)}, k/v {tuple(k.shape)}")
    if (causal or window is not None) and s != t:
        raise ValueError(f"flash_attention's causal mask and window are "
                         f"start-aligned and need S == T, got S={s}, T={t}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes bf16 or f32 inputs of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention inputs on {q.device}, {k.device}"
                         f", {v.device}")


def _check_cuda(*ts: torch.Tensor) -> None:
    q = ts[0]
    b, s, nq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernels take head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if b > _MAX_GRID_YZ or (q.dtype == torch.bfloat16
                            and nq > _MAX_GRID_YZ):
        raise ValueError(f"flash_attention takes at most {_MAX_GRID_YZ} "
                         f"batch rows (and bf16 heads), got {b} and {nq}")
    keys, nkv = ts[1].shape[1], ts[1].shape[2]
    if q.dtype == torch.float32 and (
            -(-max(s, keys) // _F32_TILE) > _MAX_GRID_YZ
            or nkv > _MAX_GRID_YZ):
        raise ValueError(f"flash_attention takes at most "
                         f"{_MAX_GRID_YZ * _F32_TILE} f32 queries and keys "
                         f"and {_MAX_GRID_YZ} kv heads, got S={s}, "
                         f"T={keys}, {nkv} kv heads")
    for t in ts:
        if t.stride(-1) != 1:
            raise ValueError("flash_attention needs a contiguous head dim "
                             f"(stride 1), got strides {t.stride()}")


def cp_async_ready(t: torch.Tensor) -> torch.Tensor:
    """`t` itself if its base address and its batch, sequence and head
    strides (those of dims longer than 1) are multiples of 16 bytes, else
    a contiguous copy: a layout step, the same values."""
    nbytes = t.element_size()
    if t.data_ptr() % 16 == 0 and all(
            st * nbytes % 16 == 0
            for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _kernel_inputs(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The tensors as the kernels read them, each through
    `cp_async_ready`: the kernels of both dtypes read 16 bytes at a
    time."""
    return tuple(cp_async_ready(t) for t in ts)


def _strides(args: _Args, name: str, t: torch.Tensor) -> None:
    sb, ss, sh, _ = t.stride()
    setattr(args, f"{name}_sb", sb)
    setattr(args, f"{name}_ss", ss)
    setattr(args, f"{name}_sh", sh)


def _args(q, k, v, causal, window, softcap) -> _Args:
    b, s, nq, hd = q.shape
    a = _Args(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), B=b, S=s,
              T=k.shape[1], nq=nq, nkv=k.shape[2], causal=int(causal),
              window=window or 0, scale=hd ** -0.5, softcap=softcap or 0.0)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _strides(a, name, t)
    return a


def _launch(entry: str, args: _Args, q: torch.Tensor) -> None:
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, entry)(ctypes.byref(args), q.shape[3],
                              int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}"
                           f" ({err})")


def shape_key(q: torch.Tensor, k: torch.Tensor, causal: bool,
              window: Optional[int], softcap: Optional[float]) -> tuple:
    """The key under which `by_shape` counts a call's launches."""
    return tuple(q.shape), k.shape[1], bool(causal), window, softcap


def _count(fn, key: tuple) -> None:
    """One launch of `fn`'s kernel: its total and its call's shape."""
    fn.launches += 1
    fn.by_shape[key] += 1


def _device_type(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return q.device.type


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False, window: Optional[int] = None,
                        softcap: Optional[float] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (o [B,S,nq,hd] in q's dtype, lse [B,nq,S] f32). On CUDA one
    kernel launch and no autograd graph; `flash_attention` is the
    differentiable entry point."""
    _check(q, k, v, causal, window, softcap)
    if _device_type(q) == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    with span("port.kernel.flash_fwd"):
        _check_cuda(q, k, v)
        q, k, v = _kernel_inputs(q, k, v)
        b, s, nq, hd = q.shape
        o = torch.empty((b, s, nq, hd), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, nq, s), dtype=torch.float32, device=q.device)
        args = _args(q, k, v, causal, window, softcap)
        args.out, args.lse = o.data_ptr(), lse.data_ptr()
        _launch("flash_attention_fwd", args, q)
        _count(flash_attention, shape_key(q, k, causal, window, softcap))
        return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = False, window: Optional[int] = None,
                        softcap: Optional[float] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of `flash_attention` from its inputs, its
    output o and lse, and dL/do; `BWD_LAUNCHES[dtype]` kernel launches on
    CUDA."""
    _check(q, k, v, causal, window, softcap)
    b, s, nq, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o and do must match q {tuple(q.shape)} "
                         f"{q.dtype}, got {tuple(o.shape)} {o.dtype} and "
                         f"{tuple(do.shape)} {do.dtype}")
    if lse.shape != (b, nq, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {(b, nq, s)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not (o.device == do.device == lse.device == q.device):
        raise ValueError("flash_attention_bwd inputs on several devices")
    if _device_type(q) == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, softcap=softcap)
    with span("port.kernel.flash_bwd"):
        args, _alive, grads = _bwd_args(q, k, v, o, lse, do, causal=causal,
                                        window=window, softcap=softcap)
        key = shape_key(q, k, causal, window, softcap)
        for entry in _BWD_ENTRIES[:BWD_LAUNCHES[q.dtype]]:
            _launch(entry, args, q)
            _count(flash_attention_bwd, key)
        return grads


# in this order on one stream: dq writes the D scratch that dk/dv reads;
# in f32 dk/dv writes the partials that the sum reads
_BWD_ENTRIES = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv",
                "flash_attention_bwd_sum")


def _bwd_args(q, k, v, o, lse, do, *, causal, window, softcap
              ) -> tuple[_Args, tuple, tuple[torch.Tensor, ...]]:
    """The backward kernels' arguments for CUDA tensors that passed
    `flash_attention_bwd`'s checks -> (args, the tensors args points into
    that the caller must keep alive, (dq, dk, dv) to be written). Launch
    the first `BWD_LAUNCHES[dtype]` of `_BWD_ENTRIES` in order."""
    _check_cuda(q, k, v, o, do)
    if not lse.is_contiguous():
        raise ValueError("flash_attention_bwd needs a contiguous lse")
    b, s, nq, hd = q.shape
    if q.dtype == torch.bfloat16 and -(-k.shape[1] // _KV_TILE) \
            > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention_bwd takes at most "
                         f"{_MAX_GRID_YZ * _KV_TILE} keys, got {k.shape[1]}")
    q, k, v, o, do = _kernel_inputs(q, k, v, o, do)
    dq = torch.empty((b, s, nq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    dsum = torch.empty((b, nq, s), dtype=torch.float32, device=q.device)
    args = _args(q, k, v, causal, window, softcap)
    _strides(args, "o", o)
    _strides(args, "do", do)
    args.o, args.dout, args.lse, args.dsum = (o.data_ptr(), do.data_ptr(),
                                              lse.data_ptr(), dsum.data_ptr())
    args.dq, args.dk, args.dv = dq.data_ptr(), dk.data_ptr(), dv.data_ptr()
    alive = (q, k, v, o, do, lse, dsum)
    if q.dtype == torch.float32:      # each query head's dK and dV
        parts = torch.empty((2, b, k.shape[1], nq, hd), dtype=torch.float32,
                            device=q.device)
        args.dk_part, args.dv_part = parts[0].data_ptr(), parts[1].data_ptr()
        alive += (parts,)
    return args, alive, (dq, dk, dv)


class _FlashAttention(torch.autograd.Function):
    """Forward and backward through the kernels; saves q, k, v, o, lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,S,nq,hd]; k/v [B,T,nkv,hd] -> o [B,S,nq,hd], differentiable."""
    if q.device.type == "cpu":           # autograd over the plain version
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap)[0]
    return _FlashAttention.apply(q, k, v, causal, window, softcap)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
flash_attention.by_shape = collections.Counter()
flash_attention_bwd.by_shape = collections.Counter()
