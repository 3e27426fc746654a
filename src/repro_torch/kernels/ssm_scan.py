"""Mamba's selective scan and the generic linear scan over axis 1.

Counterpart of `repro/kernels/ssm_scan.py` (`selective_scan_pallas`,
`ssm_scan_pallas`). For CUDA tensors `selective_scan` and `ssm_scan`
launch the hand-written Hopper kernels in `csrc/ssm_scan.cu` (its note
gives the bound and the design); for CPU tensors they compute the plain
versions, `ref.selective_scan_ref` and `ref.ssm_scan_ref`. Nothing sends a
CUDA tensor to a plain version. `selective_scan.launches` and
`ssm_scan.launches` count kernel launches. Neither kernel has a backward,
here or in the JAX package: a CUDA call that autograd would have to
differentiate raises rather than return an output that no gradient
reaches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .ref import selective_scan_ref, ssm_scan_ref

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_MAX_BATCH = 65535              # the kernels' grid.y
_MAX_STATE = 16                 # lanes of one channel (csrc/ssm_scan.cu)


class _SelArgs(ctypes.Structure):
    """Mirror of `SelScanArgs` in csrc/ssm_scan.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("x", "dt", "a_log", "b", "c", "d", "h0", "y", "h_last")]
                + [(f"{t}_s{s}", ctypes.c_longlong)
                   for t in ("x", "dt", "b", "c") for s in "bs"]
                + [(n, ctypes.c_int) for n in ("B", "S", "D", "N")])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("ssm_scan")))
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"selective_scan_{suffix}")
        fn.argtypes = [ctypes.POINTER(_SelArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"ssm_scan_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{_lib().ssm_scan_error_string(err).decode()} "
                           f"({err})")


def _on_cuda(name: str, tensors) -> bool:
    """True for CUDA operands, False for CPU ones; raises for any other
    device, and on CUDA when autograd would need the missing backward."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name} operands on "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}'s backward is not ported yet: call it under "
            "torch.no_grad() or torch.inference_mode(), or on operands "
            "that do not require grad")
    return True


def _unit_inner(t: torch.Tensor) -> torch.Tensor:
    """`t` if its last dim is contiguous, else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _check_sel(x, dt, a_log, b, c, d, h0) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"selective_scan wants x and dt [B,S,D], got "
                         f"{tuple(x.shape)} and {tuple(dt.shape)}")
    bsz, s, dd = x.shape
    if a_log.dim() != 2 or a_log.shape[0] != dd:
        raise ValueError(f"selective_scan wants a_log [D={dd},N], got "
                         f"{tuple(a_log.shape)}")
    n = a_log.shape[1]
    for name, t, want in (("b", b, (bsz, s, n)), ("c", c, (bsz, s, n)),
                          ("d", d, (dd,)), ("h0", h0, (bsz, dd, n))):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"selective_scan wants {name} {want}, got "
                             f"{tuple(t.shape)}")
    if min(bsz, s, dd, n) == 0 or bsz > _MAX_BATCH:
        raise ValueError(f"selective_scan takes 1..{_MAX_BATCH} batch rows "
                         f"and non-empty dims, got x {tuple(x.shape)}, "
                         f"N={n}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, b, c)):
        raise TypeError(f"selective_scan takes x, dt, b, c of one dtype, "
                        f"bf16 or f32, got {x.dtype}, {dt.dtype}, {b.dtype}, "
                        f"{c.dtype}")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x/dt [B,S,D]; a_log [D,N]; b/c [B,S,N]; d [D]; h0 [B,D,N] ->
    (y [B,S,D] in x's dtype, h_last [B,D,N] f32). a_log, d and h0 are
    taken in f32. x, dt, b and c may be strided (b and c are column
    slices of the x_proj output on the Mamba path) as long as their last
    dim is contiguous."""
    _check_sel(x, dt, a_log, b, c, d, h0)
    ops = [x, dt, a_log, b, c, d] + ([] if h0 is None else [h0])
    if not _on_cuda("selective_scan", ops):
        return selective_scan_ref(x, dt, a_log, b, c, d, h0)
    bsz, s, dd = x.shape
    n = a_log.shape[1]
    if n > _MAX_STATE:
        raise ValueError(f"selective_scan's kernel takes N <= {_MAX_STATE}, "
                         f"got {n}")
    x, dt, b, c = (_unit_inner(t) for t in (x, dt, b, c))
    a_log = a_log.float().contiguous()
    d = d.float().contiguous()
    h0 = (torch.zeros((bsz, dd, n), dtype=torch.float32, device=x.device)
          if h0 is None else h0.float().contiguous())
    y = torch.empty((bsz, s, dd), dtype=x.dtype, device=x.device)
    h_last = torch.empty((bsz, dd, n), dtype=torch.float32, device=x.device)
    args = _SelArgs(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                    b.data_ptr(), c.data_ptr(), d.data_ptr(), h0.data_ptr(),
                    y.data_ptr(), h_last.data_ptr(),
                    x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
                    b.stride(0), b.stride(1), c.stride(0), c.stride(1),
                    bsz, s, dd, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = getattr(_lib(), f"selective_scan_{_DTYPES[x.dtype]}")
    _raise_on(fn(ctypes.byref(args), stream), "selective_scan")
    selective_scan.launches += 1
    return y, h_last


def ssm_scan(a: torch.Tensor, bx: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear recurrence h_t = a_t h_{t-1} + bx_t over axis 1: a/bx
    [B,S,D] of one dtype (bf16 or f32), h0 [B,D] taken in f32 -> every h_t
    [B,S,D] in bx's dtype."""
    if a.dim() != 3 or bx.shape != a.shape:
        raise ValueError(f"ssm_scan wants a and bx [B,S,D], got "
                         f"{tuple(a.shape)} and {tuple(bx.shape)}")
    bsz, s, dd = a.shape
    if h0 is not None and tuple(h0.shape) != (bsz, dd):
        raise ValueError(f"ssm_scan wants h0 {(bsz, dd)}, got "
                         f"{tuple(h0.shape)}")
    if min(bsz, s, dd) == 0 or bsz > _MAX_BATCH:
        raise ValueError(f"ssm_scan takes 1..{_MAX_BATCH} batch rows and "
                         f"non-empty dims, got {tuple(a.shape)}")
    if a.dtype != bx.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"ssm_scan takes a and bx of one dtype, bf16 or "
                        f"f32, got {a.dtype} and {bx.dtype}")
    if not _on_cuda("ssm_scan", [a, bx] + ([] if h0 is None else [h0])):
        return ssm_scan_ref(a, bx, h0)
    a, bx = a.contiguous(), bx.contiguous()
    h0 = (torch.zeros((bsz, dd), dtype=torch.float32, device=a.device)
          if h0 is None else h0.float().contiguous())
    out = torch.empty_like(bx)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    fn = getattr(_lib(), f"ssm_scan_{_DTYPES[a.dtype]}")
    _raise_on(fn(a.data_ptr(), bx.data_ptr(), h0.data_ptr(), out.data_ptr(),
                 bsz, s, dd, stream), "ssm_scan")
    ssm_scan.launches += 1
    return out


selective_scan.launches = 0
ssm_scan.launches = 0
