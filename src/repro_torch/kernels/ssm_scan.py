"""Mamba's selective scan and the generic linear scan over axis 1.

Counterpart of `repro/kernels/ssm_scan.py` (`selective_scan_pallas`,
`ssm_scan_pallas`). For CUDA tensors `selective_scan` and `ssm_scan`
launch the hand-written Hopper kernels in `csrc/ssm_scan.cu` (its note
gives the bound and the design); for CPU tensors they compute the plain
versions, `ref.selective_scan_ref` and `ref.ssm_scan_ref`. Nothing sends a
CUDA tensor to a plain version. `selective_scan.launches` and
`ssm_scan.launches` count kernel launches: one a call each (the linear
scan's look-back runs inside its one kernel; its flags are zeroed by a
`cudaMemsetAsync` before it, not by a kernel of this module). Neither
kernel has a backward,
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
_MAX_BATCH = 65535              # the selective scan's grid.y
_MAX_STATE = 16                 # states a channel (csrc/ssm_scan.cu: kNP)


class _SelArgs(ctypes.Structure):
    """Mirror of `SelScanArgs` in csrc/ssm_scan.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("x", "dt", "a_log", "b", "c", "d", "h0", "y", "h_last")]
                + [(f"{t}_s{s}", ctypes.c_longlong)
                   for t in ("x", "dt", "b", "c") for s in "bs"]
                + [(n, ctypes.c_int) for n in ("B", "S", "D", "N")])


class _LinArgs(ctypes.Structure):
    """Mirror of `LinScanArgs` in csrc/ssm_scan.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("a", "bx", "h0", "out", "tile_state", "agg", "incl")]
                + [(n, ctypes.c_int) for n in ("B", "S", "D", "vec")])


@functools.cache
def _lib() -> ctypes.CDLL:
    return load(_build.build("ssm_scan"))


@functools.cache
def _lin_tile() -> tuple[int, int]:
    """(steps, channels) of a linear-scan tile."""
    return _lib().ssm_scan_tile(0), _lib().ssm_scan_tile(1)


def load(path) -> ctypes.CDLL:
    """A built ssm_scan library with its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"selective_scan_{suffix}")
        fn.argtypes = [ctypes.POINTER(_SelArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"ssm_scan_{suffix}")
        fn.argtypes = [ctypes.POINTER(_LinArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("ssm_scan_tile", "ssm_scan_blocks_per_sm",
                 "selective_scan_smem_bytes", "selective_scan_blocks_per_sm",
                 "selective_scan_split"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
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


def aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """`t` [B,S,W] itself if its last dim is contiguous and each of its
    rows starts on 16 bytes (the selective scan's cp.async pieces), else
    a copy whose rows do: W padded to a multiple of 16 bytes, returned as
    the view of its first W columns. The pad is never read as data."""
    esz = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            st * esz % 16 == 0
            for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1):
        return t
    w = t.shape[-1]
    wp = -(-w * esz // 16) * 16 // esz
    out = t.new_empty(t.shape[:-1] + (wp,))[..., :w]
    out.copy_(t)
    return out


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
    slices of the x_proj output on the Mamba path); on CUDA any whose rows
    do not start on 16 bytes is copied first (`aligned_rows`)."""
    _check_sel(x, dt, a_log, b, c, d, h0)
    ops = [x, dt, a_log, b, c, d] + ([] if h0 is None else [h0])
    if not _on_cuda("selective_scan", ops):
        return selective_scan_ref(x, dt, a_log, b, c, d, h0)
    y, h_last = launch_sel(
        getattr(_lib(), f"selective_scan_{_DTYPES[x.dtype]}"),
        x, dt, a_log, b, c, d, h0)
    selective_scan.launches += 1
    return y, h_last


def launch_sel(fn, x, dt, a_log, b, c, d, h0):
    """Launch the C entry point `fn` (`selective_scan_bf16` or `_f32` of
    a built library) on checked CUDA operands of `selective_scan`, on the
    current stream; returns (y, h_last). Counts nothing."""
    bsz, s, dd = x.shape
    n = a_log.shape[1]
    if n > _MAX_STATE:
        raise ValueError(f"selective_scan's kernel takes N <= {_MAX_STATE}, "
                         f"got {n}")
    x, dt, b, c = (aligned_rows(t) for t in (x, dt, b, c))
    a_log = a_log.float().contiguous()
    d = d.float().contiguous()
    h0 = None if h0 is None else h0.float().contiguous()  # None: zero
    y = torch.empty((bsz, s, dd), dtype=x.dtype, device=x.device)
    h_last = torch.empty((bsz, dd, n), dtype=torch.float32, device=x.device)
    args = _SelArgs(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                    b.data_ptr(), c.data_ptr(), d.data_ptr(),
                    None if h0 is None else h0.data_ptr(),
                    y.data_ptr(), h_last.data_ptr(),
                    x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
                    b.stride(0), b.stride(1), c.stride(0), c.stride(1),
                    bsz, s, dd, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(fn(ctypes.byref(args), stream), "selective_scan")
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
    a, bx = (t.clone() if t.data_ptr() % 4 else t
             for t in (a.contiguous(), bx.contiguous()))
    h0 = None if h0 is None else h0.float().contiguous()  # None: zero
    out = torch.empty((bsz, s, dd), dtype=bx.dtype, device=a.device)
    # look-back scratch in one buffer of 4-byte words: the tile counter and
    # a flag a tile (zeroed by the launch), padded to 16 bytes, then each
    # tile's aggregates (2 words a channel) and inclusive end states
    steps, chans = _lin_tile()
    tiles = bsz * -(-dd // chans) * -(-s // steps)
    n_flags = -(-(1 + tiles) // 4) * 4
    scratch = torch.empty(n_flags + 3 * tiles * chans, dtype=torch.int32,
                          device=a.device)
    base = scratch.data_ptr()
    vec = a.element_size() == 4 or dd % 2 == 0
    args = _LinArgs(a.data_ptr(), bx.data_ptr(),
                    None if h0 is None else h0.data_ptr(), out.data_ptr(),
                    base, base + 4 * n_flags,
                    base + 4 * (n_flags + 2 * tiles * chans),
                    bsz, s, dd, int(vec))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    fn = getattr(_lib(), f"ssm_scan_{_DTYPES[a.dtype]}")
    _raise_on(fn(ctypes.byref(args), stream), "ssm_scan")
    ssm_scan.launches += 1
    return out


selective_scan.launches = 0
ssm_scan.launches = 0
