"""Mamba's selective scan and the generic linear scan over axis 1.

Counterpart of `repro/kernels/ssm_scan.py` (`selective_scan_pallas`,
`ssm_scan_pallas`). For CUDA tensors `selective_scan` and `ssm_scan`
launch the hand-written Hopper kernels in `csrc/ssm_scan.cu` (its note
gives the bounds and the designs); for CPU tensors they compute the plain
versions, `ref.selective_scan_ref` and `ref.ssm_scan_ref`. Nothing sends a
CUDA tensor to a plain version.

`selective_scan` is differentiable on both devices. On CUDA, when autograd
needs it, the call goes through `_SelectiveScan`: its forward is the same
kernel, also keeping h before every `selective_scan_seg_steps()`-step
segment, and its backward is `selective_scan_bwd`, the backward kernel
(which the JAX package lacks: it differentiates its oracle) and a second
pass that sums its partials, one a 64-channel block, in a fixed order
(`bwd_partials` sizes them). On the CPU
autograd differentiates the plain version, as for `moe_gemm`.
`ssm_scan` has no backward, here or in the JAX package: a CUDA call that
autograd would have to differentiate raises rather than return an output
that no gradient reaches.

Launch counts: `selective_scan.launches` and `ssm_scan.launches`, one a
call each (the linear scan's look-back runs inside its one kernel; its
flags are zeroed by a `cudaMemsetAsync` before it, not by a kernel of
this module); `selective_scan_bwd.launches` and
`selective_scan_bwd.reduce_launches`, one of each a backward call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .ref import selective_scan_bwd_ref, selective_scan_ref, ssm_scan_ref

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_MAX_BATCH = 65535              # the selective scan's grid.y
_MAX_STATE = 16                 # states a channel (csrc/ssm_scan.cu: kNP)


class _SelArgs(ctypes.Structure):
    """Mirror of `SelScanArgs` in csrc/ssm_scan.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("x", "dt", "a_log", "b", "c", "d", "h0", "y", "h_last",
                  "h_seg")]
                + [(f"{t}_s{s}", ctypes.c_longlong)
                   for t in ("x", "dt", "b", "c") for s in "bs"]
                + [(n, ctypes.c_int) for n in ("B", "S", "D", "N")])


class _SelBwdArgs(ctypes.Structure):
    """Mirror of `SelScanBwdArgs` in csrc/ssm_scan.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("x", "dt", "a_log", "b", "c", "d", "h_seg", "dy",
                  "dh_last", "dx", "ddt", "db", "dc", "da_log", "dd", "dh0",
                  "part_bc", "part_a", "part_d")]
                + [(f"{t}_s{s}", ctypes.c_longlong)
                   for t in ("x", "dt", "b", "c", "dy") for s in "bs"]
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
def _seg_steps() -> int:
    """Steps between the states the forward keeps for the backward."""
    return _lib().selective_scan_seg_steps()


@functools.cache
def _bwd_block_channels() -> int:
    """Channels a backward block: the partials of dB and dC are kept a
    block."""
    return _lib().selective_scan_bwd_block_channels()


def bwd_partials(bsz: int, s: int, dd: int, n: int,
                 block_ch: int) -> tuple[int, int, int]:
    """f32 words of the backward's partials, which its second pass sums
    in a fixed order: dB and dC of each of the ceil(D / block_ch) channel
    blocks [B, blocks, 2, S, N], da_log's [B, D, N] and dD's [B, D] of
    each batch row."""
    return bsz * -(-dd // block_ch) * 2 * s * n, bsz * dd * n, bsz * dd


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
        for kname in ("selective_scan_bwd", "selective_scan_bwd_reduce"):
            fn = getattr(lib, f"{kname}_{suffix}")
            fn.argtypes = [ctypes.POINTER(_SelBwdArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
    for name in ("ssm_scan_tile", "ssm_scan_blocks_per_sm",
                 "selective_scan_smem_bytes", "selective_scan_blocks_per_sm",
                 "selective_scan_split", "selective_scan_bwd_blocks_per_sm",
                 "selective_scan_bwd_smem_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    for name in ("selective_scan_seg_steps",
                 "selective_scan_bwd_block_channels"):
        getattr(lib, name).argtypes = []
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
    device."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name} operands on "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return True


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    do not start on 16 bytes is copied first (`aligned_rows`).
    Differentiable: on CUDA under autograd through `_SelectiveScan`."""
    _check_sel(x, dt, a_log, b, c, d, h0)
    ops = [x, dt, a_log, b, c, d] + ([] if h0 is None else [h0])
    if not _on_cuda("selective_scan", ops):
        return selective_scan_ref(x, dt, a_log, b, c, d, h0)
    if _needs_grad(ops):
        return _SelectiveScan.apply(x, dt, a_log, b, c, d, h0)
    y, h_last = launch_sel(
        getattr(_lib(), f"selective_scan_{_DTYPES[x.dtype]}"),
        x, dt, a_log, b, c, d, h0)
    selective_scan.launches += 1
    return y, h_last


def _forward_states(x, dt, a_log, b, c, d, h0):
    """(y, h_last, h_seg): on CUDA the forward kernel, also keeping h
    before every segment for the backward (counted as a `selective_scan`
    launch); on the CPU the plain version, with h_seg None."""
    if not _on_cuda("selective_scan", [x, dt, a_log, b, c, d]):
        return (*selective_scan_ref(x, dt, a_log, b, c, d, h0), None)
    out = launch_sel(getattr(_lib(), f"selective_scan_{_DTYPES[x.dtype]}"),
                     x, dt, a_log, b, c, d, h0, states=True)
    selective_scan.launches += 1
    return out


class _SelectiveScan(torch.autograd.Function):
    """The forward kernel keeping the segment states, and the backward
    kernels; saves the operands and those states. Either output's
    gradient may be None (the Mamba layer drops h_last)."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d, h0):
        y, h_last, h_seg = _forward_states(x, dt, a_log, b, c, d, h0)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a_log, b, c, d, h0, h_seg)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, a_log, b, c, d, h0, h_seg = ctx.saved_tensors
        if dy is None:
            dy = x.new_zeros(x.shape)
        dx, ddt, da_log, db, dc, dd, dh0 = selective_scan_bwd(
            x, dt, a_log, b, c, d, h0, dy, dh_last, h_seg)
        return (dx, ddt, da_log.to(a_log.dtype), db, dc, dd.to(d.dtype),
                None if h0 is None else dh0.to(h0.dtype))


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, d: torch.Tensor,
                       h0: Optional[torch.Tensor], dy: torch.Tensor,
                       dh_last: Optional[torch.Tensor] = None,
                       h_seg: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, ...]:
    """Gradients of `selective_scan(x, dt, a_log, b, c, d, h0)` for the
    output gradients dy [B,S,D] (x's dtype) and dh_last [B,D,N] (None:
    zero) -> (dx, ddt, da_log, db, dc, dd, dh0): dx, ddt, db and dc in
    their inputs' dtypes and contiguous (b and c may be column slices),
    da_log [D,N], dd [D] and dh0 [B,D,N] in f32. On CUDA the backward
    kernel and its second pass, from h_seg, the states the forward kept
    (`_forward_states`), which h0 is then not needed beside; on the CPU
    the plain version, `ref.selective_scan_bwd_ref`, from h0."""
    _check_sel(x, dt, a_log, b, c, d, h0)
    bsz, s, dd = x.shape
    n = a_log.shape[1]
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"selective_scan_bwd wants dy {tuple(x.shape)} "
                         f"{x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    if dh_last is not None and tuple(dh_last.shape) != (bsz, dd, n):
        raise ValueError(f"selective_scan_bwd wants dh_last {(bsz, dd, n)}, "
                         f"got {tuple(dh_last.shape)}")
    ops = [x, dt, a_log, b, c, d, dy] + [
        t for t in (h0, dh_last, h_seg) if t is not None]
    if not _on_cuda("selective_scan_bwd", ops):
        return selective_scan_bwd_ref(x, dt, a_log, b, c, d, h0, dy, dh_last)
    nseg = -(-s // _seg_steps())
    if h_seg is None or tuple(h_seg.shape) != (bsz, nseg, dd, n) or \
            h_seg.dtype != torch.float32 or not h_seg.is_contiguous():
        raise ValueError(f"selective_scan_bwd on CUDA wants the forward's "
                         f"states h_seg {(bsz, nseg, dd, n)} f32, got "
                         f"{None if h_seg is None else tuple(h_seg.shape)}")
    # the kernel's producer warp stages rows by 16-byte cp.async pieces
    x, dt, b, c, dy = (aligned_rows(t) for t in (x, dt, b, c, dy))
    a_log = a_log.float().contiguous()
    d = d.float().contiguous()
    dh_last = None if dh_last is None else dh_last.float().contiguous()
    dev = x.device
    dx = torch.empty((bsz, s, dd), dtype=x.dtype, device=dev)
    ddt = torch.empty_like(dx)
    db = torch.empty((bsz, s, n), dtype=b.dtype, device=dev)
    dc = torch.empty_like(db)
    da_log = torch.empty((dd, n), dtype=torch.float32, device=dev)
    dd_ = torch.empty((dd,), dtype=torch.float32, device=dev)
    dh0 = torch.empty((bsz, dd, n), dtype=torch.float32, device=dev)
    n_bc, n_a, n_d = bwd_partials(bsz, s, dd, n, _bwd_block_channels())
    part = torch.empty(n_bc + n_a + n_d, dtype=torch.float32, device=dev)
    base = part.data_ptr()
    args = _SelBwdArgs(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                       b.data_ptr(), c.data_ptr(), d.data_ptr(),
                       h_seg.data_ptr(), dy.data_ptr(),
                       None if dh_last is None else dh_last.data_ptr(),
                       dx.data_ptr(), ddt.data_ptr(), db.data_ptr(),
                       dc.data_ptr(), da_log.data_ptr(), dd_.data_ptr(),
                       dh0.data_ptr(), base, base + 4 * n_bc,
                       base + 4 * (n_bc + n_a),
                       x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
                       b.stride(0), b.stride(1), c.stride(0), c.stride(1),
                       dy.stride(0), dy.stride(1), bsz, s, dd, n)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib, suffix = _lib(), _DTYPES[x.dtype]
    _raise_on(getattr(lib, f"selective_scan_bwd_{suffix}")(
        ctypes.byref(args), stream), "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    _raise_on(getattr(lib, f"selective_scan_bwd_reduce_{suffix}")(
        ctypes.byref(args), stream), "selective_scan_bwd reduce")
    selective_scan_bwd.reduce_launches += 1
    return dx, ddt, da_log, db, dc, dd_, dh0


def launch_sel(fn, x, dt, a_log, b, c, d, h0, states: bool = False):
    """Launch the C entry point `fn` (`selective_scan_bf16` or `_f32` of
    a built library) on checked CUDA operands of `selective_scan`, on the
    current stream; returns (y, h_last), and with `states` also h_seg, h
    before every segment, f32 [B, ceil(S/seg), D, N]. Counts nothing."""
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
    h_seg = (torch.empty((bsz, -(-s // _seg_steps()), dd, n),
                         dtype=torch.float32, device=x.device)
             if states else None)
    args = _SelArgs(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                    b.data_ptr(), c.data_ptr(), d.data_ptr(),
                    None if h0 is None else h0.data_ptr(),
                    y.data_ptr(), h_last.data_ptr(),
                    None if h_seg is None else h_seg.data_ptr(),
                    x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
                    b.stride(0), b.stride(1), c.stride(0), c.stride(1),
                    bsz, s, dd, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(fn(ctypes.byref(args), stream), "selective_scan")
    return (y, h_last, h_seg) if states else (y, h_last)


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
    ops = [a, bx] + ([] if h0 is None else [h0])
    if not _on_cuda("ssm_scan", ops):
        return ssm_scan_ref(a, bx, h0)
    if _needs_grad(ops):
        raise NotImplementedError(
            "ssm_scan has no backward kernel (no model differentiates "
            "it): call it under torch.no_grad() or torch.inference_mode(), "
            "or on operands that do not require grad")
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
selective_scan_bwd.launches = 0
selective_scan_bwd.reduce_launches = 0
ssm_scan.launches = 0
