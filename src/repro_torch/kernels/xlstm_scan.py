"""xLSTM's mLSTM and sLSTM recurrences over a whole sequence.

The JAX package has no Pallas kernel here: it runs both recurrences as
`lax.scan` bodies (`repro/models/ssm.py:_mlstm_step`, `_slstm_step`),
which XLA compiles into one device loop. For CUDA tensors `mlstm_scan` and
`slstm_scan` launch the hand-written Hopper kernels in
`csrc/xlstm_scan.cu` (its note gives the bounds and the designs); for CPU
tensors they compute the plain versions, `ref.mlstm_scan_ref` and
`ref.slstm_scan_ref`, which autograd differentiates. Nothing sends a CUDA
tensor to a plain version.

Both kernels take f32 in and out (the JAX mixers cast to f32 before the
scan) and a head dim that is a multiple of 16 up to 256. They have no
backward kernels yet (xLSTM training on the card is the next slice of the
port): a CUDA call that autograd would have to differentiate raises
rather than return an output no gradient reaches.

Launch counts: `mlstm_scan.launches` and `slstm_scan.launches`, one a
call each.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import mlstm_scan_ref, slstm_scan_ref
from .ssm_scan import _needs_grad, _on_cuda

MAX_HEAD_DIM = 256              # and a multiple of 16 (csrc/xlstm_scan.cu)
_NO_BACKWARD = ("{} has no backward kernel yet (xLSTM training on the card "
                "is the next slice of the port): call it under "
                "torch.no_grad() or torch.inference_mode(), or train on the "
                "CPU")


class _MlstmArgs(ctypes.Structure):
    """Mirror of `MlstmScanArgs` in csrc/xlstm_scan.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "i", "f", "y")]
                + [(n, ctypes.c_int) for n in ("B", "S", "H", "hd")])


class _SlstmArgs(ctypes.Structure):
    """Mirror of `SlstmScanArgs` in csrc/xlstm_scan.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("pre", "w_r", "bias", "y")]
                + [(n, ctypes.c_int) for n in ("B", "S", "H", "hd")])


@functools.cache
def _lib() -> ctypes.CDLL:
    return load(_build.build("xlstm_scan"))


def load(path) -> ctypes.CDLL:
    """A built xlstm_scan library with its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    lib.mlstm_scan_f32.argtypes = [ctypes.POINTER(_MlstmArgs),
                                   ctypes.c_void_p]
    lib.slstm_scan_f32.argtypes = [ctypes.POINTER(_SlstmArgs),
                                   ctypes.c_void_p]
    # the rest take ints and return an int (ctypes' default restype)
    for name, nargs in (("mlstm_scan_blocks_per_sm", 1),
                        ("mlstm_scan_smem_bytes", 1),
                        ("slstm_scan_max_active_clusters", 3),
                        ("xlstm_scan_layout", 1)):
        getattr(lib, name).argtypes = [ctypes.c_int] * nargs
    lib.xlstm_scan_error_string.argtypes = [ctypes.c_int]
    lib.xlstm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{_lib().xlstm_scan_error_string(err).decode()} "
                           f"({err})")


def _check_head_dim(name: str, hd: int) -> None:
    if hd % 16 or not 16 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name} takes a head dim that is a multiple of 16 "
                         f"up to {MAX_HEAD_DIM}, got {hd}")


def _check_f32(name: str, tensors) -> None:
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes f32 operands, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous and starting on 16 bytes (the kernels' cp.async and
    vector loads), copied if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The mLSTM recurrence over S from a zero state: q (pre-scaled by
    hd**-0.5), k, v [B,S,H,hd]; i, f [B,S,H] gate pre-activations, all f32
    -> y [B,S,H,hd] f32 (`ref.mlstm_step` at each step)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm_scan wants q, k, v [B,S,H,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if i.shape != q.shape[:3] or f.shape != q.shape[:3]:
        raise ValueError(f"mlstm_scan wants i, f {tuple(q.shape[:3])}, got "
                         f"{tuple(i.shape)}, {tuple(f.shape)}")
    if min(q.shape) == 0:
        raise ValueError(f"mlstm_scan takes non-empty dims, got "
                         f"{tuple(q.shape)}")
    ops = [q, k, v, i, f]
    _check_f32("mlstm_scan", ops)
    _check_head_dim("mlstm_scan", q.shape[3])
    if not _on_cuda("mlstm_scan", ops):
        return mlstm_scan_ref(q, k, v, i, f)
    if _needs_grad(ops):
        raise NotImplementedError(_NO_BACKWARD.format("mlstm_scan"))
    bsz, s, nh, hd = q.shape
    q, k, v, i, f = (_aligned(t) for t in ops)
    y = torch.empty((bsz, s, nh, hd), dtype=torch.float32, device=q.device)
    args = _MlstmArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      i.data_ptr(), f.data_ptr(), y.data_ptr(),
                      bsz, s, nh, hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(_lib().mlstm_scan_f32(ctypes.byref(args), stream),
              "mlstm_scan")
    mlstm_scan.launches += 1
    return y


def slstm_scan(pre: torch.Tensor, w_r: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The sLSTM recurrence over S from a zero state: pre [B,S,4,H,hd] the
    i, f, z, o gates' input pre-activations, w_r [4,H,hd,hd], bias
    [4,H,hd], all f32 -> the h trail [B,S,H,hd] f32 (`ref.slstm_step` at
    each step)."""
    if pre.dim() != 5 or pre.shape[2] != 4:
        raise ValueError(f"slstm_scan wants pre [B,S,4,H,hd], got "
                         f"{tuple(pre.shape)}")
    bsz, s, _, nh, hd = pre.shape
    if tuple(w_r.shape) != (4, nh, hd, hd) or tuple(bias.shape) != (4, nh,
                                                                     hd):
        raise ValueError(f"slstm_scan wants w_r {(4, nh, hd, hd)} and bias "
                         f"{(4, nh, hd)}, got {tuple(w_r.shape)} and "
                         f"{tuple(bias.shape)}")
    if min(pre.shape) == 0:
        raise ValueError(f"slstm_scan takes non-empty dims, got "
                         f"{tuple(pre.shape)}")
    ops = [pre, w_r, bias]
    _check_f32("slstm_scan", ops)
    _check_head_dim("slstm_scan", hd)
    if not _on_cuda("slstm_scan", ops):
        return slstm_scan_ref(pre, w_r, bias)
    if _needs_grad(ops):
        raise NotImplementedError(_NO_BACKWARD.format("slstm_scan"))
    pre, w_r, bias = (_aligned(t) for t in ops)
    y = torch.empty((bsz, s, nh, hd), dtype=torch.float32, device=pre.device)
    args = _SlstmArgs(pre.data_ptr(), w_r.data_ptr(), bias.data_ptr(),
                      y.data_ptr(), bsz, s, nh, hd)
    stream = torch.cuda.current_stream(pre.device).cuda_stream
    _raise_on(_lib().slstm_scan_f32(ctypes.byref(args), stream),
              "slstm_scan")
    slstm_scan.launches += 1
    return y


mlstm_scan.launches = 0
slstm_scan.launches = 0
