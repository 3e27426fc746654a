"""xLSTM's mLSTM and sLSTM recurrences over a whole sequence.

The JAX package has no Pallas kernel here: it runs both recurrences as
`lax.scan` bodies (`repro/models/ssm.py:_mlstm_step`, `_slstm_step`),
which XLA compiles into one device loop, and differentiates with
`jax.grad`. For CUDA tensors `mlstm_scan` and `slstm_scan` launch the
hand-written Hopper kernels in `csrc/xlstm_scan.cu`, and under autograd
go through `_MlstmScan` and `_SlstmScan`, whose backwards launch those in
`csrc/xlstm_scan_bwd.cu` (`mlstm_scan_bwd`, `slstm_scan_bwd`; the notes in
the sources give the bounds and the designs; their plain mirrors are
`ref.mlstm_scan_bwd_chunkwise_ref` and `ref.slstm_scan_dpre_affine_ref`).
For CPU tensors they compute the plain versions, `ref.mlstm_scan_ref` and
`ref.slstm_scan_ref`, which autograd differentiates, and the backward
wrappers `ref.mlstm_scan_bwd_ref` and `ref.slstm_scan_dpre_ref` (with the
weight products, `ref.slstm_scan_bwd_ref`). Nothing sends a CUDA tensor to
a plain version.

The kernels take f32 in and out (the JAX mixers cast to f32 before the
scan) and a head dim that is a multiple of 16 up to 256. The mLSTM is
the chunkwise form in two kernels (`ref.mlstm_scan_chunkwise_ref` is its
plain mirror): `mlstm_scan_state_kernel` walks the chunks of
`mlstm_chunk()` steps and leaves the state before each in scratch that
the wrapper allocates (C^T, n, m: [B*H, N, hd, hd], [B*H, N, hd],
[B*H, N]), then `mlstm_scan_out_kernel` forms every chunk's outputs at
once. Under autograd the mLSTM's forward is the same, and keeps for its
backward the chunk states and den' (the signed denominator of each step
before its clamp, [B,S,H]) beside its inputs and y: 151 MB a layer at
the xlstm-125m train shape; the sLSTM's keeps the trails its backward
reads (`slstm_scan_kernel<hd/16, true>`). The mLSTM's backward is four
kernels: `mlstm_bwd_prep_kernel` (the m chain's arms, e_t, g),
`mlstm_bwd_state_kernel` (the reverse walk over the chunks: the state
gradient after each, in scratch the wrapper allocates, as large as the
states), `mlstm_bwd_chunk_kernel` (dq, dk, dv a chunk at a time) and
`mlstm_bwd_gate_kernel` (di, df).
The sLSTM's recurrent weights' and bias's gradients are plain products
over the backward kernel's output (`ref.slstm_grad_weights`: f32
`einsum`, no kernel), as the JAX package leaves them to XLA.

Launch counts, one a call each: `mlstm_scan.launches` (a launch of each
of its two kernels), `slstm_scan.launches` (of which
`slstm_scan.trail_launches` kept the trails),
`mlstm_scan_bwd.prep_launches`, `.state_launches`, `.launches` (the chunk
kernel) and `.gate_launches`, `slstm_scan_bwd.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import (mlstm_scan_bwd_ref, mlstm_scan_ref, slstm_grad_weights,
                  slstm_scan_dpre_ref, slstm_scan_ref)
from .ssm_scan import _needs_grad, _on_cuda

MAX_HEAD_DIM = 256              # and a multiple of 16 (csrc/xlstm_scan.cu)
MLSTM_CHUNK = 64                # kMChunk of csrc/xlstm_scan.cu (mlstm_chunk)
# the mLSTM backward's C entry points, in launch order
MLSTM_BWD_ENTRIES = ("mlstm_bwd_prep_f32", "mlstm_bwd_state_f32",
                     "mlstm_bwd_chunk_f32", "mlstm_bwd_gate_f32")


class _MlstmArgs(ctypes.Structure):
    """Mirror of `MlstmScanArgs` in csrc/xlstm_scan.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "i", "f", "y", "c_st", "n_st", "m_st",
                  "den")]
                + [(n, ctypes.c_int) for n in ("B", "S", "H", "hd")])


class _SlstmArgs(ctypes.Structure):
    """Mirror of `SlstmScanArgs` in csrc/xlstm_scan.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("pre", "w_r", "bias", "y", "p_trail", "c_trail", "n_trail",
                  "m_trail")]
                + [(n, ctypes.c_int) for n in ("B", "S", "H", "hd")])


class _MlstmBwdArgs(ctypes.Structure):
    """Mirror of `MlstmBwdArgs` in csrc/xlstm_scan_bwd.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "i", "f", "y", "dy", "c_st", "n_st", "m_st",
                  "den", "dq", "dk", "dv", "di", "df", "g", "sel", "ew", "qdq",
                  "kdk", "dc_st", "dn_st")]
                + [(n, ctypes.c_int) for n in ("B", "S", "H", "hd")])


class _SlstmBwdArgs(ctypes.Structure):
    """Mirror of `SlstmBwdArgs` in csrc/xlstm_scan_bwd.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("w_r", "p", "c", "n", "m", "dy", "dpre")]
                + [(n, ctypes.c_int) for n in ("B", "S", "H", "hd")])


@functools.cache
def _lib() -> ctypes.CDLL:
    return load(_build.build("xlstm_scan"))


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    return load_bwd(_build.build("xlstm_scan_bwd"))


def load(path) -> ctypes.CDLL:
    """A built xlstm_scan library with its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    for name in ("mlstm_scan_f32", "mlstm_scan_state_f32",
                 "mlstm_scan_out_f32"):
        getattr(lib, name).argtypes = [ctypes.POINTER(_MlstmArgs),
                                       ctypes.c_void_p]
    lib.slstm_scan_f32.argtypes = [ctypes.POINTER(_SlstmArgs),
                                   ctypes.c_void_p]
    # the rest take ints and return an int (ctypes' default restype)
    for name, nargs in (("mlstm_scan_blocks_per_sm", 2),
                        ("mlstm_scan_smem_bytes", 2),
                        ("slstm_scan_max_active_clusters", 3),
                        ("xlstm_scan_layout", 1)):
        getattr(lib, name).argtypes = [ctypes.c_int] * nargs
    lib.xlstm_scan_error_string.argtypes = [ctypes.c_int]
    lib.xlstm_scan_error_string.restype = ctypes.c_char_p
    return lib


def load_bwd(path) -> ctypes.CDLL:
    """A built xlstm_scan_bwd library with its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    for name in MLSTM_BWD_ENTRIES:
        getattr(lib, name).argtypes = [ctypes.POINTER(_MlstmBwdArgs),
                                       ctypes.c_void_p]
    lib.slstm_scan_bwd_f32.argtypes = [ctypes.POINTER(_SlstmBwdArgs),
                                       ctypes.c_void_p]
    for name, nargs in (("mlstm_bwd_blocks_per_sm", 1),
                        ("mlstm_bwd_smem_bytes", 2),
                        ("slstm_bwd_max_active_clusters", 3)):
        getattr(lib, name).argtypes = [ctypes.c_int] * nargs
    lib.xlstm_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.xlstm_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, name: str, lib=None) -> None:
    if err:
        text = (_lib().xlstm_scan_error_string(err) if lib is None
                else lib.xlstm_scan_bwd_error_string(err)).decode()
        raise RuntimeError(f"{name} launch failed: {text} ({err})")


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


def _check_mlstm(name: str, q, k, v, i, f, *more) -> None:
    """The mLSTM's operand checks; `more` ([B,S,H,hd] each: y, dy) too."""
    if q.dim() != 4 or any(t.shape != q.shape for t in (k, v, *more)):
        raise ValueError(f"{name} wants q, k, v{', y, dy' if more else ''} "
                         f"[B,S,H,hd], got "
                         f"{[tuple(t.shape) for t in (q, k, v, *more)]}")
    if i.shape != q.shape[:3] or f.shape != q.shape[:3]:
        raise ValueError(f"{name} wants i, f {tuple(q.shape[:3])}, got "
                         f"{tuple(i.shape)}, {tuple(f.shape)}")
    if min(q.shape) == 0:
        raise ValueError(f"{name} takes non-empty dims, got "
                         f"{tuple(q.shape)}")
    _check_f32(name, [q, k, v, i, f, *more])
    _check_head_dim(name, q.shape[3])


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The mLSTM recurrence over S from a zero state: q (pre-scaled by
    hd**-0.5), k, v [B,S,H,hd]; i, f [B,S,H] gate pre-activations, all f32
    -> y [B,S,H,hd] f32 (`ref.mlstm_step` at each step). Differentiable on
    both devices (on CUDA through `_MlstmScan`)."""
    ops = [q, k, v, i, f]
    _check_mlstm("mlstm_scan", *ops)
    if not _on_cuda("mlstm_scan", ops):
        return mlstm_scan_ref(q, k, v, i, f)
    if _needs_grad(ops):
        return _MlstmScan.apply(q, k, v, i, f)
    return _mlstm_fwd(q, k, v, i, f)


def mlstm_chunk() -> int:
    """The chunk length L the mLSTM kernels were built for (MLSTM_CHUNK,
    which the backward's scratch is sized by)."""
    chunk = _lib().xlstm_scan_layout(0)
    if chunk != MLSTM_CHUNK:
        raise RuntimeError(f"xlstm_scan.cu built with chunks of {chunk}, "
                           f"the wrapper sizes them {MLSTM_CHUNK}")
    return chunk


def _mlstm_args(q, k, v, i, f, chunk: int, keep: bool = False) -> tuple:
    """The C arguments of one mLSTM call on checked CUDA operands, chunks
    of `chunk` steps: (args, y, kept), `kept` the operands and the scratch
    the args point at (the state before each chunk: C^T, n, m; with `keep`
    also den' [B,S,H]), to be kept alive until the launches are queued."""
    bsz, s, nh, hd = q.shape
    ops = [_aligned(t) for t in (q, k, v, i, f)]
    nch = -(-s // chunk)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=q.device)
    y = new(bsz, s, nh, hd)
    scratch = [new(bsz * nh, nch, hd, hd), new(bsz * nh, nch, hd),
               new(bsz * nh, nch)] + ([new(bsz, s, nh)] if keep else [])
    args = _MlstmArgs(*(t.data_ptr() for t in ops + [y] + scratch),
                      *([] if keep else [None]), bsz, s, nh, hd)
    return args, y, ops + scratch


def _mlstm_fwd(q, k, v, i, f, keep: bool = False):
    """Launch mlstm_scan_state_kernel, then mlstm_scan_out_kernel, on
    checked CUDA operands -> y, or with `keep` (y, states): the states the
    backward reads, (C^T [B*H,N,hd,hd], n [B*H,N,hd], m [B*H,N] before
    each chunk, den' [B,S,H])."""
    args, y, kept = _mlstm_args(q, k, v, i, f, mlstm_chunk(), keep)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(_lib().mlstm_scan_f32(ctypes.byref(args), stream),
              "mlstm_scan")
    mlstm_scan.launches += 1
    return (y, tuple(kept[5:])) if keep else y


class _MlstmScan(torch.autograd.Function):
    """The forward kernels, keeping the chunk states and den' and saving
    them with the operands and y; the backward kernels
    (`mlstm_scan_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, i, f):
        y, states = _mlstm_fwd(q, k, v, i, f, keep=True)
        ctx.save_for_backward(q, k, v, i, f, y, *states)
        return y

    @staticmethod
    def backward(ctx, dy):
        *ops, c_st, n_st, m_st, den = ctx.saved_tensors
        return mlstm_scan_bwd(*ops, dy, (c_st, n_st, m_st, den))


def mlstm_scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i: torch.Tensor, f: torch.Tensor, y: torch.Tensor,
                   dy: torch.Tensor, states: tuple | None = None
                   ) -> tuple[torch.Tensor, ...]:
    """The gradients (dq, dk, dv, di, df) of `mlstm_scan(q, k, v, i, f)`
    for the output gradient dy, given its output y; all f32. CUDA: the
    four backward kernels on the forward's kept `states`
    (`_mlstm_fwd(..., keep=True)`); CPU: `ref.mlstm_scan_bwd_ref` (states
    not read)."""
    ops = [q, k, v, i, f, y, dy]
    _check_mlstm("mlstm_scan_bwd", q, k, v, i, f, y, dy)
    if not _on_cuda("mlstm_scan_bwd", ops):
        return mlstm_scan_bwd_ref(*ops)
    bsz, s, nh, hd = q.shape
    bh, nch = bsz * nh, -(-s // MLSTM_CHUNK)
    want = [(bh, nch, hd, hd), (bh, nch, hd), (bh, nch), (bsz, s, nh)]
    got = None if states is None else [tuple(t.shape) for t in states]
    if got != want:
        raise ValueError(f"mlstm_scan_bwd on CUDA wants the forward's "
                         f"states (C^T, n, m, den') of shapes {want}, got "
                         f"{got}")
    _check_f32("mlstm_scan_bwd", states)
    return _mlstm_bwd(*ops, states)


def _mlstm_bwd(q, k, v, i, f, y, dy, states) -> tuple[torch.Tensor, ...]:
    """Launch the mLSTM's backward kernels on checked CUDA operands and
    the forward's states: the prep (the m chain's arms, e_t, g), the
    reverse walk over the chunks (dC, dn after each), the chunks (dq, dk,
    dv, q . dq, k . dk), the gates (di, df)."""
    args, grads, kept = _mlstm_bwd_args(q, k, v, i, f, y, dy, states)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _bwd_lib()
    for entry, counter in zip(MLSTM_BWD_ENTRIES,
                              ("prep_launches", "state_launches", "launches",
                               "gate_launches")):
        _raise_on(getattr(lib, entry)(ctypes.byref(args), stream),
                  entry[:-4], lib)
        setattr(mlstm_scan_bwd, counter, getattr(mlstm_scan_bwd, counter) + 1)
    del kept
    return grads


def _mlstm_bwd_args(q, k, v, i, f, y, dy, states) -> tuple:
    """The C arguments of one mLSTM backward: (args, grads, kept), `grads`
    (dq, dk, dv, di, df) and `kept` the operands and scratch the args
    point at, to be kept alive until the launches are queued."""
    bsz, s, nh, hd = q.shape
    nch = -(-s // MLSTM_CHUNK)
    ops = [_aligned(t) for t in (q, k, v, i, f, y, dy, *states)]
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=q.device)
    grads = [new(bsz, s, nh, hd) for _ in range(3)] + \
        [new(bsz, s, nh) for _ in range(2)]
    scratch = [new(bsz, s, nh) for _ in range(5)] + \
        [new(bsz * nh, nch, hd, hd), new(bsz * nh, nch, hd)]
    args = _MlstmBwdArgs(*(t.data_ptr() for t in ops + grads + scratch),
                         bsz, s, nh, hd)
    return args, tuple(grads), ops + scratch


def slstm_scan(pre: torch.Tensor, w_r: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The sLSTM recurrence over S from a zero state: pre [B,S,4,H,hd] the
    i, f, z, o gates' input pre-activations, w_r [4,H,hd,hd], bias
    [4,H,hd], all f32 -> the h trail [B,S,H,hd] f32 (`ref.slstm_step` at
    each step). Differentiable on both devices (on CUDA through
    `_SlstmScan`)."""
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
        return _SlstmScan.apply(pre, w_r, bias)
    return _slstm_fwd(pre, w_r, bias, trails=False)


def _slstm_fwd(pre, w_r, bias, trails: bool):
    """Launch slstm_scan_kernel on checked CUDA operands -> y, or with
    `trails` (y, p, c, n, m) as `ref.slstm_scan_trails_ref` gives them."""
    bsz, s, _, nh, hd = pre.shape
    pre, w_r, bias = (_aligned(t) for t in (pre, w_r, bias))
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=pre.device)
    y = new(bsz, s, nh, hd)
    kept = ([new(bsz, s, 4, nh, hd)] + [new(bsz, s, nh, hd) for _ in range(3)]
            if trails else [])
    args = _SlstmArgs(pre.data_ptr(), w_r.data_ptr(), bias.data_ptr(),
                      y.data_ptr(), *(t.data_ptr() for t in kept),
                      *([None] * (4 - len(kept))), bsz, s, nh, hd)
    stream = torch.cuda.current_stream(pre.device).cuda_stream
    _raise_on(_lib().slstm_scan_f32(ctypes.byref(args), stream),
              "slstm_scan")
    slstm_scan.launches += 1
    if not trails:
        return y
    slstm_scan.trail_launches += 1
    return (y, *kept)


class _SlstmScan(torch.autograd.Function):
    """The trail-keeping forward kernel, saving w_r and the trails; the
    backward kernel and the plain weight products (`slstm_scan_bwd`)."""

    @staticmethod
    def forward(ctx, pre, w_r, bias):
        y, *trails = _slstm_fwd(pre, w_r, bias, trails=True)
        ctx.save_for_backward(w_r, y, *trails)
        return y

    @staticmethod
    def backward(ctx, dy):
        w_r, *trails = ctx.saved_tensors
        return slstm_scan_bwd(w_r, dy, trails)


def slstm_scan_bwd(w_r: torch.Tensor, dy: torch.Tensor, trails: tuple
                   ) -> tuple[torch.Tensor, ...]:
    """The gradients (dpre, dw_r, dbias) of `slstm_scan(pre, w_r, bias)`
    for the output gradient dy, all f32, from the trails (y, p, c, n, m)
    of the trail-keeping forward (`_slstm_fwd(..., trails=True)` on CUDA,
    `ref.slstm_scan_trails_ref` on the CPU): dpre by the backward kernel
    (CUDA) or `ref.slstm_scan_dpre_ref` (CPU), then dW and dbias by
    `ref.slstm_grad_weights` (together `ref.slstm_scan_bwd_ref`)."""
    y, p = trails[:2]
    if p.dim() != 5 or dy.shape != y.shape or \
            y.shape != p.shape[:2] + p.shape[3:]:
        raise ValueError(f"slstm_scan_bwd wants dy and y [B,S,H,hd] and p "
                         f"[B,S,4,H,hd], got {tuple(dy.shape)}, "
                         f"{tuple(y.shape)}, {tuple(p.shape)}")
    ops = [w_r, dy, *trails]
    _check_f32("slstm_scan_bwd", ops)
    _check_head_dim("slstm_scan_bwd", p.shape[4])
    walk = _slstm_bwd if _on_cuda("slstm_scan_bwd", ops) \
        else slstm_scan_dpre_ref
    dpre = walk(w_r, dy, trails[1:])
    return (dpre, *slstm_grad_weights(dpre, y))


def _slstm_bwd(w_r, dy, trails) -> torch.Tensor:
    """Launch slstm_scan_bwd_kernel on CUDA operands: the trails (p, c, n,
    m) -> dpre [B,S,4,H,hd]."""
    p = trails[0]
    bsz, s, _, nh, hd = p.shape
    w_r, dy, *trails = (_aligned(t) for t in (w_r, dy, *trails))
    dpre = torch.empty_like(p)
    args = _SlstmBwdArgs(w_r.data_ptr(), *(t.data_ptr() for t in trails),
                         dy.data_ptr(), dpre.data_ptr(), bsz, s, nh, hd)
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    lib = _bwd_lib()
    _raise_on(lib.slstm_scan_bwd_f32(ctypes.byref(args), stream),
              "slstm_scan_bwd", lib)
    slstm_scan_bwd.launches += 1
    return dpre


mlstm_scan.launches = 0
slstm_scan.launches = 0
slstm_scan.trail_launches = 0
mlstm_scan_bwd.prep_launches = 0
mlstm_scan_bwd.state_launches = 0
mlstm_scan_bwd.launches = 0
mlstm_scan_bwd.gate_launches = 0
slstm_scan_bwd.launches = 0
