"""The clip by global norm and AdamW over every leaf of a training step,
in two launches: the hand-written kernels of `csrc/adamw.cu`.

No TPU kernel is replaced (the JAX package leaves its optimizer to XLA).
The plain version is `train/optimizer.py`'s `clip_by_global_norm` then
`adamw_update`, which `train/optimizer.py`'s `ClipAndAdamW` runs where
every tensor is on the CPU (`on_cpu`). Any other set of leaves goes to
the kernels: `check` raises for what they cannot take (a dtype outside
{bf16, f32} for p and g, state that is not f32, p, m or v not
contiguous, tensors off one CUDA device), and the caller makes a strided
gradient contiguous.

A `Plan` holds, on the card, a table of the leaves: pointers to p, m and
v, sizes, dtypes, and each leaf's first chunk (the kernels cut every leaf
into chunks of `CHUNK` elements, numbered across the leaves). It is built
once for a set of parameters and optimizer state (`make_plan`; `plan_key`
says when another is needed), one table for each group of up to
`MAX_LEAVES` leaves: a launch of each kernel takes one group. The
gradients' pointers, new every step, go by value in each launch's
parameters.

`norm` launches the squared-norm kernel once a group and returns a fresh
f32 [2] of (norm, scale) on the card; `update` launches the update once a
group, which reads that scale and the learning rate and bias corrections
from the card. Neither waits for the card. Launch counts:
`norm.launches`, `update.launches`.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from . import _build

CHUNK = 32768           # elements of a leaf a block takes (csrc/adamw.cu)
MAX_LEAVES = 4000       # gradient pointers a launch (csrc/adamw.cu)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# (p, g, m, v) of one leaf
Leaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class _Args(ctypes.Structure):
    """Mirror of `AdamwArgs` in csrc/adamw.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("leaves", "partials", "ticket", "sums", "out", "lr",
                  "bc1", "bc2")]
                + [(n, ctypes.c_float) for n in
                   ("b1", "b2", "c1", "c2", "eps", "wd", "max_norm",
                    "norm_eps")]
                + [(n, ctypes.c_int) for n in
                   ("n_leaves", "n_chunks", "group", "n_groups")]
                + [("g", ctypes.c_void_p * MAX_LEAVES)])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("adamw")))
    for name in ("adamw_norm", "adamw_update"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("adamw_grid", "adamw_max_leaves", "adamw_chunk",
                 "adamw_args_bytes"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.adamw_error_string.argtypes = [ctypes.c_int]
    lib.adamw_error_string.restype = ctypes.c_char_p
    if (lib.adamw_max_leaves(), lib.adamw_chunk(),
            lib.adamw_args_bytes()) != (MAX_LEAVES, CHUNK,
                                        ctypes.sizeof(_Args)):
        raise RuntimeError("csrc/adamw.cu's constants or AdamwArgs differ "
                           "from this wrapper's")
    return lib


@functools.cache
def grid_blocks(device_index: int) -> int:
    """Blocks of both kernels' fixed grid on a card."""
    with torch.cuda.device(device_index):
        n = _lib().adamw_grid()
    if n <= 0:
        raise RuntimeError("adamw_grid found no occupancy")
    return n


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{_lib().adamw_error_string(err).decode()} "
                           f"({err})")


def on_cpu(leaves: Sequence[Leaf], step: torch.Tensor) -> bool:
    """True where the step counter and every tensor of every leaf are on
    the CPU: the plain loop's case."""
    return step.device.type == "cpu" and all(
        t.device.type == "cpu" for leaf in leaves for t in leaf)


def check(leaves: Sequence[Leaf], step: torch.Tensor) -> None:
    """Raise ValueError unless the kernels take every leaf: p and g in
    bf16 or f32, m and v in f32, all four of one shape; p, m and v
    contiguous (g may be strided: the caller makes it contiguous); every
    tensor and the step counter on one CUDA device."""
    dev = leaves[0][0].device if leaves else step.device
    for i, (p, g, m, v) in enumerate(leaves):
        if p.dtype not in _DTYPES or g.dtype not in _DTYPES:
            raise ValueError(f"leaf {i}: p {p.dtype} and g {g.dtype}, where "
                             f"the kernels take bf16 or f32")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"leaf {i}: state m {m.dtype} and v {v.dtype}, "
                             f"where the kernels take f32")
        if not (g.shape == m.shape == v.shape == p.shape):
            raise ValueError(f"leaf {i}: shapes p {tuple(p.shape)}, g "
                             f"{tuple(g.shape)}, m {tuple(m.shape)}, v "
                             f"{tuple(v.shape)}")
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError(f"leaf {i}: p, m and v are updated in place "
                             f"and must be contiguous")
        if any(t.device != dev for t in (p, g, m, v)):
            raise ValueError(f"leaf {i}: tensors on more than one device")
    if dev.type != "cuda" or step.device != dev:
        raise ValueError(f"leaves on {dev} and the step counter on "
                         f"{step.device}, where the kernels take one CUDA "
                         f"device")


def plan_key(leaves: Sequence[Leaf]) -> tuple:
    """What a plan's table holds: each leaf's p, m and v pointers, size and
    the dtypes of p and g."""
    return tuple((p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                  p.dtype, g.dtype) for p, g, m, v in leaves)


@dataclass
class Plan:
    """The tables of one set of leaves on their device, one a group of up
    to `MAX_LEAVES` leaves (int64 [leaves, 6]: p, m, v, elements, first
    chunk, p dtype | g dtype << 32, with each table's chunks in all), and
    the norm's scratch: a partial sum a block, the ticket that finds the
    last block (zero between launches) and a sum a group."""
    grid: int
    tables: List[Tuple[torch.Tensor, int]]
    partials: torch.Tensor
    ticket: torch.Tensor
    sums: torch.Tensor


def _table(leaves: Sequence[Leaf]) -> Tuple[torch.Tensor, int]:
    counts = [-(-p.numel() // CHUNK) for p, _, _, _ in leaves]
    firsts = [0, *itertools.accumulate(counts)][:-1]
    rows = torch.tensor(
        [[p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(), c0,
          _DTYPES[p.dtype] | _DTYPES[g.dtype] << 32]
         for (p, g, m, v), c0 in zip(leaves, firsts)], dtype=torch.int64)
    return rows, sum(counts)


def make_plan(leaves: Sequence[Leaf], grid: int) -> Plan:
    """The tables for `leaves` (any device: the CPU tests read them), for
    a grid of `grid` blocks."""
    dev = leaves[0][0].device
    tables = [_table(leaves[i:i + MAX_LEAVES])
              for i in range(0, len(leaves), MAX_LEAVES)]
    return Plan(grid, [(rows.to(dev), n) for rows, n in tables],
                torch.zeros(grid, dtype=torch.float32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.zeros(len(tables), dtype=torch.float32, device=dev))


def _launches(plan: Plan, grads: Sequence[torch.Tensor], out: torch.Tensor):
    """The arguments of each group's launch."""
    for k, (rows, n_chunks) in enumerate(plan.tables):
        gs = grads[k * MAX_LEAVES:(k + 1) * MAX_LEAVES]
        a = _Args(leaves=rows.data_ptr(), partials=plan.partials.data_ptr(),
                  ticket=plan.ticket.data_ptr(), sums=plan.sums.data_ptr(),
                  out=out.data_ptr(), n_leaves=len(gs), n_chunks=n_chunks,
                  group=k, n_groups=len(plan.tables))
        a.g[:len(gs)] = [g.data_ptr() for g in gs]
        yield a


def norm(plan: Plan, grads: Sequence[torch.Tensor],
         max_norm: float) -> torch.Tensor:
    """Launch the norm over `grads` (the gradients of the plan's leaves, in
    its order, contiguous, as `check` accepts them), one launch a group;
    returns f32 [2] (norm, scale) on the card, where scale is
    `clip_by_global_norm`'s min(max_norm / (norm + 1e-9), 1)."""
    dev = plan.partials.device
    out = torch.empty(2, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for a in _launches(plan, grads, out):
            a.max_norm, a.norm_eps = max_norm, 1e-9
            _raise_on(_lib().adamw_norm(ctypes.byref(a), plan.grid, stream),
                      "adamw_norm")
            norm.launches += 1
    return out


def update(plan: Plan, grads: Sequence[torch.Tensor], out: torch.Tensor,
           lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor, b1: float,
           b2: float, eps: float, weight_decay: float) -> None:
    """Launch the clip and the AdamW update of every leaf in place, one
    launch a group, with the scale `norm` wrote to `out` and lr, bc1, bc2
    (f32 scalars on the card) as `adamw_update` computes them."""
    dev = plan.partials.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for a in _launches(plan, grads, out):
            a.lr, a.bc1, a.bc2 = lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr()
            a.b1, a.b2, a.c1, a.c2 = b1, b2, 1 - b1, 1 - b2
            a.eps, a.wd = eps, weight_decay
            _raise_on(_lib().adamw_update(ctypes.byref(a), plan.grid,
                                          stream), "adamw_update")
            update.launches += 1


norm.launches = 0
update.launches = 0
