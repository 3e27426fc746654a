"""Activation sharding constraints; counterpart of
`repro/parallel/collectives.py`.

The JAX models call `constrain(x, "dp", None, "model")` at the points
where GSPMD must be steered (batch on the data axes, features on model).
The port's models call it at the counterpart points. It acts only when a
mesh is in scope (`mesh_scope`, which the dry-run enters) and `x` is a
`DTensor`: then it redistributes `x` to the placements the JAX function's
logic gives, with the same divisibility fallback (a dim whose size does
not divide its axes stays replicated). Anywhere else (the card's eager
path, the CPU tests, plain tensors) it returns `x` after one contextvar
read, so the models compute the same bits with and without it.

`strategy(tp, moe)` and `moe_mode()` are the JAX file's knobs: with TP
off the model axis joins the data axes and "model" resolves to nothing;
`moe_mode()` picks the MoE dataflow ("ep": experts on the model axis,
tokens moved to them; "gather": tokens stay, weights gathered).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Optional, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

DimSpec = Union[None, str]   # None | "dp" | "model" | axis name

_tp_enabled: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_tp_enabled", default=True)
_moe_mode: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moe_mode", default="ep")
_mesh: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def moe_mode() -> str:
    return _moe_mode.get()


@contextlib.contextmanager
def strategy(tp: bool = True, moe: str = "ep") -> Iterator[None]:
    tok = _tp_enabled.set(tp)
    tok2 = _moe_mode.set(moe)
    try:
        yield
    finally:
        _tp_enabled.reset(tok)
        _moe_mode.reset(tok2)


@contextlib.contextmanager
def mesh_scope(mesh) -> Iterator[None]:
    """Make `mesh` (a `DeviceMesh` with named dims) the one `constrain`
    resolves axis names through."""
    tok = _mesh.set(mesh)
    try:
        yield
    finally:
        _mesh.reset(tok)


def dim_axes(dims, shape, axes: dict) -> list:
    """The JAX function's spec: per tensor dim, the tuple of mesh axis
    names it is sharded over (empty: replicated)."""
    tp = _tp_enabled.get()
    out = []
    for i, d in enumerate(dims):
        if d is None:
            out.append(())
            continue
        if d == "dp":
            names = tuple(a for a in ("pod", "data") if a in axes)
            if not tp and "model" in axes:
                names = names + ("model",)     # model axis joins DP
        elif d == "model" and not tp:
            names = ()
        else:
            names = (d,) if d in axes else ()
        size = math.prod(axes[a] for a in names) if names else 0
        if names and size > 0 and shape[i] % size == 0 and shape[i] >= size:
            out.append(names)
        else:
            out.append(())
    return out


def placements_of(spec, mesh_names) -> tuple:
    """Per-tensor-dim axis names -> DTensor placements per mesh dim: a
    mesh dim named in tensor dim i's entry shards dim i (one tensor dim
    over several mesh dims is sharded over them in mesh order)."""
    where = {a: i for i, names in enumerate(spec) for a in names}
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh_names)


def constrain(x: torch.Tensor, *dims: DimSpec) -> torch.Tensor:
    """`with_sharding_constraint` with logical dim names and the
    divisibility fallback. dims: one entry per dim of x — None, "dp"
    (pod+data) or "model"."""
    mesh: Optional[object] = _mesh.get()
    if mesh is None or not isinstance(x, DTensor) or len(dims) != x.ndim:
        return x
    names = mesh.mesh_dim_names
    axes = dict(zip(names, mesh.shape))
    want = placements_of(dim_axes(dims, x.shape, axes), names)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)

