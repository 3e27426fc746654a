"""Production meshes and the fake world they live in; counterpart of
`repro/launch/mesh.py`.

The JAX dry-run lowers against 512 host devices that exist only in its
process. The port's counterpart is a fake process group on the host
(`fake_world`): world size 256 or 512, rank 0, collectives that move
nothing, which is all DTensor's sharding propagation and the step
counter need. Its backend is PyTorch's "fake" one, registered by
importing `torch.testing._internal.distributed.fake_pg` (shipped with
every PyTorch wheel; its `FakeStore` is used as it is, not copied).

A process holds one default process group at a time and its world size
is fixed at init, so `fake_world` destroys the group on exit, also when
the body raises: nothing after it sees `dist.is_initialized()`.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A fake default process group of world size `n` (this process is
    rank 0) for the body; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape, names) -> DeviceMesh:
    """A host `DeviceMesh` of `shape` named `names` over the default
    group's ranks (which must number prod(shape))."""
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           f"ranks (fake_world({n}) on the host)")
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks (data, model). Multi-pod: 2x16x16 =
    512 ranks (pod, data, model): the pod axis carries pure DP so FSDP
    all-gathers stay intra-pod. Needs the default group of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model: int = 1) -> DeviceMesh:
    """(data, model) mesh over the default group's ranks (tests,
    examples)."""
    n = dist.get_world_size()
    return make_mesh((n // model, model), ("data", "model"))
