"""Dry-run of every (arch x shape x mesh) cell on a fake 256- or 512-rank
world; counterpart of `repro/launch/dryrun.py`.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --mesh pod --out dryrun_out
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_out

The JAX dry-run lowers and compiles each cell against 512 host devices
that exist only in its process and reads memory, flops and collective
bytes off the compiled program. Here the cell runs on the host instead:

  * a fake process group of 256 (pod mesh, 16 x 16 as (data, model)) or
    512 ranks (multipod, 2 x 16 x 16 as (pod, data, model)) and a
    `DeviceMesh` on it (`launch.mesh`);
  * parameters, optimizer state, batch and caches as DTensors over
    `FakeTensorMode` tensors, placed by the sharding rules
    (`parallel.sharding`): no storage is allocated, at any size;
  * the train, prefill or decode step run eagerly on them, under
    `strategy(...)`, the mesh scope that `parallel.collectives.constrain`
    reads, and `analysis.roofline.StepCounter`.

The models' ops take their plain versions there, as JAX's dry-run takes
its oracles off a TPU (`kernels/ops.py` routes by `is_cuda`; a fake host
tensor is not on a card).

What differs from the JAX record:

  * `compile_s`, `xla_flops_raw` and `xla_bytes_raw` are null: nothing is
    compiled, and the counter's flops and bytes are already what a whole
    step runs (every loop trip dispatches its own ops);
  * argument and output bytes are each rank's local shards; temp bytes
    are the peak of the storages the step creates and holds at once on a
    rank (`StepCounter.peak_bytes`);
  * `compile_=False` (`--no-compile`) places the arguments and returns
    without running the step;
  * DTensor has no sharding strategy for some ops (and cannot split some
    sharded dims unevenly, e.g. 14 heads over a 16-way axis); such an op
    runs on operands replicated over the mesh, and the record counts it
    under `replicated_ops` (the redistribution shows in `collectives`);
  * the decode step gets `pos` as a Python int (the cache's last row),
    and a read of a fake scalar (`.item()`: the attention decode indexes
    the cache with a 0-d tensor of `pos`) is answered with it;
  * a host mesh has no all-to-all: DTensor plans its shard-to-shard moves
    as all-gathers there, so the all-to-all an MoE dispatch would make on
    the cards reads as all-gather bytes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
from collections import Counter
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from ..analysis.roofline import StepCounter, model_flops
from ..configs import ARCHS, get_config
from ..models.config import SHAPES, ModelConfig, ShapeSpec, get_shape
from ..models.registry import get_model, input_specs, param_specs
from ..parallel.collectives import mesh_scope, strategy
from ..parallel.sharding import (Spec, batch_specs, make_rules,
                                 shard_cache_tree, shard_tree)
from ..train.train_step import (TrainConfig, make_prefill_step,
                                make_serve_step, make_train_step)
from .mesh import fake_world, make_mesh

_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def should_skip(arch: str, shape: ShapeSpec) -> Optional[str]:
    cfg = get_config(arch)
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: long_500k needs sub-quadratic "
                "attention (DESIGN.md skip policy)")
    return None


# ------------------------------------------------------- host DTensor glue
@contextlib.contextmanager
def _host_dtensor() -> Iterator[None]:
    """DTensor's own index arithmetic off the fake mode: its sharding
    propagation and `_StridedShard`'s offsets build small index tensors
    and read them (`.tolist()`), which a fake tensor cannot answer."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    targets = [(ShardingPropagator, "propagate_op_sharding_non_cached"),
               (_StridedShard, "local_shard_size_and_offset")]
    origs = [(cls, name, cls.__dict__[name]) for cls, name in targets]

    def real(fn):
        def run(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return run

    for cls, name, fn in origs:
        setattr(cls, name, real(fn))
    try:
        yield
    finally:
        for cls, name, fn in origs:
            setattr(cls, name, fn)


_NO_STRATEGY = (NotImplementedError, RuntimeError, AssertionError)
_SCALAR_READS = (torch.ops.aten.item.default,
                 torch.ops.aten._local_scalar_dense.default)


class _ReplicateWhereUnsharded(TorchDispatchMode):
    """Runs a DTensor op that DTensor cannot shard (no strategy, an uneven
    split) on its DTensor operands replicated on the offending mesh dims:
    the last one (the model axis), then more, and at last on all, each
    rank on its whole copy (what any op computes on replicated data); it
    counts each such op. Answers a read of a fake scalar (`.item()`) with
    `scalar`, the decode position. Enter it above the `StepCounter`, so
    that the counter sees the redistributions and the local ops."""

    def __init__(self, scalar: Optional[int] = None):
        super().__init__()
        self.scalar = scalar
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SCALAR_READS and self.scalar is not None and \
                DTensor not in types:
            return self.scalar
        if DTensor not in types:
            return func(*args, **kwargs)
        schema = func._schema.arguments
        inplace = bool(schema) and schema[0].alias_info is not None and \
            schema[0].alias_info.is_write and isinstance(args[0], DTensor)
        spec = args[0]._spec if inplace else None
        try:
            out = func(*args, **kwargs)
            if inplace and args[0]._spec != spec:
                # DTensor gave the mutated operand other placements without
                # resharding its local shard: keep the ones it has
                args[0]._spec = spec
            return out
        except _NO_STRATEGY:
            pass
        mesh = next(t.device_mesh for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, DTensor))

        def replicated(dims):
            """The DTensor operands replicated on mesh dims `dims`."""
            def one(t):
                if not isinstance(t, DTensor):
                    return t
                want = tuple(Replicate() if i in dims else p
                             for i, p in enumerate(t.placements))
                return t if tuple(t.placements) == want else \
                    t.redistribute(mesh, want)
            return tree_map(one, (args, kwargs))

        # replicate the mesh dims from the last one on until DTensor can
        # run the op (the model axis first: an uneven split of heads)
        for first in range(mesh.ndim - 1, 0, -1):
            r_args, r_kwargs = replicated(range(first, mesh.ndim))
            try:
                out = func(*r_args, **r_kwargs)
            except _NO_STRATEGY:
                continue
            self.ops[str(func)] += 1
            return args[0] if inplace else out
        # no strategy at all: every rank runs the op on its whole copy
        r_args, r_kwargs = replicated(range(mesh.ndim))
        want = (Replicate(),) * mesh.ndim

        def local(t):
            return t._local_tensor if isinstance(t, DTensor) else t

        def wrap(t):
            if not isinstance(t, torch.Tensor):
                return t
            return DTensor.from_local(t, mesh, want, run_check=False)

        out = func(*tree_map(local, r_args), **tree_map(local, r_kwargs))
        self.ops[str(func)] += 1
        # an in-place op ran on a replicated copy: its operand keeps its
        # placements (the values of fake tensors are not kept anyway)
        return args[0] if inplace else tree_map(wrap, out)


def _local_shape(shape: Sequence[int], placements, sizes) -> List[int]:
    out = list(shape)
    for pl, n in zip(placements, sizes):
        if pl.is_shard():
            out[pl.dim] = -(-out[pl.dim] // n)
    return out


def _dtensor(shape: Sequence[int], dtype: torch.dtype, spec: Spec, mesh
             ) -> DTensor:
    """A DTensor of global `shape` placed by `spec`, its local shard an
    uninitialised tensor (fake under the dry-run's FakeTensorMode)."""
    local = torch.empty(_local_shape(shape, spec.placements, mesh.shape),
                        dtype=dtype)
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, mesh, spec.placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _place_params(params: nn.Module, specs: Dict[str, Spec], mesh,
                  grad: bool) -> None:
    """Swap every (meta) parameter of `params` for a DTensor one."""
    for name, p in list(params.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        mod._parameters[attr] = nn.Parameter(
            _dtensor(p.shape, p.dtype, specs[name], mesh), requires_grad=grad)


def _local_bytes(tree) -> int:
    total = 0

    def one(t):
        nonlocal total
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        return t
    tree_map(one, tree)
    return total


def _named(params: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    return list(params.named_parameters())


# ------------------------------------------------------------------ a cell
def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               compile_: bool = True, fsdp: bool = True,
               tp: bool = True, microbatches: int = 1,
               grad_compress: bool = False,
               moe: str = "ep", *, cfg: Optional[ModelConfig] = None,
               shape: Optional[ShapeSpec] = None,
               mesh_shape: Optional[Tuple[int, ...]] = None
               ) -> Dict[str, Any]:
    """Run one cell on the fake world and return its record. `cfg`,
    `shape` and `mesh_shape` override the arch's config, the named shape
    and the production mesh (tests use tiny ones)."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    mesh_name = "multipod" if multi_pod else "pod"
    skip = should_skip(arch, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skip": skip}
    mesh_shape = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    devices = math.prod(mesh_shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "kind": shape.kind,
                           "devices": devices}
    train = shape.kind == "train"
    t0 = time.time()
    with fake_world(devices):
        mesh = make_mesh(mesh_shape, _AXES[len(mesh_shape)])
        rules = make_rules(mesh, fsdp=fsdp, tp=tp)
        model = get_model(cfg, "cpu")
        params = param_specs(cfg)
        specs = input_specs(cfg, shape)
        pspec = shard_tree(_named(params), rules, cfg)
        fake = torch._subclasses.fake_tensor.FakeTensorMode(
            allow_non_fake_inputs=True)
        grad_mode = torch.enable_grad() if train else torch.inference_mode()
        with fake, _host_dtensor(), strategy(tp=tp, moe=moe), \
                mesh_scope(mesh), implicit_replication(), grad_mode:
            _place_params(params, pspec, mesh, grad=train)
            if shape.kind == "decode":
                cspec = shard_cache_tree(specs["cache"], rules, cfg)
                cache = [{k: _dtensor(t.shape, t.dtype, cspec[i][k], mesh)
                          for k, t in layer.items()}
                         for i, layer in enumerate(specs["cache"])]
                tspec = batch_specs({"tokens": specs["tokens"]}, rules)
                tokens = _dtensor(specs["tokens"].shape, torch.int32,
                                  tspec["tokens"], mesh)
                args = (params, cache, tokens, shape.seq_len - 1)
                step = make_serve_step(model)
            else:
                bspec = batch_specs(specs, rules)
                batch = {k: _dtensor(t.shape, t.dtype, bspec[k], mesh)
                         for k, t in specs.items()}
                if train:
                    opt = {"m": {n: _dtensor(p.shape, torch.float32,
                                             pspec[n], mesh)
                                 for n, p in _named(params)},
                           "step": torch.zeros((), dtype=torch.int32)}
                    opt["v"] = {n: _dtensor(p.shape, torch.float32,
                                            pspec[n], mesh)
                                for n, p in _named(params)}
                    args = (params, opt, batch)
                    step = make_train_step(model, TrainConfig(
                        num_microbatches=microbatches,
                        grad_compress=grad_compress))
                else:
                    args = (params, batch)
                    step = make_prefill_step(model)
            rec["argument_size_in_bytes"] = _local_bytes(
                (dict(_named(params)),) + args[1:])
            if not compile_:
                rec["lower_s"] = round(time.time() - t0, 1)
                return rec
            pos = shape.seq_len - 1 if shape.kind == "decode" else None
            with StepCounter(devices) as counter, \
                    _ReplicateWhereUnsharded(pos) as fallback:
                out = step(*args)
            rec["output_size_in_bytes"] = _local_bytes(
                (dict(_named(out[0])),) + tuple(out[1:]) if train else out)
            rec["temp_size_in_bytes"] = counter.peak_bytes
            del out, args
    rec["lower_s"] = round(time.time() - t0, 1)
    rec["compile_s"] = None
    rec["xla_flops_raw"] = rec["xla_bytes_raw"] = None
    terms = counter.terms()
    rec["flops"] = terms.flops
    rec["hbm_bytes"] = terms.hbm_bytes
    rec["collectives"] = terms.coll_bytes
    rec["collective_ops"] = dict(counter.coll_ops)
    rec["terms_s"] = terms.seconds()
    rec["dominant"] = terms.dominant()
    rec["model_flops"] = model_flops(cfg, shape)
    rec["useful_ratio"] = (rec["model_flops"] / terms.flops
                           if terms.flops else 0.0)
    rec["replicated_ops"] = dict(fallback.ops)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES], default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_out")
    ap.add_argument("--no-compile", action="store_true")
    args = ap.parse_args()

    archs = sorted(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = [s.name for s in SHAPES] if args.all or not args.shape \
        else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'multipod' if mp else 'pod'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip-cached] {tag}")
                    continue
                try:
                    rec = lower_cell(arch, shape, mp,
                                     compile_=not args.no_compile)
                except Exception as e:  # noqa: BLE001
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multipod" if mp else "pod",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec.get("error") or rec.get("skip") or \
                    (f"ok run={rec.get('lower_s')}s "
                     f"flops={rec.get('flops', 0):.3g}")
                print(f"[{tag}] {status}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")
    print("dry-run complete")


if __name__ == "__main__":
    main()
