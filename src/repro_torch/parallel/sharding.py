"""Sharding rules engine; counterpart of `repro/parallel/sharding.py`.

The JAX engine gives every jit input (parameters, optimizer state,
batch, caches) a sharding per leaf from its tree path and shape, with a
divisibility fallback, which is what lets every arch lower on any mesh:

  * TP/EP  — the "model" axis goes to the preferred parallel dim of each
    leaf (experts for MoE weights, heads/ffn for projections, vocab for
    embeddings) if divisible, else to the largest divisible dim, else the
    leaf stays unsharded on that axis.
  * FSDP   — the "data" axis additionally shards the largest remaining
    divisible dim of big leaves (ZeRO-3: params + optimizer state), kept
    intra-pod; the pod axis carries pure DP.
  * batch  — ("pod","data") on the batch dim when divisible; batch-1
    long-context falls back to sequence sharding (SP) on "data".

The rules here are the same, with the same knobs (`fsdp`, `tp`,
`fsdp_min_size`, `_MODEL_PREF`, `_EXPERT_LEAVES`). They need only axis
names and sizes: `ShardingRules.mesh` is a `DeviceMesh` with named dims or
a `MeshShape` (no process group). Each call returns a `Spec`: the
JAX-style entry per tensor dim (an axis name, a tuple of names, or None)
and the DTensor placements per mesh dim.

The JAX leaves under "layers", "encoder" and "decoder" are stacked
[repeats or layers, ...]; the port holds one tensor a layer
(`layers.{i}.…`, `encoder.{i}.…`, see `repro_torch.convert`). The rules
protect the stacked dim and compare `fsdp_min_size` with the stacked
leaf's size, so `shard_tree` and `shard_cache_tree` decide on the stacked
shape (`stacked_shape`) and place the unstacked tensor: a port tensor's
spec is the JAX spec of its stacked leaf with the stacked dim dropped.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

from .collectives import placements_of

# leaf-name -> preferred dim index for the model axis, counted from the
# END of the shape (negative) so stacked [repeats, ...] leaves need no
# special casing.
_MODEL_PREF: Dict[str, int] = {
    # attention / generic projections: shard the output features
    "wq": -1, "wk": -1, "wv": -1, "w_gate": -1, "w_up": -1, "w_x": -1,
    "in_proj": -1, "x_proj": -1, "w_i": -1, "w_f": -1, "router": -1,
    # row-parallel: shard the input features
    "wo": -2, "w_down": -2, "out_proj": -2, "dt_proj": -2,
    # embeddings: vocab dim
    "embedding": -2, "unembed": -1,
    # mamba extras
    "conv_w": -1, "conv_b": -1, "dt_bias": -1, "a_log": -2, "d": -1,
    # slstm recurrent block-diagonal [4,H,hd,hd]: heads
    "w_r": -3,
}

# MoE expert-stacked weights [E, d, f] (possibly [R, E, d, f]): expert dim
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")

Entry = Any          # None | axis name | tuple of axis names


@dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without devices."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """name -> size, in mesh order, of a `DeviceMesh` or `MeshShape`."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class Spec:
    """One tensor's sharding: `spec` per tensor dim (JAX's PartitionSpec
    entries, a single name unwrapped), `placements` per mesh dim."""
    spec: Tuple[Entry, ...]
    placements: tuple


def _names(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def make_spec(spec: Sequence[Entry], axes: Iterable[str]) -> Spec:
    spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)
    return Spec(spec, placements_of([_names(e) for e in spec], list(axes)))


def drop_stacked(s: Spec, axes: Iterable[str]) -> Spec:
    """The spec of one layer of a stacked leaf (its dim 0 unsharded)."""
    assert s.spec[0] is None, s
    return make_spec(s.spec[1:], axes)


@dataclass(frozen=True)
class ShardingRules:
    mesh: Any                                 # DeviceMesh | MeshShape
    model_axis: str = "model"
    fsdp_axis: str = "data"
    dp_axes: Tuple[str, ...] = ("data",)      # ("pod","data") multi-pod
    fsdp_min_size: int = 2 ** 16              # don't FSDP tiny leaves
    fsdp: bool = True      # False: params replicated on data
    tp: bool = True        # False: model axis joins the batch axes

    @property
    def axes(self) -> Dict[str, int]:
        return mesh_axes(self.mesh)

    @property
    def model_size(self) -> int:
        return self.axes[self.model_axis]

    @property
    def fsdp_size(self) -> int:
        return self.axes[self.fsdp_axis]

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return self.dp_axes + ((self.model_axis,) if not self.tp else ())


def make_rules(mesh, *, fsdp: bool = True, tp: bool = True
               ) -> ShardingRules:
    axes = mesh_axes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    return ShardingRules(mesh=mesh, dp_axes=dp, fsdp=fsdp, tp=tp)


_STACKS = re.compile(r"\b(layers|encoder|decoder)\b")


def _stack_depth(path: str) -> int:
    """Leading stacked-layer dims to skip (never shard the scan axis)."""
    return 1 if _STACKS.search(path) else 0


def _leaf_name(path: str) -> str:
    """The last key of a dotted port name or of a JAX key string."""
    return re.split(r"[.\[\]'\"]+", path.strip("]'\" "))[-1]


def param_sharding(path: str, shape: Sequence[int],
                   rules: ShardingRules) -> Spec:
    """The spec of a parameter leaf named `path` (a port name or a JAX
    key path) whose shape is `shape`: the stacked shape when `path` lies
    under "layers", "encoder" or "decoder" (see `stacked_shape`)."""
    rank = len(shape)
    spec: list = [None] * rank
    lo = _stack_depth(path)                   # protected leading dims
    name = _leaf_name(path)
    msz, fsz = rules.model_size, rules.fsdp_size
    axes = rules.axes

    def assignable(i: int, size: int) -> bool:
        return i >= lo and spec[i] is None and shape[i] % size == 0 \
            and shape[i] >= size

    def fsdp_on(skip: Optional[int]) -> None:
        if rules.fsdp and math.prod(shape) >= rules.fsdp_min_size:
            for i in sorted(range(lo, rank), key=lambda i: -shape[i]):
                if i != skip and assignable(i, fsz):
                    spec[i] = rules.fsdp_axis
                    break

    if not rules.tp:
        # pure-DP strategy: no tensor parallelism; FSDP may still apply
        fsdp_on(None)
        return make_spec(spec, axes)
    # ---- model axis ----------------------------------------------------
    midx: Optional[int] = None
    if name in _EXPERT_LEAVES and rank - lo == 3:
        if assignable(lo, msz):                # expert dim -> EP
            midx = lo
    if midx is None and name in _MODEL_PREF:
        cand = rank + _MODEL_PREF[name]
        if lo <= cand < rank and assignable(cand, msz):
            midx = cand
    if midx is None:                           # fallback: largest divisible
        for i in sorted(range(lo, rank), key=lambda i: -shape[i]):
            if assignable(i, msz):
                midx = i
                break
    if midx is not None:
        spec[midx] = rules.model_axis
    # ---- FSDP on the data axis ------------------------------------------
    fsdp_on(midx)
    return make_spec(spec, axes)


def stacked_shape(name: str, shape: Sequence[int], cfg) -> Tuple[int, ...]:
    """The JAX leaf's shape for the port tensor `name`: one dim of
    `cfg.repeats` ("layers.…"), `cfg.encoder_layers` ("encoder.…") or
    `cfg.num_layers` ("decoder.…") in front; any other name as it is."""
    head = name.split(".", 1)[0]
    n = {"layers": cfg.repeats, "encoder": cfg.encoder_layers,
         "decoder": cfg.num_layers}.get(head)
    return tuple(shape) if n is None else (n,) + tuple(shape)


def shard_tree(named_shapes: Iterable[Tuple[str, Any]], rules: ShardingRules,
               cfg) -> Dict[str, Spec]:
    """Spec of every named tensor (`module.named_parameters()`, or an
    optimizer state's names and tensors): decided on the stacked shape,
    placed on the tensor's own."""
    out = {}
    for name, t in named_shapes:
        shape = tuple(getattr(t, "shape", t))
        full = stacked_shape(name, shape, cfg)
        s = param_sharding(name, full, rules)
        out[name] = drop_stacked(s, rules.axes) if len(full) > len(shape) \
            else s
    return out


# ------------------------------------------------------------------ batch
def batch_specs(batch_tree: Mapping[str, Any], rules: ShardingRules
                ) -> Dict[str, Spec]:
    """Specs for train/prefill inputs: batch over dp axes; SP fallback
    on the sequence dim when the batch doesn't divide (long-context)."""
    dp = rules.batch_axes
    axes = rules.axes
    dp_size = math.prod(axes[a] for a in dp)
    out = {}
    for key, leaf in batch_tree.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        spec: list = [None] * len(shape)
        if len(shape) >= 1 and shape[0] % dp_size == 0 and shape[0] > 1:
            spec[0] = dp
        elif len(shape) >= 2 and shape[1] % rules.fsdp_size == 0:
            spec[1] = rules.fsdp_axis          # sequence parallelism
        out[key] = make_spec(spec, axes)
    return out


def cache_sharding(path: str, shape: Sequence[int],
                   rules: ShardingRules) -> Spec:
    """KV caches [R,B,L,nkv,hd] and recurrent states [R,B,...] (the
    stacked shape): batch over dp axes when divisible (else SP on the
    cache length), then the cache length or the feature dims on "model"
    when divisible."""
    rank = len(shape)
    spec: list = [None] * rank
    # decode caches are stacked [repeats/layers, batch, ...]: dim0 is the
    # scan axis — never shard it.
    lo = 1 if rank >= 3 else 0
    _ = path
    dp = rules.batch_axes
    axes = rules.axes
    dp_size = math.prod(axes[a] for a in dp)
    msz = rules.model_size
    b_idx = lo if rank > lo else None
    if b_idx is not None and shape[b_idx] % dp_size == 0 and shape[b_idx] > 1:
        spec[b_idx] = dp
        sp_used = False
    else:
        sp_used = True
    if rules.tp:
        # KV caches [R,B,L,nkv,hd]: the model axis on the cache LENGTH
        # (context-parallel decode), as the JAX engine measured
        cand_order = ([2] + list(range(rank - 1, lo, -1))) if rank >= 5 \
            else list(range(rank - 1, lo, -1))
        for i in cand_order:
            if spec[i] is None and shape[i] % msz == 0 and shape[i] >= msz:
                spec[i] = rules.model_axis
                break
    if sp_used:
        # SP: shard the longest remaining dim (the cache length) on data
        order = sorted((i for i in range(lo, rank) if spec[i] is None),
                       key=lambda i: -shape[i])
        for i in order:
            if shape[i] % rules.fsdp_size == 0 and \
                    shape[i] >= 4 * rules.fsdp_size:
                spec[i] = rules.fsdp_axis
                break
    return make_spec(spec, axes)


def cache_layers(cfg) -> int:
    """The stacked dim of the JAX cache: repeats (decoder-only, one stack
    a pattern position) or layers (encoder-decoder)."""
    return cfg.num_layers if cfg.is_encoder_decoder else cfg.repeats


def shard_cache_tree(cache: Sequence[Mapping[str, Any]], rules: ShardingRules,
                     cfg) -> list:
    """Specs of the port's cache (one dict a layer, `init_cache`), each
    decided on the stacked shape of its JAX leaf."""
    n = cache_layers(cfg)
    out = []
    for i, layer in enumerate(cache):
        specs = {}
        for key, t in layer.items():
            shape = tuple(getattr(t, "shape", t))
            s = cache_sharding(f"[{i}]['{key}']", (n,) + shape, rules)
            specs[key] = drop_stacked(s, rules.axes)
        out.append(specs)
    return out
