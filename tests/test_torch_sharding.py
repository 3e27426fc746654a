"""The port's sharding rules (`repro_torch.parallel.sharding`) against the
JAX package's: the JAX unit tests on port names, and the spec of every
parameter, cache entry and batch input of every full-size arch on four
mesh shapes with the knobs on and off. The JAX leaves are stacked over
layers; a port tensor's spec must be its stacked leaf's with the stacked
dim dropped. Mesh shapes only (no process group): `MeshShape` here,
`AbstractMesh` there."""
import itertools

import pytest

pytest.importorskip("torch")
import jax  # noqa: E402
import torch  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.models import registry as jax_registry  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.models.registry import input_specs, param_specs  # noqa: E402
from repro_torch.parallel.sharding import (MeshShape, batch_specs,  # noqa: E402
                                           cache_sharding, make_rules,
                                           param_sharding, shard_cache_tree,
                                           shard_tree)

MESHES = [((2, 2), ("data", "model")), ((2, 16), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
KNOBS = list(itertools.product((True, False), (True, False)))   # fsdp, tp


def _mesh(shape=(2, 2), axes=("data", "model")):
    return MeshShape(axes, shape)


def _norm(spec, rank):
    """A JAX PartitionSpec as a tuple of entries of length `rank`, a
    one-name tuple unwrapped."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in tuple(spec)]
    return tuple(out + [None] * (rank - len(out)))


def _rules(shape, axes, fsdp, tp):
    return (make_rules(MeshShape(axes, shape), fsdp=fsdp, tp=tp),
            jsh.make_rules(jax.sharding.AbstractMesh(shape, axes), fsdp=fsdp,
                           tp=tp))


# --------------------------------------------- the JAX unit tests, ported
def test_param_sharding_prefers_expert_dim():
    rules = make_rules(_mesh())
    s = param_sharding("layers.0.ffn.w_gate", (8, 16, 64, 32), rules)
    assert s.spec[1] == "model"        # expert dim (after stacked dim0)
    assert s.placements == (Shard(2), Shard(1))   # FSDP: largest left


def test_param_sharding_divisibility_fallback():
    rules = make_rules(_mesh((2, 16), ("data", "model")))
    s = param_sharding("x.wq", (60, 224), rules)
    assert s.spec[1] == "model"
    s2 = param_sharding("x.wq", (61, 30), rules)
    assert s2.spec == (None, None)     # nothing divisible -> replicated
    assert s2.placements == (Replicate(), Replicate())


def test_param_sharding_never_shards_stacked_dim():
    rules = make_rules(_mesh())
    s = param_sharding("layers.0.mixer.wq", (2, 64, 64), rules)
    assert s.spec[0] is None


def test_batch_specs_sp_fallback_for_batch1():
    rules = make_rules(_mesh((4, 2), ("data", "model")))
    sh = batch_specs({"tokens": torch.empty((1, 64), device="meta")}, rules)
    assert sh["tokens"].spec[1] == "data"     # sequence parallelism


def test_cache_sharding_protects_layer_dim():
    rules = make_rules(_mesh((2, 2), ("data", "model")))
    s = cache_sharding("[0]['k']", (4, 8, 128, 4, 64), rules)
    assert s.spec[0] is None
    assert s.spec[1] in ("data", ("data",))


def test_pod_and_data_shard_one_dim_in_mesh_order():
    rules = make_rules(_mesh((2, 16, 16), ("pod", "data", "model")))
    s = batch_specs({"tokens": torch.empty((256, 8), device="meta")},
                    rules)["tokens"]
    assert s.spec == (("pod", "data"), None)
    assert s.placements == (Shard(0), Shard(0), Replicate())


# ------------------------------------------------------------- parameters
def _port_names(kp, cfg):
    """The port's parameter names of one JAX leaf (one per stacked
    layer), with whether the leaf is stacked."""
    keys = [k.key if hasattr(k, "key") else k.idx for k in kp]
    head = keys[0]
    if head == "layers":
        pos, rest = keys[1], ".".join(keys[2:])
        n = len(cfg.pattern)
        return [f"layers.{r * n + pos}.{rest}" for r in range(cfg.repeats)], 1
    if head in ("encoder", "decoder"):
        n = cfg.encoder_layers if head == "encoder" else cfg.num_layers
        return [f"{head}.{i}.{'.'.join(keys[1:])}" for i in range(n)], 1
    return [".".join(keys)], 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_sharding_matches_jax(arch):
    cfg = get_config(arch)
    params = param_specs(cfg)
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    leaves = jax.tree_util.tree_flatten_with_path(
        jax_registry.param_specs(jax_get_config(arch)))[0]
    names = {n for kp, _ in leaves for n in _port_names(kp, cfg)[0]}
    assert names == set(shapes)                  # every parameter, once
    checked = 0
    for (mshape, axes), (fsdp, tp) in itertools.product(MESHES, KNOBS):
        rules, jrules = _rules(mshape, axes, fsdp, tp)
        port = shard_tree(shapes.items(), rules, cfg)
        for kp, leaf in leaves:
            want = _norm(jsh.param_sharding(jax.tree_util.keystr(kp),
                                            leaf.shape, jrules).spec,
                         len(leaf.shape))
            ports, stacked = _port_names(kp, cfg)
            assert stacked == 0 or want[0] is None
            for n in ports:
                assert port[n].spec == want[stacked:], (n, mshape, fsdp, tp)
                assert shapes[n] == tuple(leaf.shape)[stacked:]
                checked += 1
    assert checked == 16 * len(shapes)


def test_qwen2_72b_norm_is_fsdp_sharded_by_its_stacked_size():
    """A per-layer norm [8192] is under fsdp_min_size (2^16); its stacked
    leaf [80, 8192] is not, so JAX shards it on "data", and so must the
    port."""
    cfg = get_config("qwen2-72b")
    rules, jrules = _rules((16, 16), ("data", "model"), True, True)
    port = shard_tree([("layers.7.norm_mixer.scale", (8192,))], rules, cfg)
    want = jsh.param_sharding("['layers'][0]['norm_mixer']['scale']",
                              (80, 8192), jrules).spec
    assert _norm(want, 2) == (None, "model")
    # the model axis takes the only dim; with TP off, FSDP takes it
    assert port["layers.7.norm_mixer.scale"].spec == ("model",)
    rules, jrules = _rules((16, 16), ("data", "model"), True, False)
    port = shard_tree([("layers.7.norm_mixer.scale", (8192,))], rules, cfg)
    assert port["layers.7.norm_mixer.scale"].spec == ("data",)
    assert _norm(jsh.param_sharding("['layers'][0]['norm_mixer']['scale']",
                                    (80, 8192), jrules).spec, 2) == \
        (None, "data")
    assert param_sharding("norm.scale", (8192,), rules).spec == (None,)


# ------------------------------------------------------- caches and batch
def _jax_cache_leaves(cfg, b, s):
    """(port layer index, port key) -> the JAX cache leaf's shape."""
    tree = jax_registry.cache_specs(jax_get_config(cfg.name), b, s)
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key if hasattr(k, "key") else k.idx for k in kp]
        if cfg.is_encoder_decoder:       # {"self": {k, v}, cross_k, cross_v}
            key = keys[-1]
            for i in range(cfg.num_layers):
                out[(i, key)] = tuple(leaf.shape)
        else:                            # (per pattern position) {...}
            pos, key = keys
            n = len(cfg.pattern)
            for r in range(cfg.repeats):
                out[(r * n + pos, key)] = tuple(leaf.shape)
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_and_batch_specs_match_jax(arch):
    cfg = get_config(arch)
    for (mshape, axes), (fsdp, tp) in itertools.product(MESHES, KNOBS):
        rules, jrules = _rules(mshape, axes, fsdp, tp)
        for shape, jshape in zip(SHAPES, JAX_SHAPES):
            specs = input_specs(cfg, shape)
            jspecs = jax_registry.input_specs(jax_get_config(arch), jshape)
            if shape.kind != "decode":
                port = batch_specs(specs, rules)
                want = jsh.batch_specs(jspecs, jrules)
                for k, leaf in jspecs.items():
                    assert port[k].spec == _norm(want[k].spec,
                                                 len(leaf.shape)), k
                continue
            b, s = shape.global_batch, shape.seq_len
            port = batch_specs({k: specs[k] for k in ("tokens", "pos")},
                               rules)
            want = jsh.batch_specs({k: jspecs[k] for k in ("tokens", "pos")},
                                   jrules)
            for k in ("tokens", "pos"):
                assert port[k].spec == _norm(want[k].spec,
                                             len(jspecs[k].shape))
            jleaves = _jax_cache_leaves(cfg, b, s)
            cspecs = shard_cache_tree(specs["cache"], rules, cfg)
            assert {(i, k) for i, layer in enumerate(cspecs)
                    for k in layer} == set(jleaves)
            for (i, k), jshape_ in jleaves.items():
                want = _norm(jsh.cache_sharding("", jshape_, jrules).spec,
                             len(jshape_))
                assert want[0] is None
                assert cspecs[i][k].spec == want[1:], (i, k, shape.name)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_jax(arch):
    cfg = get_config(arch)
    for shape, jshape in zip(SHAPES, JAX_SHAPES):
        specs = input_specs(cfg, shape)
        jspecs = jax_registry.input_specs(jax_get_config(arch), jshape)
        assert set(specs) == set(jspecs)
        for k, leaf in jspecs.items():
            if k == "cache":
                continue
            assert specs[k].device.type == "meta"
            assert tuple(specs[k].shape) == tuple(leaf.shape), k
            assert str(specs[k].dtype).split(".")[-1] == str(leaf.dtype), k
        if shape.kind == "decode":
            jleaves = _jax_cache_leaves(cfg, shape.global_batch,
                                        shape.seq_len)
            jtree = jax.tree_util.tree_leaves(jspecs["cache"])
            dtypes = {str(leaf.dtype) for leaf in jtree}
            for i, layer in enumerate(specs["cache"]):
                for k, t in layer.items():
                    assert t.device.type == "meta"
                    assert tuple(t.shape) == jleaves[(i, k)][1:], (i, k)
                    assert str(t.dtype).split(".")[-1] in dtypes
