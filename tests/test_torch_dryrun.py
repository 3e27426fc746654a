"""The port's dry-run (`repro_torch.launch.dryrun`) on tiny configs on a
2 x 2 fake world, one cell of each kind over five families; its skip
policy against the JAX package's; `fake_world` leaving no process group;
and the models unchanged by a mesh in scope on plain tensors."""
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.launch import dryrun as jax_dryrun  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro_torch.configs import ARCHS, tiny_config  # noqa: E402
from repro_torch.launch.dryrun import lower_cell, should_skip  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_host_mesh  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.parallel.collectives import mesh_scope, strategy  # noqa: E402

KEYS = {"arch", "shape", "mesh", "kind", "devices", "lower_s",
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "flops", "hbm_bytes", "collectives",
        "terms_s", "dominant", "model_flops", "useful_ratio", "compile_s",
        "xla_flops_raw", "xla_bytes_raw", "collective_ops", "replicated_ops"}
COLLS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute"}

# (arch, kind, config overrides): a dense, a MoE, Jamba, xlstm, whisper
CELLS = [("qwen2-0.5b", "prefill", {}),
         ("jamba-v0.1-52b", "decode", {}),
         ("xlstm-125m", "decode", {}),
         ("whisper-base", "prefill", {}),
         ("qwen2-moe-a2.7b", "train", {"repeats": 1})]


@pytest.fixture(autouse=True)
def no_process_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,kind,over", CELLS,
                         ids=[f"{a}-{k}" for a, k, _ in CELLS])
def test_lower_cell_on_a_tiny_config(arch, kind, over):
    cfg = tiny_config(arch).scaled(**over)
    shape = ShapeSpec("tiny", 16, 4, kind)
    rec = lower_cell(arch, "tiny", False, cfg=cfg, shape=shape,
                     mesh_shape=(2, 2))
    assert set(rec) == KEYS, set(rec) ^ KEYS
    assert rec["kind"] == kind and rec["devices"] == 4
    assert rec["compile_s"] is None
    assert set(rec["collectives"]) == COLLS
    assert sum(rec["collectives"].values()) > 0    # a sharded step gathers
    assert rec["flops"] > 0 and rec["hbm_bytes"] > 0
    assert rec["temp_size_in_bytes"] > 0
    assert rec["argument_size_in_bytes"] > 0 < rec["output_size_in_bytes"]
    assert set(rec["terms_s"]) == {"compute", "memory", "collective"}
    assert rec["dominant"] in rec["terms_s"]
    assert rec["useful_ratio"] == rec["model_flops"] / rec["flops"]


def test_no_compile_places_the_arguments_only():
    rec = lower_cell("qwen2-0.5b", "tiny", False, compile_=False,
                     cfg=tiny_config("qwen2-0.5b"),
                     shape=ShapeSpec("tiny", 16, 4, "train"),
                     mesh_shape=(2, 2))
    assert rec["argument_size_in_bytes"] > 0 and "flops" not in rec


def test_should_skip_matches_jax():
    for arch in sorted(ARCHS):
        for shape, jshape in zip(SHAPES, JAX_SHAPES):
            assert should_skip(arch, shape) == \
                jax_dryrun.should_skip(arch, jshape)
    rec = lower_cell("qwen2-0.5b", "long_500k", False)
    assert set(rec) == {"arch", "shape", "mesh", "skip"}


def test_fake_world_is_destroyed_when_the_body_raises():
    with pytest.raises(ValueError):
        with fake_world(4):
            assert dist.get_world_size() == 4
            raise ValueError("boom")
    assert not dist.is_initialized()
    with fake_world(8):
        assert make_host_mesh(2).shape == (4, 2)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-base"])
def test_models_bit_identical_with_a_mesh_in_scope(arch):
    """`constrain` on plain tensors is the identity: the forward and the
    decode step give the same bits with and without a mesh in scope."""
    cfg = tiny_config(arch).scaled(dtype="float32")
    model = get_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))

    def run():
        logits, aux = model.forward(params, {"tokens": toks})
        cache = model.init_cache(2, 16)
        step = model.decode_step(params, cache, toks[:, 0], 3)[0]
        return logits, aux, step

    want = run()
    with fake_world(4):
        with mesh_scope(make_host_mesh(2)), strategy(tp=True, moe="ep"):
            got = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
