"""The port's roofline (`repro_torch.analysis.roofline`) against the JAX
package's: `model_flops` on every arch x shape, the terms on the H100's
data-sheet rates, and the step counter's flops and dot bytes on tiny
qwen2-0.5b against `analyze_hlo` of the jitted JAX steps (CPU, f32)."""
import numpy as np
import pytest

pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.analysis.roofline import analyze_hlo  # noqa: E402
from repro.analysis.roofline import model_flops as jax_model_flops  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import tiny_config as jax_tiny_config  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.train import train_step as jax_train_step  # noqa: E402
from repro_torch.analysis.roofline import (PEAKS, RooflineTerms,  # noqa: E402
                                           StepCounter, model_flops,
                                           peaks_for)
from repro_torch.configs import ARCHS, get_config, tiny_config  # noqa: E402
from repro_torch.convert import load_jax_params  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train import train_step  # noqa: E402

B, S, L = 2, 16, 32          # batch, prompt length, decode cache length
PREFILL_FLOPS = 7_077_888    # analyze_hlo of the jitted JAX prefill
JAX_TRAIN_FLOPS = 25_165_824  # analyze_hlo of the jitted JAX train step


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_matches_jax(arch):
    for shape, jshape in zip(SHAPES, JAX_SHAPES):
        assert shape.name == jshape.name
        assert model_flops(get_config(arch), shape) == \
            jax_model_flops(jax_get_config(arch), jshape)


def test_terms_on_h100_rates():
    sxm = PEAKS["H100 SXM"]
    t = RooflineTerms(flops=sxm.bf16_fps * 256, hbm_bytes=0.0,
                      coll_bytes={}, devices=256)
    assert t.seconds() == {"compute": 1.0, "memory": 0.0, "collective": 0.0}
    assert t.dominant() == "compute"
    t = RooflineTerms(flops=0.0, hbm_bytes=sxm.hbm_bps * 4,
                      coll_bytes={"all-gather": sxm.link_bps * 4,
                                  "all-reduce": sxm.link_bps * 4},
                      devices=4)
    assert t.seconds() == {"compute": 0.0, "memory": 1.0, "collective": 2.0}
    assert t.dominant() == "collective"
    assert peaks_for("NVIDIA H100 80GB HBM3") == ("H100 SXM", sxm)
    assert peaks_for("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    assert peaks_for("NVIDIA H100 NVL")[0] == "H100 NVL"


@pytest.fixture(scope="module")
def tiny():
    """Tiny qwen2-0.5b in f32: JAX params and the port's on the same
    weights, and a batch from a seeded numpy draw."""
    jcfg = jax_tiny_config("qwen2-0.5b").scaled(dtype="float32")
    cfg = tiny_config("qwen2-0.5b").scaled(dtype="float32")
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init_params(jax.random.key(0))
    model = get_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    load_jax_params(params, jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    return jmodel, jparams, model, params, toks


def _jax_terms(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text(), 1)


def _count(fn, *args):
    with StepCounter() as counter:
        fn(*args)
    return counter


def test_prefill_flops_and_dot_bytes_equal_analyze_hlo(tiny):
    jmodel, jparams, model, params, toks = tiny
    want = _jax_terms(jax_train_step.make_prefill_step(jmodel), jparams,
                      {"tokens": jnp.asarray(toks)})
    got = _count(train_step.make_prefill_step(model), params,
                 {"tokens": torch.from_numpy(toks)})
    assert want.flops == got.flops == PREFILL_FLOPS
    # mm: the projections, MLPs and logits; bmm: attention's two products
    assert got.dot_flops == {"aten.mm": 6_815_744, "aten.bmm": 262_144}
    assert got.hbm_bytes == want.hbm_bytes
    assert got.terms().total_coll == 0


def test_decode_flops_equal_analyze_hlo(tiny):
    jmodel, jparams, model, params, toks = tiny
    jcache = jmodel.init_cache(B, L)
    want = _jax_terms(jax_train_step.make_serve_step(jmodel), jparams, jcache,
                      jnp.asarray(toks[:, 0]), jnp.int32(5))
    cache = model.init_cache(B, L)
    got = _count(train_step.make_serve_step(model), params, cache,
                 torch.from_numpy(toks[:, 0]), torch.tensor(5))
    assert got.flops == want.flops > 0


def test_train_flops_are_three_prefills(tiny):
    """The port's train step runs the forward once and its backward (two
    products a product): 3 x the prefill. JAX's analyze_hlo counts
    25,165,824 for its train step: the JAX forward rematerialises each
    period in the backward (`@jax.checkpoint`, repro/models/
    transformer.py:110), the port keeps the activations instead, so the
    two differ by that recompute, not by a fault."""
    jmodel, jparams, model, params, toks = tiny
    from repro_torch.train.optimizer import init_opt_state
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    got = _count(train_step.make_train_step(model, train_step.TrainConfig()),
                 params, init_opt_state(params), batch)
    assert got.flops == 3 * PREFILL_FLOPS
    from repro.train.optimizer import init_opt_state as jax_init_opt
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want = _jax_terms(jax_train_step.make_train_step(
        jmodel, jax_train_step.TrainConfig()), jparams,
        jax_init_opt(jparams), jbatch)
    assert want.flops == JAX_TRAIN_FLOPS


def test_collective_bytes_of_a_dtensor_product_on_a_fake_world():
    """A [16, 32] @ B [32, 8] on a 2 x 2 fake world, A's rows and B's rows
    (the contraction) split on "data". DTensor's plan: B's columns split
    on "model" (a local chunk, no message), then B's rows gathered on
    "data": one all-gather whose result is 32 x 4 f32 = 512 B a rank; each
    rank multiplies its 8 rows of A by its 4 columns of B, and C comes out
    split both ways."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import fake_world, make_host_mesh
    with fake_world(4):
        mesh = make_host_mesh(2)
        with FakeTensorMode():
            a = DTensor.from_local(torch.empty(8, 32), mesh,
                                   (Shard(0), Replicate()), run_check=False)
            b = DTensor.from_local(torch.empty(16, 8), mesh,
                                   (Shard(0), Replicate()), run_check=False)
            with StepCounter(devices=4) as counter:
                c = a @ b
            assert tuple(c.shape) == (16, 8)
            assert tuple(c.placements) == (Shard(0), Shard(1))
    assert counter.coll_ops == {"all-gather": 1}
    terms = counter.terms()
    assert terms.coll_bytes["all-gather"] == 4 * 32 * 4 * 4
    assert terms.total_coll == 4 * 32 * 4 * 4
    assert terms.flops == 4 * 2 * 8 * 32 * 4
