"""Port model vs the JAX model on the same weights: the weight bridge,
`MoE.forward` against `apply_moe` (decode and a dropping prefill),
`decode_step` logits with per-slot positions in f32 and bf16, the
port's decode against its own forward (tests/test_archs.py's check), and
the whole forward of tiny qwen2-moe and qwen3-moe against JAX's."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import tiny_config as jax_tiny_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import tiny_config  # noqa: E402
from repro_torch.convert import jax_state_dict, load_jax_params  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

ARCH = "qwen2-moe-a2.7b"


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32", arch=ARCH, capacity_factor=1.25):
    """(jax model, jax params, port model, port params) on shared weights;
    built once per argument set (no test writes to the params)."""
    over = dict(capacity_factor=capacity_factor)
    jcfg = jax_tiny_config(arch).scaled(dtype=dtype, **over)
    jm = jax_get_model(jcfg)
    jp = jm.init_params(jax.random.key(0))
    tm = get_model(tiny_config(arch).scaled(dtype=dtype, **over), "cpu")
    tp = tm.init_params(torch.Generator().manual_seed(1))
    load_jax_params(tp, jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_bridge_copies_every_leaf():
    _, jp, _, tp = _pair()
    sd = tp.state_dict()
    np.testing.assert_array_equal(
        sd["layers.1.ffn.w_up"].numpy(),
        np.asarray(jp["layers"][0]["ffn"]["w_up"][1]))
    np.testing.assert_array_equal(
        sd["layers.0.mixer.bq"].numpy(),
        np.asarray(jp["layers"][0]["mixer"]["bq"][0]))
    assert len(sd) == len(jax_state_dict(jax.tree.map(np.asarray, jp), 1))


def test_bridge_raises_on_missing_leaf():
    _, jp, tm, tp = _pair()
    tree = jax.tree.map(np.asarray, jp)
    del tree["layers"][0]["ffn"]["router"]
    with pytest.raises(KeyError, match="router"):
        load_jax_params(tp, tree)


def test_bridge_raises_on_unused_leaf():
    _, jp, tm, tp = _pair()
    tree = jax.tree.map(np.asarray, jp)
    tree["final_norm"]["bias"] = np.zeros(tree["final_norm"]["scale"].shape,
                                          np.float32)
    with pytest.raises(KeyError, match="final_norm.bias"):
        load_jax_params(tp, tree)


def _moe_case(s, crowd):
    """x [2,s,d]; with `crowd` every token is near one vector, so all pick
    the same experts and the capacity drops some of them."""
    rng = np.random.RandomState(3)
    d = 64
    if crowd:
        x = rng.randn(1, 1, d) + 0.01 * rng.randn(2, s, d)
    else:
        x = rng.randn(2, s, d)
    return x.astype(np.float32)


@pytest.mark.parametrize("s,crowd", [(1, False), (8, False), (8, True)])
def test_apply_moe_matches_jax(s, crowd):
    jm, jp, tm, tp = _pair()
    cfg = tm.cfg
    x = _moe_case(s, crowd)
    p0 = jax.tree.map(lambda a: a[0], jp["layers"][0]["ffn"])
    want, want_aux = jax.jit(jax_moe.apply_moe, static_argnums=0)(
        jm.cfg, p0, jnp.asarray(x))
    with torch.inference_mode():
        got, aux = tp.layers[0].ffn(torch.from_numpy(x))
    _close(got, want, 1e-4)
    _close(aux, want_aux, 1e-5)
    if crowd:
        # the case must really overflow an expert's capacity
        logits = x.reshape(-1, x.shape[-1]) @ np.asarray(p0["router"])
        top = np.argsort(-logits[:, :cfg.num_experts], axis=1)[:, :2]
        counts = np.bincount(top[:s].ravel(), minlength=cfg.num_experts)
        assert counts.max() > capacity(cfg, s)


def _decode_pair(dtype):
    jm, jp, tm, tp = _pair(dtype)
    b, L = 3, 16
    offs = np.array([0, 2, 5], np.int32)
    toks = np.random.RandomState(7).randint(0, 500, (6, b)).astype(np.int32)
    jcache = jm.init_cache(b, L)
    tcache = tm.init_cache(b, L)
    step = jax.jit(jm.decode_step)
    outs = []
    for t in range(6):
        pos = offs + t
        jl, jcache = step(jp, jcache, jnp.asarray(toks[t]), jnp.asarray(pos))
        with torch.inference_mode():
            tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(toks[t]),
                                        torch.from_numpy(pos))
        outs.append((tl.float().numpy(), np.asarray(jl, np.float32)))
    return outs


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_decode_step_matches_jax_per_slot(dtype, tol):
    for got, want in _decode_pair(dtype):
        _close(got, want, tol)


@pytest.mark.parametrize("arch", [ARCH, "qwen2-0.5b", "gemma2-27b"])
def test_decode_matches_own_forward(arch):
    # high capacity factor so MoE drops nothing (drop-free equivalence)
    cfg = tiny_config(arch).scaled(dtype="float32", capacity_factor=16.0)
    m = get_model(cfg, "cpu")
    params = m.init_params(torch.Generator().manual_seed(1))
    b, s = 2, 8
    toks = torch.from_numpy(
        np.random.RandomState(5).randint(0, 100, (b, s)).astype(np.int64))
    with torch.inference_mode():
        ref, _ = m.forward(params, {"tokens": toks})
        cache = m.init_cache(b, s)
        outs = []
        for t in range(s):
            lg, cache = m.decode_step(params, cache, toks[:, t], t)
            outs.append(lg)
    dec = torch.stack(outs, dim=1)
    assert float((dec - ref).abs().max()) < 1e-4


def _check_forward(arch):
    jm, jp, tm, tp = _pair(arch=arch, capacity_factor=16.0)
    toks = np.random.RandomState(2).randint(0, 500, (2, 8)).astype(np.int32)
    want, want_aux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, 1e-4)
    _close(aux, want_aux, 1e-5)


def test_forward_matches_jax():
    _check_forward(ARCH)


def test_qwen3_moe_forward_matches_jax():
    """qwen3-moe-235b-a22b: 128 experts top-8 (tiny: 8 top-2), no shared
    experts, GQA with head_dim set apart from d_model / num_heads."""
    _check_forward("qwen3-moe-235b-a22b")
