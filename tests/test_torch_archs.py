"""Every decoder arch of the zoo against the JAX package on bridged tiny
f32 weights: the port versions of tests/test_archs.py's three checks.

- the forward against JAX's forward;
- the loss (NLL, z-loss, MoE aux) and every parameter gradient against
  `jax.value_and_grad` of JAX's loss;
- decode step by step against JAX's forward, with capacity_factor=16 so
  that MoE drops no token.

S = 40: `tiny_config` sets sliding_window=16, so gemma2-27b's local
layers mask keys (tests/test_archs.py's S = 16 and 8 mask none).
jamba-v0.1-52b runs its whole 8-position period once (tiny_config keeps
pattern[:4], which has no attention layer). chameleon-34b's forward and
gradients take `embeds` (its vision frontend feeds them), which is what
sets its cases apart from minitron-4b's: the tiny configs of the two are
the same model. Decode takes tokens in both packages, so its case runs
on tokens. xlstm-125m runs its mLSTM and sLSTM layers through the plain
scans (tests/test_torch_xlstm.py holds its mixers). The encoder-decoder
whisper-base is not here (tests/test_torch_encdec.py holds it).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import tiny_config as jax_tiny_config  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config, tiny_config  # noqa: E402
from repro_torch.convert import jax_grads, load_jax_params  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402,E501
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          make_loss_fn, make_train_step)

DECODER_ARCHS = sorted(
    name for name, cfg in JAX_ARCHS.items()
    if not cfg.is_encoder_decoder
    and all(b.mixer in ("attn", "attn_local", "mamba", "mlstm", "slstm")
            for b in cfg.pattern))
JAMBA = "jamba-v0.1-52b"
EMBEDS_ARCHS = ("chameleon-34b",)        # frontend="vision" feeds embeds
B, S = 2, 40
TOL = 1e-4
_TCFG = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=2,
                                  total_steps=10))


def test_every_decoder_arch_is_held():
    assert DECODER_ARCHS == ["chameleon-34b", "gemma2-27b", JAMBA,
                             "minitron-4b", "qwen2-0.5b", "qwen2-72b",
                             "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
                             "xlstm-125m"]
    assert S > tiny_config("gemma2-27b").sliding_window


def _cfg(tiny, full, arch, capacity_factor):
    cfg = tiny(arch).scaled(dtype="float32")
    if arch == JAMBA:
        cfg = cfg.scaled(pattern=full(arch).pattern, repeats=1)
    if capacity_factor is not None:
        cfg = cfg.scaled(capacity_factor=capacity_factor)
    return cfg


@functools.lru_cache(maxsize=None)
def _pair(arch, capacity_factor=None):
    """(jax model, jax params, port model, port params) of tiny f32 `arch`
    on shared weights; built once per argument set (no test writes to
    the params)."""
    jm = jax_get_model(_cfg(jax_tiny_config, jax_get_config, arch,
                            capacity_factor))
    jp = jm.init_params(jax.random.key(0))
    tm = get_model(_cfg(tiny_config, get_config, arch, capacity_factor),
                   "cpu")
    tp = tm.init_params(torch.Generator().manual_seed(1))
    load_jax_params(tp, jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _batch(arch, d_model, seed=0):
    """Numpy tokens and labels [B, S] (and embeds [B, S, d] for an arch
    fed by a frontend), from a seed."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 500, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if arch in EMBEDS_ARCHS:
        batch["embeds"] = rng.standard_normal((B, S, d_model)).astype(
            np.float32)
    return batch


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_forward_matches_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(arch, tm.cfg.d_model)
    want, want_aux = jm.forward(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    with torch.inference_mode():
        got, aux = tm.forward(tp, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    _close(got, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_loss_gradients_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(arch, tm.cfg.d_model, seed=1)
    (jtotal, jmet), jg = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jm, _TCFG), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    total, met = make_loss_fn(tm, _TCFG)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    names, plist = zip(*tp.named_parameters())
    # with embeds the embedding table gets no gradient: zero, as in JAX
    grads = dict(zip(names, torch.autograd.grad(total, plist,
                                                 materialize_grads=True)))
    _close(total, jtotal)
    _close(met["loss"], jmet["loss"])
    _close(met["aux"], jmet["aux"])
    want = jax_grads(tp, jax.tree.map(np.asarray, jg))
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        _close(g, want[name].numpy())


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_decode_matches_jax_forward(arch):
    jm, jp, tm, tp = _pair(arch, capacity_factor=16.0)
    tokens = _batch(arch, tm.cfg.d_model, seed=2)["tokens"]
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    toks = torch.from_numpy(tokens)
    with torch.inference_mode():
        cache = tm.init_cache(B, S)
        outs = []
        for t in range(S):
            lg, cache = tm.decode_step(tp, cache, toks[:, t], t)
            outs.append(lg)
    _close(torch.stack(outs, dim=1), want)


@pytest.mark.parametrize("arch", EMBEDS_ARCHS)
def test_train_step_with_embeds_matches_jax(arch):
    """A train step on a batch that carries `embeds`: the embedding table
    gets a zero gradient (weight decay alone moves it), as under
    jax.grad; the port's step once raised on the unused parameter."""
    jm, jp, tm, _ = _pair(arch)
    tp = tm.init_params(torch.Generator().manual_seed(1))
    load_jax_params(tp, jax.tree.map(np.asarray, jp))
    batch = _batch(arch, tm.cfg.d_model, seed=3)
    jp2, _, jmet = jax.jit(jts.make_train_step(jm, _TCFG))(
        jp, jopt.init_opt_state(jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp, opt, met = make_train_step(tm, _TCFG)(
        tp, init_opt_state(tp), {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        _close(met[key], jmet[key])
    want = jax_grads(tp, jax.tree.map(np.asarray, jp2))
    for name, p in tp.named_parameters():
        _close(p, want[name].numpy())
