"""whisper-base, the encoder-decoder, against the JAX package on bridged
tiny f32 weights (tiny_config: 2 encoder and 2 decoder layers,
encoder_seq 24): the attention modes it adds (bidirectional
self-attention, cross-attention in the forward and in decode), the
sinusoidal positions, the forward with and without frames, the loss
gradients, decode after `fill_cross_cache`, the weight bridge's checks on
the encoder and decoder stacks, and `train()` on tiny whisper on the CPU.
The decoder's S (10) is not encoder_seq, so cross-attention is an S != T
call, as at full size (448 tokens against 1,500 frames).
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

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import tiny_config as jax_tiny_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config, tiny_config  # noqa: E402
from repro_torch.convert import jax_grads, load_jax_params  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import TrainConfig, make_loss_fn  # noqa: E402,E501

ARCH = "whisper-base"
B, S = 2, 10
TOL = 1e-4
_TCFG = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=2,
                                  total_steps=10))


@functools.lru_cache(maxsize=None)
def _pair():
    """(jax model, jax params, port model, port params) of tiny f32
    whisper on shared weights; built once (no test writes to them)."""
    jm = jax_get_model(jax_tiny_config(ARCH).scaled(dtype="float32"))
    jp = jm.init_params(jax.random.key(0))
    tm = get_model(tiny_config(ARCH).scaled(dtype="float32"), "cpu")
    tp = tm.init_params(torch.Generator().manual_seed(1))
    load_jax_params(tp, jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _batch(cfg, seed=0, frames=True):
    """Numpy tokens, labels [B, S] and frames [B, encoder_seq, d] (seeded
    normals x 0.1, as tests/test_archs.py draws them)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 500, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if frames:
        batch["frames"] = (0.1 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return batch


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_every_layer_is_bridged():
    _, jp, tm, tp = _pair()
    cfg = tm.cfg
    assert (len(tp.encoder), len(tp.decoder)) == (cfg.encoder_layers,
                                                  cfg.num_layers) == (2, 2)
    sd = tp.state_dict()
    for i in range(2):
        np.testing.assert_array_equal(
            sd[f"decoder.{i}.cross_attn.wk"].numpy(),
            np.asarray(jp["decoder"]["cross_attn"]["wk"][i]))
        np.testing.assert_array_equal(
            sd[f"encoder.{i}.mlp.b_up"].numpy(),
            np.asarray(jp["encoder"]["mlp"]["b_up"][i]))


def test_full_width_parameters_match_jax():
    """Full-width whisper-base builds (the registry once raised on it) and
    holds JAX's parameter count, leaf by leaf in total."""
    cfg = get_config(ARCH)
    tp = get_model(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(jax_get_model(jax_get_config(ARCH)).init_params,
                            jax.random.key(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in tp.parameters()) == want
    assert all(p.dtype == torch.bfloat16 for p in tp.parameters())


def test_sinusoidal_matches_jax():
    """At 1,500 positions: an f32 angle near 1,500 rad carries an ulp of
    1.2e-4, and the two libraries' exp may round a frequency one ulp
    apart, so the tolerance is two ulps of the largest angle."""
    pos = np.arange(1500, dtype=np.int32)
    _close(encdec.sinusoidal(torch.from_numpy(pos), 512),
           jencdec.sinusoidal(jnp.asarray(pos), 512),
           2 * float(np.spacing(np.float32(1500))))


@pytest.mark.parametrize("mode", ["bidirectional", "causal", "cross"])
def test_attention_modes_match_jax(mode):
    """One layer's attention without RoPE: the encoder's bidirectional
    self-attention, the decoder's causal one, and cross-attention over
    T = encoder_seq frames."""
    jm, jp, tm, tp = _pair()
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    if mode == "cross":
        jw = jax.tree.map(lambda a: a[1], jp["decoder"]["cross_attn"])
        mod, kw = tp.decoder[1].cross_attn, {"memory": mem}
    else:
        jw = jax.tree.map(lambda a: a[0], jp["encoder"]["attn"])
        mod, kw = tp.encoder[0].attn, {"causal": mode == "causal"}
    want = jattn.attention_train(jm.cfg, jw, jnp.asarray(x), use_rope=False,
                                 **{k: jnp.asarray(v) if k == "memory" else v
                                    for k, v in kw.items()})
    with torch.inference_mode():
        got = mod(torch.from_numpy(x), use_rope=False,
                  **{k: torch.from_numpy(v) if k == "memory" else v
                     for k, v in kw.items()})
    _close(got, want)


def test_cross_attention_decode_matches_jax():
    """`decode(memory_kv=...)` against `attention_decode(memory_kv=...)` on
    `precompute_cross_kv`'s K/V; the self-attention cache is untouched."""
    jm, jp, tm, tp = _pair()
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    jw = jax.tree.map(lambda a: a[0], jp["decoder"]["cross_attn"])
    jkv = jattn.precompute_cross_kv(jm.cfg, jw, jnp.asarray(mem))
    cache = tm.init_cache(B, 8)[0]
    want, _ = jattn.attention_decode(
        jm.cfg, jw, jnp.asarray(x), {"k": jnp.asarray(cache["k"].numpy()),
                                     "v": jnp.asarray(cache["v"].numpy())},
        jnp.int32(3), memory_kv=jkv)
    mod = tp.decoder[0].cross_attn
    with torch.inference_mode():
        kv = mod.precompute_cross_kv(torch.from_numpy(mem))
        got = mod.decode(torch.from_numpy(x), cache, 3, memory_kv=kv)
    _close(kv["k"], jkv["k"])
    _close(kv["v"], jkv["v"])
    _close(got, want)
    assert not cache["k"].any() and not cache["v"].any()


@pytest.mark.parametrize("frames", [True, False], ids=["frames", "zeros"])
def test_forward_matches_jax(frames):
    """The forward with seeded frames, and without (zero frames [B,
    encoder_seq, d] in both packages)."""
    jm, jp, tm, tp = _pair()
    batch = _batch(tm.cfg, frames=frames)
    del batch["labels"]
    want, want_aux = jm.forward(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    with torch.inference_mode():
        got, aux = tm.forward(tp, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    assert got.shape == (B, S, want.shape[-1])
    _close(got, want)
    _close(aux, want_aux)


def test_loss_gradients_match_jax():
    jm, jp, tm, tp = _pair()
    batch = _batch(tm.cfg, seed=1)
    (jtotal, jmet), jg = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jm, _TCFG), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    total, met = make_loss_fn(tm, _TCFG)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    names, plist = zip(*tp.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, plist)))
    _close(total, jtotal)
    _close(met["loss"], jmet["loss"])
    want = jax_grads(tp, jax.tree.map(np.asarray, jg))
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        _close(g, want[name].numpy())


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per-slot"])
def test_decode_after_fill_cross_cache_matches_jax_forward(per_slot):
    """`fill_cross_cache` on the frames, then decode step by step (pos a
    scalar, or a per-slot [B] tensor) against JAX's forward."""
    jm, jp, tm, tp = _pair()
    batch = _batch(tm.cfg, seed=2)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(batch["tokens"]),
                              "frames": jnp.asarray(batch["frames"])})
    toks = torch.from_numpy(batch["tokens"])
    with torch.inference_mode():
        cache = tm.init_cache(B, S)
        cache = tp.fill_cross_cache(cache, torch.from_numpy(batch["frames"]))
        outs = []
        for t in range(S):
            pos = torch.full((B,), t) if per_slot else t
            lg, cache = tm.decode_step(tp, cache, toks[:, t], pos)
            outs.append(lg)
    _close(torch.stack(outs, dim=1), want)


def test_fill_cross_cache_matches_jax():
    jm, jp, tm, tp = _pair()
    frames = _batch(tm.cfg, seed=3)["frames"]
    jcache = jencdec.fill_cross_cache(jm.cfg, jp, jm.init_cache(B, S),
                                      jnp.asarray(frames))
    with torch.inference_mode():
        cache = tp.fill_cross_cache(tm.init_cache(B, S),
                                    torch.from_numpy(frames))
    for i, c in enumerate(cache):
        _close(c["cross_k"], jcache["cross_k"][i])
        _close(c["cross_v"], jcache["cross_v"][i])


@pytest.mark.parametrize("edit,match", [
    ("missing", "decoder.1.cross_attn.bk"),
    ("unused", "encoder.0.attn.extra"),
    ("shape", "encoder.0.norm2.scale"),
])
def test_bridge_checks_the_layer_stacks(edit, match):
    """The bridge unstacks the JAX tree's "encoder" and "decoder" entries
    and raises on a missing or unused leaf and on a shape mismatch, as
    for a decoder-only tree."""
    _, jp, tm, tp = _pair()
    tree = jax.tree.map(np.asarray, jp)
    if edit == "missing":
        tree["decoder"]["cross_attn"]["bk"] = \
            tree["decoder"]["cross_attn"]["bk"][:1]
    elif edit == "unused":
        tree["encoder"]["attn"]["extra"] = tree["encoder"]["attn"]["bq"]
    else:
        tree["encoder"]["norm2"]["scale"] = \
            tree["encoder"]["norm2"]["scale"][:, :-1]
    fresh = tm.init_params(torch.Generator().manual_seed(2))
    with pytest.raises(KeyError if edit != "shape" else ValueError,
                       match=match):
        load_jax_params(fresh, tree)


def test_train_loss_decreases_and_resume_exact(tmp_path):
    """Tiny whisper through `train()` on the CPU: the loss falls over 24
    steps, and a resume from the step-24 checkpoint to step 30 equals a
    straight run to step 30."""
    run = dict(tiny=True, batch=4, seq=32, log_every=100, schedule_steps=30,
               device="cpu")
    d1 = str(tmp_path / "a")
    out = train(ARCH, steps=24, ckpt_dir=d1, **run)
    assert out["final_loss"] < out["losses"][0]
    out2 = train(ARCH, steps=30, ckpt_dir=d1, **run)
    assert len(out2["losses"]) == 6
    out3 = train(ARCH, steps=30, ckpt_dir=str(tmp_path / "b"), **run)
    assert out2["losses"][-1] == pytest.approx(out3["losses"][-1], rel=1e-4)
