"""Two places where the port once differed from the JAX package, each held
against it on bridged weights: a batch's `embeds` replace the embedding
lookup in the forward, and a prompt longer than the engine's `max_len`
completes, its KV write clamped to the cache's last row as
`dynamic_update_slice` clamps it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import tiny_config as jax_tiny_config  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import tiny_config  # noqa: E402
from repro_torch.convert import load_jax_params  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402


def _pair(arch):
    jm = jax_get_model(jax_tiny_config(arch).scaled(dtype="float32"))
    jp = jm.init_params(jax.random.key(0))
    tm = get_model(tiny_config(arch).scaled(dtype="float32"), "cpu")
    tp = tm.init_params(torch.Generator().manual_seed(0))
    load_jax_params(tp, jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b"])
def test_forward_uses_embeds(arch):
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tm.cfg.vocab_size, (2, 6)).astype(np.int32)
    embeds = rng.standard_normal((2, 6, tm.cfg.d_model)).astype(np.float32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens),
                              "embeds": jnp.asarray(embeds)})
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        got, _ = tm.forward(tp, {"tokens": t,
                                 "embeds": torch.from_numpy(embeds)})
        plain, _ = tm.forward(tp, {"tokens": t})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    assert np.abs(got.numpy() - plain.numpy()).max() > 1e-2


def _overflow(engine_cls, request_cls, model, params):
    eng = engine_cls(model, params, batch_slots=2, max_len=8)
    req = request_cls(prompt=[(3 * i + 1) % 50 for i in range(10)],
                      max_new_tokens=2)
    eng.submit(req, 0)
    eng.run_until_drained()
    return eng, req


def test_prompt_longer_than_max_len_completes():
    jm, jp, tm, tp = _pair("qwen2-0.5b")
    jeng, jreq = _overflow(JServeEngine, JRequest, jm, jp)
    eng, req = _overflow(ServeEngine, Request, tm, tp)
    assert jreq in jeng.completed and req in eng.completed
    assert (eng.steps, req.finished_step) == (jeng.steps, jreq.finished_step)
    assert req.output == jreq.output and len(req.output) == 1
    assert eng.stats["nonfinite_steps"] == 0


def test_decode_clamps_cache_write():
    """Positions past the cache write its last row in both branches of
    `Attention.decode`, with RoPE and kv_len at the true position."""
    _, _, tm, tp = _pair("qwen2-0.5b")
    attn = tp.layers[0].mixer
    x = torch.randn(2, 1, tm.cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    outs = []
    with torch.no_grad():
        for pos in (9, torch.tensor([9, 9])):
            cache = tm.init_cache(2, 8)[0]
            outs.append(attn.decode(x, cache, pos))
            assert cache["k"][:, 7].abs().sum() > 0
            assert cache["k"][:, :7].abs().sum() == 0
    torch.testing.assert_close(outs[0], outs[1])
