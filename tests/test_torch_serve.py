"""The port's serving engine: the same tokens as the JAX engine on bridged
weights, the same tokens as its own greedy decode, continuous batching
through the launcher, and no quiet fall-back to the CPU."""
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
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import greedy_decode  # noqa: E402

PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 3, 3], [11, 4, 8, 1, 6]]


def _run_engine(engine_cls, request_cls, model, params):
    eng = engine_cls(model, params, batch_slots=2, max_len=32, num_clients=2)
    reqs = [request_cls(prompt=p, max_new_tokens=5) for p in PROMPTS]
    for i, r in enumerate(reqs):
        eng.submit(r, i % 2)
    eng.run_until_drained()
    return eng, [r.output for r in reqs]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen2-0.5b"])
def test_engine_matches_jax_engine(arch):
    jm = jax_get_model(jax_tiny_config(arch).scaled(dtype="float32"))
    jp = jm.init_params(jax.random.key(0))
    tm = get_model(tiny_config(arch).scaled(dtype="float32"), "cpu")
    tp = tm.init_params(torch.Generator().manual_seed(0))
    load_jax_params(tp, jax.tree.map(np.asarray, jp))
    _, want = _run_engine(JServeEngine, JRequest, jm, jp)
    eng, got = _run_engine(ServeEngine, Request, tm, tp)
    assert got == want
    assert eng.stats["nonfinite_steps"] == 0


def test_engine_matches_greedy_reference():
    m = get_model(tiny_config("qwen2-moe-a2.7b").scaled(dtype="float32"),
                  "cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    eng, outs = _run_engine(ServeEngine, Request, m, params)
    for p, out in zip(PROMPTS, outs):
        want = greedy_decode(m, params, torch.tensor([p]), 5, 32)
        assert out == want[0].tolist(), (p, out)
    text = eng.metrics_text()
    assert 'repro_request_latency_steps_count{client="client0"} 2' in text
    assert eng.metrics_snapshot()["gauges"]["admitted"] == len(PROMPTS)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b"])
def test_serve_continuous_batching(arch):
    out = serve(arch, num_requests=10, clients=3, slots=3, max_new=4,
                device="cpu")
    assert out["requests"] == 10
    assert out["tokens"] == 40
    assert out["stats"]["admitted"] == 10
    assert out["stats"]["nonfinite_steps"] == 0


def test_serve_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve("qwen2-moe-a2.7b", num_requests=1, clients=1)
    with pytest.raises(RuntimeError, match="cuda"):
        get_model(tiny_config("qwen2-moe-a2.7b"))


def test_unported_families_raise():
    # whisper is ported as a model, but the serving launcher refuses an
    # encoder-decoder, as the JAX launcher does (repro/launch/serve.py)
    with pytest.raises(SystemExit, match="decoder-only"):
        serve("whisper-base", num_requests=1, clients=1, device="cpu")
