"""The port's runtime-backed serving engine (`ServeEngine(runtime=)` on
the port's `TaskRuntime`): the JAX package's three runtime tests of the
request layer (tests/test_scopes.py, tests/test_metrics.py) on a torch
stub model, and tiny bridged models in f32, whose tokens per request must
equal the JAX runtime-backed engine's and the port's private drain
loop's."""
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)
import jax  # noqa: E402

from repro.configs import tiny_config as jax_tiny_config  # noqa: E402
from repro.core import TaskRuntime as JTaskRuntime  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import tiny_config  # noqa: E402
from repro_torch.convert import load_jax_params  # noqa: E402
from repro_torch.core import TaskRuntime  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 3, 3], [11, 4, 8, 1, 6],
           [2, 6], [9, 9, 1]]
JOIN_S = 30.0


class _StubModel:
    """Just enough ModelAPI for the request layer: constant logits."""

    device = torch.device("cpu")

    def init_cache(self, batch, max_len):
        return []

    def decode_step(self, params, cache, tokens, pos):
        logits = torch.zeros((tokens.shape[0], 16))
        logits[:, 7] = 1.0
        return logits, cache


def _spin(n=200):
    return sum(range(n))


# ----------------------------------------- the JAX package's three tests
def test_serve_engine_runtime_scopes():
    """Each client queue rides a JobScope on the real runtime: outputs
    unchanged, per-client fairness counters live in the scope layer."""
    with TaskRuntime(num_workers=2, mode="ddast", num_clients=2) as rt:
        eng = ServeEngine(_StubModel(), None, batch_slots=2, max_len=8,
                          num_clients=2, runtime=rt,
                          client_weights=[2.0, 1.0])
        reqs = [eng.submit(Request(prompt=[1, 2], max_new_tokens=2),
                           i % 2) for i in range(6)]
        eng.run_until_drained()
        assert all(r.output == [7, 7] for r in reqs)
        adm = eng.scope_admission()
        assert adm["client0"]["admitted"] == 3
        assert adm["client1"]["admitted"] == 3
        assert adm["client0"]["weight"] == 2.0
    st = rt.stats.scopes
    assert st["client0"]["tasks"] == 3 and st["client1"]["tasks"] == 3


def test_serve_engine_stepped_from_dedicated_thread():
    """The serving thread differs from the constructing (main) thread:
    the pump must claim its own submit slot (one extra num_clients)
    rather than share the main slot's SPSC queue."""
    with TaskRuntime(num_workers=2, mode="sharded", num_shards=4,
                     num_clients=3) as rt:
        eng = ServeEngine(_StubModel(), None, batch_slots=2, max_len=8,
                          num_clients=2, runtime=rt)
        reqs = [eng.submit(Request(prompt=[1], max_new_tokens=2), i % 2)
                for i in range(4)]
        server = threading.Thread(target=eng.run_until_drained)
        server.start()
        # the main thread keeps submitting default-context tasks
        # concurrently: distinct slots, so both streams survive
        for i in range(50):
            rt.task(_spin, deps=[((i % 5,), "inout")])
        rt.taskwait()
        server.join(timeout=JOIN_S)
        assert not server.is_alive()
        assert all(r.output == [7, 7] for r in reqs)


def test_serve_engine_metrics_and_scrape():
    with TaskRuntime(num_workers=2, mode="ddast", num_clients=2) as rt:
        eng = ServeEngine(_StubModel(), None, batch_slots=2, max_len=8,
                          num_clients=2, runtime=rt,
                          client_deadlines=[30.0, None])
        for c in range(2):
            for _ in range(3):
                eng.submit(Request(prompt=[1, 2], max_new_tokens=2),
                           client_id=c)
        eng.run_until_drained()
        snap = eng.metrics_snapshot()
        c0 = snap["clients"]["client0"]
        assert c0["latency_steps"]["count"] == 3
        assert c0["slo"]["met"] == 3 and c0["slo"]["attainment"] == 1.0
        assert c0["admission"]["admitted"] == 3
        assert "slo" not in snap["clients"]["client1"]
        txt = eng.metrics_text()
        assert ('repro_request_latency_steps_count{client="client0"} 3'
                in txt)
        assert 'repro_client_slo_attainment{client="client0"} 1' in txt
        srv, port = eng.serve_metrics()
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10
            ).read().decode()
        finally:
            srv.shutdown()
        assert 'repro_request_latency_steps' in body


# -------------------------------------------------------- arguments
def test_client_arguments_checked_as_reference():
    with TaskRuntime(num_workers=1, num_clients=2) as rt:
        with pytest.raises(ValueError, match="num_clients entries"):
            ServeEngine(_StubModel(), None, num_clients=2, runtime=rt,
                        client_weights=[1.0])
        with pytest.raises(ValueError, match="num_clients entries"):
            ServeEngine(_StubModel(), None, num_clients=2, runtime=rt,
                        client_deadlines=[1.0, 2.0, 3.0])


def test_runtime_without_client_slots_raises():
    """No quiet fall-back to the private loop: a runtime sized with no
    client slots refuses the scopes, as the JAX package's does."""
    with TaskRuntime(num_workers=1) as rt:
        with pytest.raises(ValueError, match="num_clients"):
            ServeEngine(_StubModel(), None, num_clients=2, runtime=rt)
    with JTaskRuntime(num_workers=1) as jrt:
        with pytest.raises(ValueError, match="num_clients"):
            JServeEngine(_StubModel(), None, num_clients=2, runtime=jrt)


# ---------------------------------------------- bridged tiny models
def _serve(engine_cls, request_cls, model, params, runtime=None):
    """PROMPTS from 2 clients into 2 slots, 5 new tokens each. Returns
    {prompt: tokens}, keyed by prompt since the runtime's admission
    order depends on thread timing."""
    eng = engine_cls(model, params, batch_slots=2, max_len=32,
                     num_clients=2, runtime=runtime)
    reqs = [eng.submit(request_cls(prompt=p, max_new_tokens=5), i % 2)
            for i, p in enumerate(PROMPTS)]
    eng.run_until_drained()
    assert all(r.done_event.is_set() for r in reqs)
    return eng, {tuple(r.prompt): r.output for r in reqs}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b"])
def test_runtime_engine_matches_jax_runtime_engine(arch):
    jm = jax_get_model(jax_tiny_config(arch).scaled(dtype="float32"))
    jp = jm.init_params(jax.random.key(0))
    tm = get_model(tiny_config(arch).scaled(dtype="float32"), "cpu")
    tp = tm.init_params(torch.Generator().manual_seed(0))
    load_jax_params(tp, jax.tree.map(np.asarray, jp))
    with JTaskRuntime(num_workers=2, mode="ddast", num_clients=2) as jrt:
        _, want = _serve(JServeEngine, JRequest, jm, jp, jrt)
    with TaskRuntime(num_workers=2, mode="ddast", num_clients=2) as rt:
        eng, got = _serve(ServeEngine, Request, tm, tp, rt)
        adm = eng.scope_admission()
    assert got == want
    assert eng.stats["nonfinite_steps"] == 0
    assert adm["client0"]["admitted"] == adm["client1"]["admitted"] == 3
    _, private = _serve(ServeEngine, Request, tm, tp)
    assert got == private
    assert all(len(t) == 5 for t in got.values())
