"""The port's xLSTM mixers and stack against the JAX package on bridged
weights: `MLSTM` / `SLSTM` forward and decode against `mlstm_train` /
`slstm_train` and `mlstm_decode` / `slstm_decode`; the plain scans
against a `lax.scan` of JAX's step functions; the scan wrappers on the
CPU; the bridge; the engine against greedy decode and the JAX engine,
with slots reused; `train()` with a resume.

Tolerances: f32 1e-4, bf16 3e-2 (the JAX package's own). The forward
runs at S = 256, where JAX takes `chunked_scan`'s remat branch (S % 128
== 0 and S > 128); that branch changes no forward value, so f32 holds to
1e-4 there too. In bf16 both sides round the projections' products to
bf16 (sums in another order on each side, so a few ulps apart), then
run the recurrence in f32 and round y back to bf16 before `out_proj`.
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

from repro.configs import tiny_config as jax_tiny_config  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import tiny_config  # noqa: E402
from repro_torch.convert import jax_state_dict, load_jax_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import xlstm_scan  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    mlstm_scan_bwd_ref, mlstm_scan_ref, mlstm_scan_states_ref,
    slstm_scan_dpre_ref, slstm_scan_ref,
    slstm_scan_trails_ref)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.ssm import MLSTM, SLSTM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import greedy_decode  # noqa: E402

ARCH = "xlstm-125m"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 3, 3], [11, 4, 8, 1, 6]]
# pattern position of each mixer kind in xlstm's period (m, s, m, m)
POS = {"mlstm": 0, "slstm": 1}
F32_LEAVES = {"mlstm": ("w_i", "w_f", "b_i", "b_f"),
              "slstm": ("w_r", "bias")}


@functools.lru_cache(maxsize=None)
def _jax_params_f32():
    jm = jax_get_model(jax_tiny_config(ARCH).scaled(dtype="float32"))
    return jax.jit(jm.init_params)(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    """(jax model, jax params, port model, port params) of tiny xlstm on
    shared weights; built once per dtype (no test writes to the params).
    The bf16 tree is the f32 one cast leaf by leaf to the dtypes a bf16
    init gives (the gates, w_r and bias stay f32)."""
    jm = jax_get_model(jax_tiny_config(ARCH).scaled(dtype=dtype))
    jp = _jax_params_f32()
    if dtype != "float32":
        like = jax.eval_shape(jm.init_params, jax.random.key(0))
        jp = jax.tree.map(lambda a, s: a.astype(s.dtype), jp, like)
    tm = get_model(tiny_config(ARCH).scaled(dtype=dtype), "cpu")
    tp = tm.init_params(torch.Generator().manual_seed(1))
    load_jax_params(tp, jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _mixer(kind, dtype):
    """(jax cfg, the JAX params of repeat 0 at `kind`'s position, the
    port's mixer of layer POS[kind])."""
    jm, jp, _, tp = _pair(dtype)
    pos = POS[kind]
    p = jax.tree.map(lambda a: a[0], jp["layers"][pos]["mixer"])
    return jm.cfg, p, tp.layers[pos].mixer


def _as_torch(x, dtype):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))


def test_stack_and_bridge():
    """Tiny xlstm keeps the period (mLSTM, sLSTM, mLSTM, mLSTM); the bridge
    carries w_r [repeats, 4, H, hd, hd] to each layer and keeps the gates,
    w_r and bias in f32 in a bf16 model; a fresh init opens the forget
    gates (b_f = 3), as JAX's does."""
    _, jp, tm, tp = _pair("bfloat16")
    assert [type(layer.mixer).__name__ for layer in tp.layers] == \
        ["MLSTM", "SLSTM", "MLSTM", "MLSTM"] * 2
    for kind, pos in POS.items():
        mixer = tp.layers[pos].mixer
        for name, p in mixer.named_parameters():
            want = torch.float32 if name in F32_LEAVES[kind] \
                else torch.bfloat16
            assert p.dtype == want, (kind, name, p.dtype)
    w_r = np.asarray(jp["layers"][1]["mixer"]["w_r"])
    assert w_r.shape == (2, 4, 4, 16, 16)
    for r in range(2):
        np.testing.assert_array_equal(
            tp.layers[4 * r + 1].mixer.w_r.detach().numpy(), w_r[r])
    sd = jax_state_dict(jax.tree.map(np.asarray, jp), 4)
    assert sd["layers.5.mixer.w_r"].dtype == torch.float32
    fresh = get_model(tiny_config(ARCH), "cpu").init_params(
        torch.Generator().manual_seed(0))
    assert torch.equal(fresh.layers[0].mixer.b_f,
                       torch.full((4,), 3.0))


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("kind", sorted(POS))
def test_mixer_forward_matches_jax(kind, dtype):
    """S = 256: JAX's chunked-remat branch (two 128-step chunks)."""
    cfg, p, mixer = _mixer(kind, dtype)
    x = jnp.asarray(np.random.RandomState(3).randn(2, 256, 64)) \
        .astype(cfg.jnp_dtype)
    fn = jax_ssm.mlstm_train if kind == "mlstm" else jax_ssm.slstm_train
    want = jax.jit(fn, static_argnums=0)(cfg, p, x)
    with torch.inference_mode():
        got = mixer(_as_torch(x, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("kind", sorted(POS))
def test_mixer_decode_matches_jax(kind, dtype):
    """Five steps of the recurrence from a zero state: outputs and the
    carried state (all f32)."""
    cfg, p, mixer = _mixer(kind, dtype)
    _, _, tm, _ = _pair(dtype)
    b = 3
    init = jax_ssm.init_mlstm_state if kind == "mlstm" \
        else jax_ssm.init_slstm_state
    jstate = init(cfg, b)
    tstate = transformer.init_cache(tm.cfg, b, 8, torch.device("cpu"))[
        POS[kind]]
    assert sorted(tstate) == sorted(jstate)
    for key, t in tstate.items():
        assert t.shape == jstate[key].shape and t.dtype == torch.float32
    step = jax.jit(jax_ssm.mlstm_decode if kind == "mlstm"
                   else jax_ssm.slstm_decode, static_argnums=0)
    rng = np.random.RandomState(4)
    for _ in range(5):
        x = jnp.asarray(rng.randn(b, 1, 64)).astype(cfg.jnp_dtype)
        want, jstate = step(cfg, p, x, jstate)
        with torch.inference_mode():
            got = mixer.decode(_as_torch(x, dtype), tstate)
        _close(got, want, TOL[dtype])
    for key, t in tstate.items():
        _close(t, jstate[key], TOL[dtype])


def _scan_inputs(kind, seed=0, b=2, s=33, h=2, hd=16):
    """Numpy f32 inputs of a scan from a seed: (q scaled, k, v, i, f) or
    (pre, w_r, bias)."""
    rng = np.random.default_rng(seed)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    if kind == "mlstm":
        return (r(b, s, h, hd) * hd ** -0.5, r(b, s, h, hd), r(b, s, h, hd),
                r(b, s, h) * 2, r(b, s, h) * 2 + 3)
    return r(b, s, 4, h, hd), r(4, h, hd, hd) * hd ** -0.5, r(4, h, hd) * 0.5


@pytest.mark.parametrize("kind", sorted(POS))
def test_scan_ref_matches_lax_scan(kind):
    """The plain scans against `lax.scan` of JAX's step functions from a
    zero state."""
    ins = _scan_inputs(kind)
    b, s = ins[0].shape[:2]
    h, hd = ins[0].shape[-2:]
    if kind == "mlstm":
        carry = (jnp.zeros((b, h, hd, hd)), jnp.zeros((b, h, hd)),
                 jnp.zeros((b, h)))
        step = jax_ssm._mlstm_step
        xs = tuple(jnp.moveaxis(jnp.asarray(t), 1, 0) for t in ins)
        got = mlstm_scan_ref(*map(torch.from_numpy, ins))
    else:
        carry = tuple(jnp.zeros((b, h, hd)) for _ in range(4))
        step = jax_ssm._slstm_step(jnp.asarray(ins[1]), jnp.asarray(ins[2]))
        xs = jnp.moveaxis(jnp.asarray(ins[0]), 1, 0)
        got = slstm_scan_ref(*map(torch.from_numpy, ins))
    _, ys = jax.jit(lambda c, x: jax.lax.scan(step, c, x))(carry, xs)
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    _close(got, np.moveaxis(np.asarray(ys), 0, 1), 1e-5)


@pytest.mark.parametrize("kind", sorted(POS))
def test_ops_scan_on_cpu_is_the_plain_version(kind):
    """On CPU tensors the wrapper is the plain version, bit for bit, counts
    no launch, and autograd differentiates it."""
    ins = [torch.from_numpy(t) for t in _scan_inputs(kind, seed=1)]
    wrapper, ref = ((ops.mlstm_scan, mlstm_scan_ref) if kind == "mlstm"
                    else (ops.slstm_scan, slstm_scan_ref))
    launches = wrapper.launches
    assert torch.equal(wrapper(*ins), ref(*ins))
    ins[0].requires_grad_()
    wrapper(*ins).square().sum().backward()
    assert ins[0].grad is not None and bool(torch.isfinite(ins[0].grad).all())
    assert wrapper.launches == launches


def test_scan_wrappers_check_their_inputs(monkeypatch):
    """A head dim off the kernels' (a multiple of 16 up to 256), a dtype
    other than f32 or a shape mismatch raises on any device; on CUDA
    operands under autograd the wrappers return the output of their
    autograd Functions, whose backwards launch the backward kernels (the
    device check is stubbed here and the launchers are their plain
    versions; tests/test_torch_xlstm_backward.py holds the gradients)."""
    q, k, v, i, f = (torch.from_numpy(t) for t in _scan_inputs("mlstm"))
    pre, w_r, bias = (torch.from_numpy(t) for t in _scan_inputs("slstm"))
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.mlstm_scan(q[..., :8], k[..., :8], v[..., :8], i, f)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.slstm_scan(torch.zeros(2, 3, 4, 2, 24),
                       torch.zeros(4, 2, 24, 24), torch.zeros(4, 2, 24))
    with pytest.raises(TypeError, match="f32"):
        ops.mlstm_scan(q.bfloat16(), k, v, i, f)
    with pytest.raises(TypeError, match="f32"):
        ops.slstm_scan(pre, w_r.double(), bias)
    with pytest.raises(ValueError, match="i, f"):
        ops.mlstm_scan(q, k, v, i[:, :-1], f)
    with pytest.raises(ValueError, match="w_r"):
        ops.slstm_scan(pre, w_r[:, :1], bias)
    monkeypatch.setattr(xlstm_scan, "_on_cuda", lambda name, ts: True)
    monkeypatch.setattr(
        xlstm_scan, "_mlstm_fwd",
        lambda q, k, v, i, f, keep=False: (
            mlstm_scan_states_ref(q, k, v, i, f, xlstm_scan.MLSTM_CHUNK)
            if keep else mlstm_scan_ref(q, k, v, i, f)))
    monkeypatch.setattr(xlstm_scan, "_mlstm_bwd",
                        lambda *ops: mlstm_scan_bwd_ref(*ops[:7]))
    monkeypatch.setattr(
        xlstm_scan, "_slstm_fwd",
        lambda pre, w_r, bias, trails: (slstm_scan_trails_ref(pre, w_r, bias)
                                        if trails else
                                        slstm_scan_ref(pre, w_r, bias)))
    monkeypatch.setattr(xlstm_scan, "_slstm_bwd", slstm_scan_dpre_ref)
    y = ops.mlstm_scan(q.requires_grad_(), k, v, i, f)
    assert type(y.grad_fn).__name__ == "_MlstmScanBackward"
    y.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    y = ops.slstm_scan(pre, w_r.requires_grad_(), bias)
    assert type(y.grad_fn).__name__ == "_SlstmScanBackward"
    y.sum().backward()
    assert w_r.grad is not None and bool(torch.isfinite(w_r.grad).all())


def _run_engine(engine_cls, request_cls, model, params):
    eng = engine_cls(model, params, batch_slots=2, max_len=32, num_clients=2)
    reqs = [request_cls(prompt=p, max_new_tokens=5) for p in PROMPTS]
    for i, r in enumerate(reqs):
        eng.submit(r, i % 2)
    eng.run_until_drained()
    return eng, [r.output for r in reqs]


def test_engine_matches_greedy_decode_and_jax_engine():
    """Four requests through two slots, so a slot is reused after its
    request finishes and its mLSTM and sLSTM states must be zeroed on
    admission; decode takes the plain step, no scan."""
    jm, jp, tm, tp = _pair("float32")
    launches = (ops.mlstm_scan.launches, ops.slstm_scan.launches)
    eng, got = _run_engine(ServeEngine, Request, tm, tp)
    assert eng.stats["nonfinite_steps"] == 0 and eng.stats["admitted"] == 4
    for p, out in zip(PROMPTS, got):
        want = greedy_decode(tm, tp, torch.tensor([p]), 5, 32)
        assert out == want[0].tolist(), (p, out)
    _, want = _run_engine(JServeEngine, JRequest, jm, jp)
    assert got == want
    assert (ops.mlstm_scan.launches, ops.slstm_scan.launches) == launches


def test_reset_slot_cache_zeroes_every_recurrent_state():
    """Admission zeroes one slot's lanes of every state entry (C, n, m;
    c, n, h, m), JAX's initial state, and leaves the other slot's."""
    _, _, tm, tp = _pair("float32")
    eng = ServeEngine(tm, tp, batch_slots=2, max_len=8, num_clients=1)
    for layer in eng.cache:
        for t in layer.values():
            t.fill_(1.0)
    eng._reset_slot_cache(1)
    kinds = {MLSTM: ("c", "n", "m"), SLSTM: ("c", "n", "h", "m")}
    for block, layer in zip(tp.layers, eng.cache):
        assert tuple(layer) == kinds[type(block.mixer)]
        for t in layer.values():
            assert bool((t[1] == 0).all()) and bool((t[0] == 1).all())


def test_serve_launcher_on_cpu():
    out = serve(ARCH, num_requests=4, clients=2, device="cpu")
    assert out["requests"] == 4 and out["tokens"] == 4 * 8
    assert out["stats"]["nonfinite_steps"] == 0


def test_train_loss_decreases_and_resume_exact(tmp_path):
    """Tiny xlstm through `train()` on the CPU (autograd of the plain
    scans): the loss falls, and a resume from the step-24 checkpoint to
    step 30 equals a straight run to step 30."""
    run = dict(tiny=True, batch=4, seq=32, log_every=100, schedule_steps=30,
               device="cpu")
    d1 = str(tmp_path / "a")
    out = train(ARCH, steps=24, ckpt_dir=d1, **run)
    assert out["final_loss"] < out["losses"][0]
    out2 = train(ARCH, steps=30, ckpt_dir=d1, **run)
    assert len(out2["losses"]) == 6
    out3 = train(ARCH, steps=30, ckpt_dir=str(tmp_path / "b"), **run)
    assert out2["losses"][-1] == pytest.approx(out3["losses"][-1], rel=1e-4)
