"""The xLSTM scans' backward: the plain reverse walks against autograd and
against the JAX package, the mixers' gradients against `jax.grad`, and
the autograd Functions' wiring.

- `mlstm_scan_bwd_ref` and `slstm_scan_bwd_ref` (the plain versions of the
  backward kernels, split into the kernels' passes) against torch
  autograd of `mlstm_scan_ref` and `slstm_scan_ref`, in f64 and f32, on
  inputs that reach both sides of each clamp and both arms of each max;
- the same against `jax.vjp` of `chunked_scan` over JAX's `_mlstm_step`
  and `_slstm_step`, at S = 33 and at S = 256 (JAX's remat branch);
- `MLSTM` and `SLSTM` input and parameter gradients against `jax.grad`
  of `mlstm_train` and `slstm_train` on bridged f32 weights at S = 256;
- the autograd Functions on the CPU, with the device check stubbed and
  the kernel launchers replaced by their plain versions (the mLSTM's
keeping forward by `mlstm_scan_states_ref`): the output's
  grad_fn is the Function's node, its gradients are autograd's of the
  plain scan, and a bf16 mixer's gradients reach its bf16 projections
  through the casts before the scan.

Tolerances: max |got - want| <= tol * max |want| over each gradient, tol
1e-4 in f32 (sums in other orders on each side; the gradients reach
~50), 1e-10 in f64.
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
import torch.nn.functional as F  # noqa: E402

from repro.configs import tiny_config as jax_tiny_config  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import tiny_config  # noqa: E402
from repro_torch.convert import load_jax_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import xlstm_scan  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    mlstm_scan_bwd_ref, mlstm_scan_ref, mlstm_scan_states_ref,
    slstm_grad_weights,
    slstm_scan_bwd_ref, slstm_scan_dpre_ref, slstm_scan_ref,
    slstm_scan_trails_ref)
from repro_torch.models.registry import get_model  # noqa: E402

ARCH = "xlstm-125m"
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
KINDS = ("mlstm", "slstm")
POS = {"mlstm": 0, "slstm": 1}           # in xlstm's period (m, s, m, m)


def _inputs(kind, seed=0, b=2, s=33, h=2, hd=16):
    """Numpy f32 inputs of a scan and its output gradient from a seed:
    ((q scaled, k, v, i, f) or (pre, w_r, bias), dy). The gates' spread
    (i, f: 2 sigma, f biased open by 3) puts both arms of the m max in
    play, and q . n falls on both sides of 1."""
    rng = np.random.default_rng(seed)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    if kind == "mlstm":
        ins = (r(b, s, h, hd) * hd ** -0.5, r(b, s, h, hd), r(b, s, h, hd),
               r(b, s, h) * 2, r(b, s, h) * 2 + 3)
    else:
        ins = (r(b, s, 4, h, hd), r(4, h, hd, hd) * hd ** -0.5,
               r(4, h, hd) * 0.5)
    return ins, r(b, s, h, hd)


def _coverage(kind, ins) -> dict:
    """The share of steps on the upper side of each clamp and max of the
    forward: mLSTM |n . q| > 1 and log_sigmoid(f) + m > i; sLSTM n > 1
    and log_sigmoid(pre_f) + m > pre_i."""
    if kind == "mlstm":
        q, k, _, i, f = ins
        lf = F.logsigmoid(f)
        m = torch.zeros(i.shape[0], i.shape[2], dtype=q.dtype)
        n = torch.zeros_like(q[:, 0])
        clamp, arm = [], []
        for t in range(q.shape[1]):
            mf = lf[:, t] + m
            arm.append(mf > i[:, t])
            m = torch.maximum(mf, i[:, t])
            n = torch.exp(mf - m)[..., None] * n + \
                torch.exp(i[:, t] - m)[..., None] * k[:, t]
            clamp.append((n * q[:, t]).sum(-1).abs() > 1)
        clamp, arm = torch.stack(clamp), torch.stack(arm)
    else:
        _, p, _, n, m = slstm_scan_trails_ref(*ins)
        m_prev = torch.cat([torch.zeros_like(m[:, :1]), m[:, :-1]], 1)
        clamp = n > 1
        arm = F.logsigmoid(p[:, :, 1]) + m_prev > p[:, :, 0]
    return {"clamp": clamp.double().mean().item(),
            "arm": arm.double().mean().item()}


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor)
                      else want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err, scale)


def _scan_and_bwd(kind):
    return ((mlstm_scan_ref, mlstm_scan_bwd_ref) if kind == "mlstm"
            else (slstm_scan_ref, slstm_scan_bwd_ref))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind", KINDS)
def test_bwd_ref_matches_autograd(kind, dtype):
    """The plain reverse walk against autograd of the plain scan, on
    inputs that reach both sides of the clamp and both arms of the max."""
    ins, dy = _inputs(kind)
    ins = [torch.from_numpy(t).to(dtype) for t in ins]
    dy = torch.from_numpy(dy).to(dtype)
    cover = _coverage(kind, ins)
    assert 0 < cover["clamp"] < 1 and 0 < cover["arm"] < 1, cover
    scan, bwd = _scan_and_bwd(kind)
    leaves = [t.clone().requires_grad_() for t in ins]
    y = scan(*leaves)
    want = torch.autograd.grad(y, leaves, dy)
    got = (bwd(*ins, y.detach(), dy) if kind == "mlstm"
           else bwd(*ins, dy))
    assert len(got) == len(want)
    for idx, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype
        _close(g, w, TOL[dtype], f"{kind} grad {idx}")


@pytest.mark.parametrize("kind", KINDS)
def test_bwd_ref_ties_split_as_autograd(kind):
    """Ties: a max splits its gradient half to each side, the clamp gives
    it whole to its input (autograd's rules). mLSTM: i_0 set equal to
    log_sigmoid(f_0) (m_{-1} = 0); sLSTM: pre_i set to tie with
    log_sigmoid(pre_f) at the first step (bias_i = bias_f = 0) but in one
    row, which lies above it; n_1 is then exactly 1 everywhere."""
    ins, dy = _inputs(kind, seed=5, s=9)
    ins = [torch.from_numpy(t).double() for t in ins]
    if kind == "mlstm":
        ins[3][:, 0] = F.logsigmoid(ins[4][:, 0])
    else:
        ins[2][:2] = 0.0               # h_{-1} = 0: p = pre at the first step
        ins[0][:, 0, 0] = F.logsigmoid(ins[0][:, 0, 1])
        ins[0][:, 0, 0, 0, 0] += 0.5                 # one row on one side
        _, p, _, n, _ = slstm_scan_trails_ref(*ins)
        assert bool((F.logsigmoid(p[:, 0, 1]) == p[:, 0, 0]).any())
        assert bool((n[:, 0] == 1.0).all())
    dy = torch.from_numpy(dy).double()
    scan, bwd = _scan_and_bwd(kind)
    leaves = [t.clone().requires_grad_() for t in ins]
    y = scan(*leaves)
    want = torch.autograd.grad(y, leaves, dy)
    got = (bwd(*ins, y.detach(), dy) if kind == "mlstm"
           else bwd(*ins, dy))
    for idx, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TOL[torch.float64], f"{kind} tie grad {idx}")


def _jax_vjp(kind, ins, dy):
    """Input gradients of JAX's scan (`chunked_scan` over the step
    function, chunk 128, from a zero state) for dy, as numpy."""
    b, s = dy.shape[:2]
    h, hd = dy.shape[2:]
    if kind == "mlstm":
        def fn(q, k, v, i, f):
            carry = (jnp.zeros((b, h, hd, hd)), jnp.zeros((b, h, hd)),
                     jnp.zeros((b, h)))
            xs = tuple(jnp.moveaxis(t, 1, 0) for t in (q, k, v, i, f))
            _, ys = jax_ssm.chunked_scan(jax_ssm._mlstm_step, carry, xs)
            return jnp.moveaxis(ys, 0, 1)
    else:
        def fn(pre, w_r, bias):
            carry = tuple(jnp.zeros((b, h, hd)) for _ in range(4))
            _, ys = jax_ssm.chunked_scan(jax_ssm._slstm_step(w_r, bias),
                                         carry, jnp.moveaxis(pre, 1, 0))
            return jnp.moveaxis(ys, 0, 1)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, ins))
    return [np.asarray(g) for g in jax.jit(vjp)(jnp.asarray(dy))]


@pytest.mark.parametrize("s", [33, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_bwd_ref_matches_jax_vjp(kind, s):
    """S = 256 is two 128-step chunks: JAX's remat branch of
    `chunked_scan`, which changes no gradient."""
    ins, dy = _inputs(kind, seed=2, s=s)
    want = _jax_vjp(kind, ins, dy)
    t_ins = [torch.from_numpy(t) for t in ins]
    t_dy = torch.from_numpy(dy)
    if kind == "mlstm":
        got = mlstm_scan_bwd_ref(*t_ins, mlstm_scan_ref(*t_ins), t_dy)
    else:
        got = slstm_scan_bwd_ref(*t_ins, t_dy)
    assert len(got) == len(want)
    for idx, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TOL[torch.float32], f"{kind} S={s} grad {idx}")


@functools.lru_cache(maxsize=None)
def _pair():
    """(jax cfg, jax params, port model, port params) of tiny f32 xlstm on
    shared weights."""
    jm = jax_get_model(jax_tiny_config(ARCH).scaled(dtype="float32"))
    jp = jax.jit(jm.init_params)(jax.random.key(0))
    tm = get_model(tiny_config(ARCH).scaled(dtype="float32"), "cpu")
    tp = tm.init_params(torch.Generator().manual_seed(1))
    load_jax_params(tp, jax.tree.map(np.asarray, jp))
    return jm.cfg, jp, tm, tp


@pytest.mark.parametrize("kind", KINDS)
def test_mixer_gradients_match_jax_grad(kind):
    """d sum(mixer(x) * r) / d (x, every parameter) at S = 256 (JAX's
    remat branch), the port's mixer of layer POS[kind] against
    `jax.grad` of `mlstm_train` / `slstm_train` on the same weights."""
    cfg, jp, _, tp = _pair()
    pos = POS[kind]
    p = jax.tree.map(lambda a: a[0], jp["layers"][pos]["mixer"])
    mixer = tp.layers[pos].mixer
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 256, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 256, cfg.d_model)).astype(np.float32)
    fn = jax_ssm.mlstm_train if kind == "mlstm" else jax_ssm.slstm_train
    loss = lambda p_, x_: jnp.sum(fn(cfg, p_, x_) * r)  # noqa: E731
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    for prm in mixer.parameters():
        prm.grad = None
    (mixer(xt) * torch.from_numpy(r)).sum().backward()
    _close(xt.grad, gx, TOL[torch.float32], "x")
    names = dict(mixer.named_parameters())
    assert sorted(names) == sorted(gp)
    for name, prm in names.items():
        _close(prm.grad, gp[name], TOL[torch.float32], name)
        prm.grad = None


@pytest.fixture
def stubbed_kernels(monkeypatch):
    """The CUDA path of the scan wrappers on CPU tensors: the device check
    says CUDA and each kernel launcher is its plain version."""
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


@pytest.mark.parametrize("kind", KINDS)
def test_function_path_gradients(kind, stubbed_kernels):
    """Under grad the wrapper returns the Function's output (its grad_fn
    the Function's node), whose gradients equal autograd's of the plain
    scan; without grad, the launcher's output itself."""
    ins, dy = _inputs(kind, seed=3)
    ins = [torch.from_numpy(t) for t in ins]
    dy = torch.from_numpy(dy)
    wrapper = ops.mlstm_scan if kind == "mlstm" else ops.slstm_scan
    node = "_MlstmScanBackward" if kind == "mlstm" else "_SlstmScanBackward"
    leaves = [t.clone().requires_grad_() for t in ins]
    y = wrapper(*leaves)
    assert type(y.grad_fn).__name__ == node
    got = torch.autograd.grad(y, leaves, dy)
    plain = [t.clone().requires_grad_() for t in ins]
    ref = mlstm_scan_ref if kind == "mlstm" else slstm_scan_ref
    want = torch.autograd.grad(ref(*plain), plain, dy)
    for idx, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TOL[torch.float32], f"{kind} grad {idx}")
    with torch.no_grad():
        assert torch.equal(wrapper(*ins), ref(*ins))


@pytest.mark.parametrize("kind", KINDS)
def test_function_path_reaches_bf16_projections(kind, stubbed_kernels):
    """A bf16 mixer on the Function path: the scan takes f32 casts of the
    bf16 products, and every parameter, the bf16 projections included,
    gets a finite gradient of its own dtype."""
    mixer = get_model(tiny_config(ARCH), "cpu").init_params(
        torch.Generator().manual_seed(2)).layers[POS[kind]].mixer
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 20, mixer.out_proj.shape[1])).astype(np.float32)).bfloat16()
    y = mixer(x)
    assert y.dtype == torch.bfloat16
    y.float().square().sum().backward()
    dtypes = set()
    for name, prm in mixer.named_parameters():
        assert prm.grad is not None and prm.grad.dtype == prm.dtype, name
        assert bool(torch.isfinite(prm.grad).all()), name
        assert bool(prm.grad.abs().max() > 0), name
        dtypes.add(prm.dtype)
    assert dtypes == {torch.bfloat16, torch.float32}


def test_bwd_wrappers_on_cpu_are_the_plain_versions():
    """On CPU tensors the backward wrappers are the plain versions, bit for
    bit, and count no launch; the sLSTM's, given the forward's trails,
    equals the plain backward that recomputes them."""
    counts = (xlstm_scan.mlstm_scan_bwd.launches,
              xlstm_scan.slstm_scan_bwd.launches)
    ins, dy = _inputs("mlstm", seed=4)
    ins, dy = [torch.from_numpy(t) for t in ins], torch.from_numpy(dy)
    y = mlstm_scan_ref(*ins)
    for g, w in zip(xlstm_scan.mlstm_scan_bwd(*ins, y, dy),
                    mlstm_scan_bwd_ref(*ins, y, dy)):
        assert torch.equal(g, w)
    ins, dy = _inputs("slstm", seed=4)
    ins, dy = [torch.from_numpy(t) for t in ins], torch.from_numpy(dy)
    trails = slstm_scan_trails_ref(*ins)
    want = slstm_scan_bwd_ref(*ins, dy)
    got = xlstm_scan.slstm_scan_bwd(ins[1], dy, trails)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(torch.equal(g, w) for g, w in
               zip(slstm_grad_weights(want[0], trails[0]), want[1:]))
    assert (xlstm_scan.mlstm_scan_bwd.launches,
            xlstm_scan.slstm_scan_bwd.launches) == counts


def test_trails_ref_is_the_forward():
    """The trail-keeping plain forward: its h trail is `slstm_scan_ref`'s
    bit for bit, and its trails are each step's pre-activations and state:
    h = sigmoid(o) c / max(n, 1) at every step."""
    ins, _ = _inputs("slstm", seed=6)
    ins = [torch.from_numpy(t) for t in ins]
    h, p, c, n, m = slstm_scan_trails_ref(*ins)
    assert torch.equal(h, slstm_scan_ref(*ins))
    assert p.shape == ins[0].shape
    assert all(t.shape == h.shape for t in (c, n, m))
    torch.testing.assert_close(
        h, torch.sigmoid(p[:, :, 3]) * c / torch.clamp(n, min=1.0),
        rtol=0, atol=1e-6)


def test_bwd_wrappers_check_their_inputs(stubbed_kernels):
    """A dy or y of another shape, or an operand not f32, raises (on the
    CUDA path here, whose device check is stubbed)."""
    ins, dy = _inputs("mlstm")
    q, k, v, i, f = (torch.from_numpy(t) for t in ins)
    dy = torch.from_numpy(dy)
    with pytest.raises(ValueError, match="y, dy"):
        xlstm_scan.mlstm_scan_bwd(q, k, v, i, f, q, dy[:, :-1])
    with pytest.raises(TypeError, match="f32"):
        xlstm_scan.mlstm_scan_bwd(q, k, v, i, f, q, dy.double())
    ins, dy = _inputs("slstm")
    ins, dy = [torch.from_numpy(t) for t in ins], torch.from_numpy(dy)
    trails = slstm_scan_trails_ref(*ins)
    with pytest.raises(ValueError, match="dy"):
        xlstm_scan.slstm_scan_bwd(ins[1], dy[:, :-1], trails)
    with pytest.raises(TypeError, match="f32"):
        xlstm_scan.slstm_scan_bwd(ins[1].double(), dy, trails)
