"""The xLSTM backward kernels' plain mirrors and the wiring of their
autograd Functions, on the CPU.

- `mlstm_scan_bwd_chunkwise_ref` (the mLSTM backward in the chunkwise
  passes the kernels in csrc/xlstm_scan_bwd.cu take) against the step
  form `mlstm_scan_bwd_ref`, against torch autograd of `mlstm_scan_ref` in
  float64 and against `jax.vjp` of a `lax.scan` of JAX's `_mlstm_step`:
  S = 33 and 256 with chunks of 16 and 64 (S not a multiple of the
  chunk), gates at the extremes of `test_torch_xlstm_chunkwise.py` (chunk
  sums of log forget gates near -500), and an exact tie of the m chain,
  where the gate gradients split half to each arm as the step form's;
- `slstm_scan_dpre_affine_ref` (the sLSTM cell's backward as an affine
  map, the recurrent sum as the cluster's 8 block partials in rank order)
  against `slstm_scan_dpre_ref` and, with the weight products, against
  `jax.vjp` of JAX's scan;
- `mlstm_scan_states_ref`, the plain version of the forward kernels
  under autograd: y bit for bit the chunkwise forward's, and the states
  the chunk-start states;
- the Functions' wiring with the launchers stubbed: the chunk states the
  forward keeps reach the backward, each kernel's launch counter moves
  once a call, in the kernels' order, and a failed launch raises.

Tolerances: max |got - want| <= tol * max |want| over each gradient, tol
1e-4 in f32 (the same terms summed in other orders: the chunkwise form
against the step form, the affine map against the cell's backward; the
gradients reach ~50), 1e-10 in float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels import xlstm_scan  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    mlstm_chunk_states_ref, mlstm_scan_bwd_chunkwise_ref, mlstm_scan_bwd_ref,
    mlstm_scan_chunkwise_ref, mlstm_scan_ref, mlstm_scan_states_ref,
    slstm_grad_weights, slstm_scan_dpre_affine_ref, slstm_scan_dpre_ref,
    slstm_scan_trails_ref)

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
CHUNKS = (16, 64)


def _mlstm_inputs(b=2, s=33, h=2, hd=16, seed=0, f_bias=3.0, f_scale=2.0,
                  i_scale=2.0, i_bias=0.0):
    """Numpy f32 (q scaled, k, v, i, f) and dy from a seed; the gates'
    spread puts both arms of the m max in play and n . q on both sides of
    1 (forget gates biased open by `f_bias`)."""
    rng = np.random.default_rng(seed)
    r = lambda *sh: rng.standard_normal(sh)  # noqa: E731
    ins = (r(b, s, h, hd) * hd ** -0.5, r(b, s, h, hd), r(b, s, h, hd),
           r(b, s, h) * i_scale + i_bias, r(b, s, h) * f_scale + f_bias)
    return ([t.astype(np.float32) for t in ins],
            r(b, s, h, hd).astype(np.float32))


def _slstm_inputs(b=2, s=33, h=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    return (r(b, s, 4, h, hd), r(4, h, hd, hd) * hd ** -0.5,
            r(4, h, hd) * 0.5), r(b, s, h, hd)


def _torch(ins, dy, dtype=torch.float32):
    return ([torch.from_numpy(t).to(dtype) for t in ins],
            torch.from_numpy(dy).to(dtype))


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor)
                      else want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("s", [33, 256])
def test_mlstm_mirror_matches_step_form(s, chunk):
    ins, dy = _torch(*_mlstm_inputs(s=s, seed=s + chunk))
    y = mlstm_scan_ref(*ins)
    got = mlstm_scan_bwd_chunkwise_ref(*ins, y, dy, chunk)
    want = mlstm_scan_bwd_ref(*ins, y, dy)
    for idx, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        _close(g, w, TOL[torch.float32], f"S={s} chunk {chunk} grad {idx}")


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("s", [33, 256])
def test_mlstm_mirror_matches_autograd_f64(s, chunk):
    ins, dy = _torch(*_mlstm_inputs(s=s, seed=2 * s + chunk),
                     torch.float64)
    leaves = [t.clone().requires_grad_() for t in ins]
    y = mlstm_scan_ref(*leaves)
    want = torch.autograd.grad(y, leaves, dy)
    got = mlstm_scan_bwd_chunkwise_ref(*ins, y.detach(), dy, chunk)
    for idx, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float64
        _close(g, w, TOL[torch.float64], f"S={s} chunk {chunk} grad {idx}")


def _jax_mlstm_vjp(ins, dy):
    """Input gradients of a `lax.scan` of JAX's `_mlstm_step` from a zero
    state, for dy, as numpy."""
    b, s, h, hd = dy.shape

    def fn(q, k, v, i, f):
        carry = (jnp.zeros((b, h, hd, hd)), jnp.zeros((b, h, hd)),
                 jnp.zeros((b, h)))
        xs = tuple(jnp.moveaxis(t, 1, 0) for t in (q, k, v, i, f))
        _, ys = jax.lax.scan(jax_ssm._mlstm_step, carry, xs)
        return jnp.moveaxis(ys, 0, 1)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, ins))
    return [np.asarray(g) for g in jax.jit(vjp)(jnp.asarray(dy))]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("s", [33, 256])
def test_mlstm_mirror_matches_jax_vjp(s, chunk):
    ins, dy = _mlstm_inputs(s=s, seed=3 * s + chunk)
    want = _jax_mlstm_vjp(ins, dy)
    t_ins, t_dy = _torch(ins, dy)
    got = mlstm_scan_bwd_chunkwise_ref(*t_ins, mlstm_scan_ref(*t_ins), t_dy,
                                       chunk)
    for idx, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TOL[torch.float32], f"S={s} chunk {chunk} grad {idx}")


# forget gates nearly shut (a chunk's log gates summing to about -500),
# input gates large, far below 0, and mixed (test_torch_xlstm_chunkwise.py)
GATES = {"f shut": dict(f_bias=-8.0, f_scale=1.0),
         "i large": dict(i_scale=5.0, i_bias=8.0, f_scale=1.0),
         "i very negative": dict(i_scale=5.0, i_bias=-30.0, f_scale=1.0),
         "mixed": dict(f_bias=-2.0, i_scale=10.0, f_scale=1.0)}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("gates", sorted(GATES))
def test_mlstm_mirror_at_extreme_gates(gates, chunk):
    ins, dy = _torch(*_mlstm_inputs(s=150, seed=7, **GATES[gates]))
    y = mlstm_scan_ref(*ins)
    got = mlstm_scan_bwd_chunkwise_ref(*ins, y, dy, chunk)
    want = mlstm_scan_bwd_ref(*ins, y, dy)
    for idx, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TOL[torch.float32], f"{gates} chunk {chunk} grad {idx}")


@pytest.mark.parametrize("chunk", CHUNKS)
def test_mlstm_mirror_splits_a_tie_as_the_step_form(chunk):
    """i_0 = log_sigmoid(f_0) (m_{-1} = 0): the max ties at the first step,
    and its gradient goes half to each arm, in the mirror as in the step
    form and autograd (float64, where the tie is exact in all three)."""
    ins, dy = _torch(*_mlstm_inputs(s=40, seed=5), torch.float64)
    ins[3][:, 0] = F.logsigmoid(ins[4][:, 0])
    assert bool((F.logsigmoid(ins[4][:, 0]) + 0.0 == ins[3][:, 0]).all())
    leaves = [t.clone().requires_grad_() for t in ins]
    y = mlstm_scan_ref(*leaves)
    auto = torch.autograd.grad(y, leaves, dy)
    y = y.detach()
    got = mlstm_scan_bwd_chunkwise_ref(*ins, y, dy, chunk)
    step = mlstm_scan_bwd_ref(*ins, y, dy)
    for idx, (g, st, au) in enumerate(zip(got, step, auto)):
        _close(g, st, TOL[torch.float64], f"tie grad {idx} vs step")
        _close(g, au, TOL[torch.float64], f"tie grad {idx} vs autograd")


@pytest.mark.parametrize("chunk", CHUNKS)
def test_states_ref_is_the_chunkwise_forward(chunk):
    """`mlstm_scan_states_ref`: y bit for bit `mlstm_scan_chunkwise_ref`'s;
    C^T, n, m the chunk-start states in the kernels' layouts; y = num /
    max(|den'|, 1), so |y| max(|den'|, 1) recovers the numerator."""
    ins, _ = _torch(*_mlstm_inputs(s=70, seed=9))
    y, (c_st, n_st, m_st, den) = mlstm_scan_states_ref(*ins, chunk)
    assert torch.equal(y, mlstm_scan_chunkwise_ref(*ins, chunk))
    cst, nst, mst = mlstm_chunk_states_ref(*ins[1:], chunk)
    b, s, h, hd = ins[0].shape
    nch = -(-s // chunk)
    assert c_st.shape == (b * h, nch, hd, hd) and den.shape == (b, s, h)
    assert torch.equal(c_st, cst.transpose(-1, -2).reshape(-1, nch, hd, hd))
    assert torch.equal(n_st, nst.reshape(-1, nch, hd))
    assert torch.equal(m_st, mst.reshape(-1, nch))
    assert bool((den.abs() > 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("s", [33, 256])
def test_slstm_affine_mirror_matches_dpre_ref(s, dtype):
    ins, dy = _torch(*_slstm_inputs(s=s, seed=s), dtype)
    trails = slstm_scan_trails_ref(*ins)
    got = slstm_scan_dpre_affine_ref(ins[1], dy, trails[1:])
    want = slstm_scan_dpre_ref(ins[1], dy, trails[1:])
    assert got.dtype == dtype
    _close(got, want, TOL[dtype], f"S={s} dpre")


def _jax_slstm_vjp(ins, dy):
    b, s, h, hd = dy.shape

    def fn(pre, w_r, bias):
        carry = tuple(jnp.zeros((b, h, hd)) for _ in range(4))
        _, ys = jax.lax.scan(jax_ssm._slstm_step(w_r, bias), carry,
                             jnp.moveaxis(pre, 1, 0))
        return jnp.moveaxis(ys, 0, 1)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, ins))
    return [np.asarray(g) for g in jax.jit(vjp)(jnp.asarray(dy))]


@pytest.mark.parametrize("s", [33, 256])
def test_slstm_affine_mirror_matches_jax_vjp(s):
    ins, dy = _slstm_inputs(s=s, seed=2 * s)
    want = _jax_slstm_vjp(ins, dy)
    t_ins, t_dy = _torch(ins, dy)
    trails = slstm_scan_trails_ref(*t_ins)
    dpre = slstm_scan_dpre_affine_ref(t_ins[1], t_dy, trails[1:])
    got = (dpre, *slstm_grad_weights(dpre, trails[0]))
    for idx, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TOL[torch.float32], f"S={s} grad {idx}")


# ---- the Functions' wiring, the launchers stubbed

class _FakeLib:
    """A kernel library's C entry points that record their calls and
    return `err`."""

    def __init__(self, err=0, chunk=xlstm_scan.MLSTM_CHUNK):
        self.calls, self.err, self.chunk = [], err, chunk

    def __getattr__(self, name):
        if name.endswith("error_string"):
            return lambda code: b"stubbed failure"
        if name == "xlstm_scan_layout":
            return lambda which: self.chunk

        def entry(args, stream):
            self.calls.append((name, args._obj))
            return self.err
        return entry


@pytest.fixture
def on_cuda(monkeypatch):
    """The wrappers' device check says CUDA (on CPU tensors)."""
    monkeypatch.setattr(xlstm_scan, "_on_cuda", lambda name, ts: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))


def test_function_keeps_the_states_for_the_backward(on_cuda, monkeypatch):
    """Under grad the forward keeps its chunk states and den', and the
    backward receives those very tensors; its gradients are autograd's of
    the plain scan."""
    kept = {}

    def fwd(q, k, v, i, f, keep=False):
        assert keep
        y, states = mlstm_scan_states_ref(q, k, v, i, f,
                                          xlstm_scan.MLSTM_CHUNK)
        kept["states"] = states
        return y, states

    def bwd(q, k, v, i, f, y, dy, states):
        assert all(a.data_ptr() == b.data_ptr() and a.shape == b.shape
                   for a, b in zip(states, kept["states"]))
        kept["reached"] = True
        return mlstm_scan_bwd_chunkwise_ref(q, k, v, i, f, y, dy,
                                            xlstm_scan.MLSTM_CHUNK)
    monkeypatch.setattr(xlstm_scan, "_mlstm_fwd", fwd)
    monkeypatch.setattr(xlstm_scan, "_mlstm_bwd", bwd)
    ins, dy = _torch(*_mlstm_inputs(s=70, seed=11))
    leaves = [t.clone().requires_grad_() for t in ins]
    y = xlstm_scan.mlstm_scan(*leaves)
    assert type(y.grad_fn).__name__ == "_MlstmScanBackward"
    got = torch.autograd.grad(y, leaves, dy)
    assert kept.get("reached")
    plain = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(mlstm_scan_ref(*plain), plain, dy)
    for idx, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TOL[torch.float32], f"grad {idx}")


def test_launch_counters_move_once_a_kernel(on_cuda, monkeypatch):
    """The keeping forward passes den' to the kernels (null without
    keep); the mLSTM backward launches its four kernels once each, in
    order, on one argument block, and the sLSTM's its one; every counter
    moves by one a call."""
    fwd_lib, bwd_lib = _FakeLib(), _FakeLib()
    monkeypatch.setattr(xlstm_scan, "_lib", lambda: fwd_lib)
    monkeypatch.setattr(xlstm_scan, "_bwd_lib", lambda: bwd_lib)
    ins, dy = _torch(*_mlstm_inputs(s=70, seed=13))
    y, states = xlstm_scan._mlstm_fwd(*ins, keep=True)
    b, s, h, hd = ins[0].shape
    nch = -(-s // xlstm_scan.MLSTM_CHUNK)
    assert [tuple(t.shape) for t in states] == [
        (b * h, nch, hd, hd), (b * h, nch, hd), (b * h, nch), (b, s, h)]
    assert fwd_lib.calls[-1][1].den == states[3].data_ptr()
    xlstm_scan._mlstm_fwd(*ins)
    assert fwd_lib.calls[-1][1].den is None
    before = {c: getattr(xlstm_scan.mlstm_scan_bwd, c) for c in (
        "prep_launches", "state_launches", "launches", "gate_launches")}
    grads = xlstm_scan.mlstm_scan_bwd(*ins, y, dy, states)
    assert [tuple(g.shape) for g in grads] == [(b, s, h, hd)] * 3 + \
        [(b, s, h)] * 2
    assert [c[0] for c in bwd_lib.calls] == list(xlstm_scan.MLSTM_BWD_ENTRIES)
    assert len({id(c[1]) for c in bwd_lib.calls}) == 1
    assert bwd_lib.calls[0][1].c_st == states[0].data_ptr()
    assert bwd_lib.calls[0][1].den == states[3].data_ptr()
    for c, n in before.items():
        assert getattr(xlstm_scan.mlstm_scan_bwd, c) == n + 1, c
    sins, sdy = _torch(*_slstm_inputs(s=20, seed=1))
    trails = slstm_scan_trails_ref(*sins)
    n = xlstm_scan.slstm_scan_bwd.launches
    xlstm_scan.slstm_scan_bwd(sins[1], sdy, trails)
    assert xlstm_scan.slstm_scan_bwd.launches == n + 1
    assert bwd_lib.calls[-1][0] == "slstm_scan_bwd_f32"


def test_failed_launch_raises_and_missing_states_refused(on_cuda,
                                                         monkeypatch):
    """A kernel that fails to launch raises (no plain fallback) and
    counts nothing; the mLSTM backward on CUDA refuses a call without the
    forward's states or with states of another shape."""
    monkeypatch.setattr(xlstm_scan, "_bwd_lib", lambda: _FakeLib(err=1))
    ins, dy = _torch(*_mlstm_inputs(s=40, seed=17))
    y, states = mlstm_scan_states_ref(*ins, xlstm_scan.MLSTM_CHUNK)
    n = xlstm_scan.mlstm_scan_bwd.prep_launches
    with pytest.raises(RuntimeError, match="stubbed failure"):
        xlstm_scan.mlstm_scan_bwd(*ins, y, dy, states)
    assert xlstm_scan.mlstm_scan_bwd.prep_launches == n
    with pytest.raises(ValueError, match="states"):
        xlstm_scan.mlstm_scan_bwd(*ins, y, dy)
    with pytest.raises(ValueError, match="states"):
        xlstm_scan.mlstm_scan_bwd(*ins, y, dy, states[:3] + (y,))
    sins, sdy = _torch(*_slstm_inputs(s=20, seed=1))
    with pytest.raises(RuntimeError, match="stubbed failure"):
        xlstm_scan.slstm_scan_bwd(sins[1], sdy, slstm_scan_trails_ref(*sins))
