"""The port's flash attention on the CPU (its plain versions) against the
JAX package: the forward against `flash_attention(..., interpret=True)`
with 64-wide blocks, lse against a numpy logsumexp, and the backward
(`flash_attention_bwd_ref`, and autograd through the port) against
`jax.grad` of JAX's `attention_ref`. The CUDA kernels run only on the
card, where chip_smoke.py holds them against these plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash_attention  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_fwd, shape_key)

# tests/test_kernels.py:25-32
ATTN_SHAPES = [
    # (B, S, T, nq, nkv, hd)
    (1, 128, 128, 4, 4, 64),
    (2, 128, 128, 8, 2, 64),       # GQA 4:1
    (1, 256, 256, 4, 1, 128),      # MQA
    (2, 64, 64, 14, 2, 64),        # qwen2-0.5b head layout
    (1, 96, 96, 4, 4, 64),         # non-multiple of block
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# (B, S, nq, nkv, hd, causal, window, softcap), S == T
GRAD_CASES = {
    "gqa 14:2 causal": (2, 64, 14, 2, 64, True, None, None),
    "window+softcap": (1, 256, 4, 2, 64, True, 64, 50.0),
    "mqa hd128": (1, 96, 4, 1, 128, True, None, None),
    "full": (2, 96, 4, 2, 16, False, None, None),
}


def _inputs(shape, jdt, tdt, seed=0):
    """q, k, v from numpy as JAX arrays and torch tensors of one dtype
    with the same values."""
    b, s, t, nq, nkv, hd = shape
    rng = np.random.RandomState(seed)
    out = []
    for dims in ((b, s, nq, hd), (b, t, nkv, hd), (b, t, nkv, hd)):
        j = jnp.asarray(rng.randn(*dims), jnp.float32).astype(jdt)
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                    .to(tdt)))
    return [p[0] for p in out], [p[1] for p in out]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(shape, dtype, causal):
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (q, k, v) = _inputs(shape, jdt, tdt)
    want = jax_flash_attention(jq, jk, jv, causal=causal, blk_q=64,
                               blk_k=64, interpret=True)
    got = flash_attention(q, k, v, causal=causal)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    assert got.dtype == tdt and got.shape == q.shape
    assert torch.equal(o, got)
    assert lse.dtype == torch.float32 and lse.shape == (q.shape[0],
                                                        q.shape[2],
                                                        q.shape[1])
    _close(got, want, tol)
    # the models' entry point: on the CPU the plain op, attention_ref
    _close(ops.attention(q, k, v, causal=causal), want, tol)


def test_flash_attention_window_and_softcap_matches_jax():
    shape = (1, 256, 256, 4, 2, 64)
    (jq, jk, jv), (q, k, v) = _inputs(shape, jnp.float32, torch.float32)
    kw = dict(causal=True, window=64, softcap=50.0)
    want = jax_flash_attention(jq, jk, jv, blk_q=64, blk_k=64,
                               interpret=True, **kw)
    _close(flash_attention(q, k, v, **kw), want, 2e-5)
    _close(ops.attention(q, k, v, **kw), want, 2e-5)


def test_flash_attention_cross_lengths_match_jax():
    """No mask and S != T (the kernel takes it; `ops` never sends it)."""
    shape = (1, 96, 160, 4, 2, 64)
    (jq, jk, jv), (q, k, v) = _inputs(shape, jnp.float32, torch.float32)
    want = jax_flash_attention(jq, jk, jv, blk_q=64, blk_k=64,
                               interpret=True)
    _close(flash_attention(q, k, v), want, 2e-5)


def _np_lse(q, k, causal, window, softcap):
    """[B,nq,S] log-sum-exp of the masked scores, in float64."""
    q, k = q.astype(np.float64), k.astype(np.float64)
    b, s, nq, hd = q.shape
    g = nq // k.shape[2]
    kk = np.repeat(k, g, axis=2)                          # [B,T,nq,hd]
    x = np.einsum("bshd,bthd->bhst", q, kk) * hd ** -0.5
    if softcap is not None:
        x = np.tanh(x / softcap) * softcap
    qpos = np.arange(s)[:, None]
    kpos = np.arange(k.shape[1])[None, :]
    mask = np.ones((s, k.shape[1]), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    x = np.where(mask, x, -np.inf)
    mx = x.max(-1, keepdims=True)
    return (mx + np.log(np.exp(x - mx).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_lse_matches_numpy_logsumexp(case):
    b, s, nq, nkv, hd, causal, window, softcap = GRAD_CASES[case]
    _, (q, k, v) = _inputs((b, s, s, nq, nkv, hd), jnp.float32,
                           torch.float32, seed=1)
    _, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    np.testing.assert_allclose(lse.numpy(),
                               _np_lse(q.numpy(), k.numpy(), causal, window,
                                       softcap), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_backward_matches_jax_grad(case):
    """dq, dk, dv from the plain backward and from autograd through the
    port's differentiable entry point, against jax.grad of JAX's
    attention_ref, f32 within 1e-4."""
    b, s, nq, nkv, hd, causal, window, softcap = GRAD_CASES[case]
    kw = dict(causal=causal, window=window, softcap=softcap)
    (jq, jk, jv), (q, k, v) = _inputs((b, s, s, nq, nkv, hd), jnp.float32,
                                      torch.float32, seed=2)
    do_np = np.random.RandomState(3).randn(b, s, nq, hd).astype(np.float32)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.attention_ref(q_, k_, v_, **kw),
                     jq, jk, jv)
    want = vjp(jnp.asarray(do_np))
    do = torch.from_numpy(do_np)

    o, lse = flash_attention_fwd(q, k, v, **kw)
    plain = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, r) for a, r in zip(
        plain, ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(flash_attention(*leaves, **kw), leaves, do)
    for got in (plain, auto):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w, 1e-4)


def test_cpu_calls_count_no_launches():
    _, (q, k, v) = _inputs((1, 32, 32, 4, 2, 16), jnp.float32,
                           torch.float32)
    before = (flash_attention.launches, flash_attention_bwd.launches,
              dict(flash_attention.by_shape),
              dict(flash_attention_bwd.by_shape))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, causal=True).sum().backward()
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    flash_attention_bwd(q, k, v, o, lse, torch.ones_like(o), causal=True)
    assert (flash_attention.launches, flash_attention_bwd.launches,
            dict(flash_attention.by_shape),
            dict(flash_attention_bwd.by_shape)) == before


def test_shape_key_names_the_call():
    q, k = torch.empty((2, 448, 8, 64)), torch.empty((2, 1500, 8, 64))
    assert shape_key(q, k, 1, 4096, 50.0) == ((2, 448, 8, 64), 1500, True,
                                              4096, 50.0)
    assert shape_key(q, q, False, None, None) != shape_key(q, q, True, None,
                                                           None)


def _t(*shape, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype)


@pytest.mark.parametrize("args,kw,err", [
    ((_t(1, 8, 4, 16), _t(1, 12, 2, 16), _t(1, 12, 2, 16)),
     dict(causal=True), ValueError),                     # causal, S != T
    ((_t(1, 8, 4, 16), _t(1, 12, 2, 16), _t(1, 12, 2, 16)),
     dict(window=4), ValueError),                        # window, S != T
    ((_t(1, 8, 4, 16), _t(1, 8, 3, 16), _t(1, 8, 3, 16)), {},
     ValueError),                                        # nq % nkv
    ((_t(1, 8, 4, 16), _t(1, 8, 2, 8), _t(1, 8, 2, 8)), {},
     ValueError),                                        # head dims differ
    ((_t(8, 4, 16), _t(1, 8, 2, 16), _t(1, 8, 2, 16)), {},
     ValueError),                                        # rank
    ((_t(1, 8, 4, 16), _t(1, 8, 2, 16), _t(1, 8, 2, 16)),
     dict(window=0), ValueError),
    ((_t(1, 8, 4, 16), _t(1, 8, 2, 16), _t(1, 8, 2, 16)),
     dict(softcap=0.0), ValueError),
    ((_t(1, 8, 4, 16), _t(1, 8, 2, 16, dtype=torch.bfloat16),
      _t(1, 8, 2, 16)), {}, TypeError),                  # mixed dtypes
    ((_t(1, 8, 4, 16, dtype=torch.float16),
      _t(1, 8, 2, 16, dtype=torch.float16),
      _t(1, 8, 2, 16, dtype=torch.float16)), {}, TypeError),   # fp16
])
def test_flash_attention_rejects(args, kw, err):
    with pytest.raises(err):
        flash_attention(*args, **kw)
    with pytest.raises(err):
        flash_attention_fwd(*args, **kw)


def test_backward_rejects_mismatched_lse():
    q, k, v = _t(1, 8, 4, 16), _t(1, 8, 2, 16), _t(1, 8, 2, 16)
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, lse.double(), o, causal=True)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, lse[:, :2], o, causal=True)
