"""What the tensor-core kernels change, checked on the CPU against the JAX
package before any card runs them.

- `moe_gemm`'s bf16 kernel takes d and f in multiples of 8 (TMA's 16-byte
  row strides): `pad_for_tma` zero-pads the operands, and the padded
  product sliced back equals `moe_gemm_pallas(..., interpret=True)`.
- The bf16 flash forward rounds P to bf16 before P V; nothing else in its
  arithmetic changes. A numerical model of that forward, written here and
  not in the package, holds against JAX's `flash_attention(...,
  interpret=True)` at the tolerance `chip_smoke.py` applies to the kernel
  on the card, so the design's rounding fits the existing bound.
- The bf16 flash backward rounds P and dS to bf16 before the products
  they feed (dV, dK, dQ). A model of it, here too, holds against
  `jax.vjp` of JAX's `attention_ref` at the tolerance `chip_smoke.py`
  applies to the kernels' gradients against autograd on the card.
- `cp_async_ready` hands the bf16 kernels a copy of inputs that are not
  16-byte aligned, and the inputs themselves otherwise; the backward
  passes o and do through it too.
"""
import math

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
from repro.kernels.moe_gemm import moe_gemm_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import cp_async_ready  # noqa: E402
from repro_torch.kernels.moe_gemm import pad_for_tma  # noqa: E402
from repro_torch.kernels.ref import moe_gemm_ref  # noqa: E402
from test_torch_flash_attention import GRAD_CASES  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
KV_TILE = 64                     # keys a step of the kernel's online softmax
Q_TILE = 64                      # queries a tile of the backward
NEG_INF = -1e30                  # the kernels' masked score
TOL_O, TOL_LSE = 2e-2, 1e-5      # chip_smoke.py's bf16 o and lse bounds
TOL_GRAD = 5e-2                  # chip_smoke.py's bf16 grads vs autograd


def _both(a, jdt, tdt):
    """One numpy array as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(a, jnp.float32).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


# ------------------------------------------------------------- moe_gemm
@pytest.mark.parametrize("shape", [(3, 100, 93, 71), (2, 5, 8, 13)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_padded_moe_gemm_matches_jax(shape, dtype):
    e, c, d, f = shape
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(0)
    jx, x = _both(rng.randn(e, c, d) * 0.3, jdt, tdt)
    jw, w = _both(rng.randn(e, d, f) * 0.3, jdt, tdt)
    xp, wp = pad_for_tma(x, w)
    assert xp.shape[2] % 8 == 0 and wp.shape[2] % 8 == 0
    assert wp.shape[1] == xp.shape[2] and xp.shape[:2] == (e, c)
    assert xp.dtype == wp.dtype == tdt
    got = moe_gemm_ref(xp, wp)[..., :f]
    want = moe_gemm_pallas(jx, jw, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_pad_for_tma_adds_zeros_only():
    x = torch.randn(2, 5, 8 * 3 + 1)
    w = torch.randn(2, 8 * 3 + 1, 13)
    xp, wp = pad_for_tma(x, w)
    assert xp.shape == (2, 5, 32) and wp.shape == (2, 32, 16)
    assert torch.equal(xp[..., :25], x) and not xp[..., 25:].any()
    assert torch.equal(wp[:, :25, :13], w)
    assert not wp[:, 25:].any() and not wp[..., 13:].any()


def test_pad_for_tma_keeps_fitting_operands():
    x, w = torch.randn(2, 5, 16), torch.randn(2, 16, 24)
    xp, wp = pad_for_tma(x, w)
    assert xp is x and wp is w
    # a contiguous view at an address that is not 16-byte aligned is copied
    base = torch.randn(2 * 5 * 16 + 1, dtype=torch.bfloat16)
    xv = base[1:].view(2, 5, 16)
    assert xv.data_ptr() % 16
    xp, wp = pad_for_tma(xv, w.bfloat16())
    assert xp.data_ptr() % 16 == 0 and torch.equal(xp, xv)


# ------------------------------------------- flash forward on tensor cores
def tensor_core_forward(q, k, v, causal=False, window=None, softcap=None):
    """The bf16 tensor-core forward's arithmetic, in torch on the CPU: q, k,
    v in bf16; scores in f32 (exact bf16 products, f32 sums); an online
    softmax in base 2 over tiles of KV_TILE keys with masked p set to 0;
    the denominator summed from the f32 p; p rounded to bf16 for P V with
    f32 accumulation; the output rounded once. -> (o [B,S,nq,hd] bf16,
    lse [B,nq,S] f32)."""
    b, s, nq, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)                               # [B,nq,S,hd]
    kf = k.float().repeat_interleave(nq // nkv, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(nq // nkv, 2).transpose(1, 2)
    log2e = 1.0 / math.log(2.0)
    m = torch.full((b, nq, s), NEG_INF)
    l = torch.zeros((b, nq, s))
    acc = torch.zeros((b, nq, s, hd))
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, t, KV_TILE):
        kpos = torch.arange(k0, min(k0 + KV_TILE, t))[None, :]
        x = qf @ kf[:, :, k0:k0 + KV_TILE].transpose(-1, -2) * hd ** -0.5
        if softcap is not None:
            x = torch.tanh(x / softcap) * softcap
        valid = torch.ones((s, kpos.shape[1]), dtype=torch.bool)
        if causal:
            valid &= kpos <= qpos
        if window is not None:
            valid &= kpos > qpos - window
        x = torch.where(valid, x * log2e, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(valid, torch.exp2(x - m_new[..., None]),
                        torch.tensor(0.0))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + \
            p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + KV_TILE]
        m = m_new
    o = (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)
    return o.transpose(1, 2), (m + torch.log2(l)) * math.log(2.0)


def _np_lse(q, k, causal, window, softcap):
    """[B,nq,S] log-sum-exp of the masked scores, in float64."""
    q, k = q.astype(np.float64), k.astype(np.float64)
    s, nq, hd = q.shape[1:]
    kk = np.repeat(k, nq // k.shape[2], axis=2)
    x = np.einsum("bshd,bthd->bhst", q, kk) * hd ** -0.5
    if softcap is not None:
        x = np.tanh(x / softcap) * softcap
    qpos, kpos = np.arange(s)[:, None], np.arange(k.shape[1])[None, :]
    mask = np.ones((s, k.shape[1]), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    x = np.where(mask, x, -np.inf)
    mx = x.max(-1, keepdims=True)
    return (mx + np.log(np.exp(x - mx).sum(-1, keepdims=True)))[..., 0]


# (B, S, nq, nkv, hd, causal, window, softcap), S == T
FWD_CASES = {
    "causal": (2, 128, 4, 4, 64, True, None, None),
    "window+softcap": (1, 256, 4, 2, 64, True, 64, 50.0),
    "GQA 14:2": (2, 128, 14, 2, 64, True, None, None),
    "MQA hd128": (1, 256, 4, 1, 128, True, None, None),
    "ragged S=200": (1, 200, 4, 2, 64, True, None, None),
    "no mask hd16": (2, 96, 4, 2, 16, False, None, None),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_tensor_core_forward_model_fits_the_bound(case):
    b, s, nq, nkv, hd, causal, window, softcap = FWD_CASES[case]
    kw = dict(causal=causal, window=window, softcap=softcap)
    rng = np.random.RandomState(4)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.randn(*shape), jnp.bfloat16, torch.bfloat16)
        for shape in ((b, s, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd)))
    o, lse = tensor_core_forward(q, k, v, **kw)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    want = jax_flash_attention(jq, jk, jv, blk_q=64, blk_k=64,
                               interpret=True, **kw)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL_O, atol=TOL_O)
    np.testing.assert_allclose(lse.numpy(),
                               _np_lse(q.float().numpy(), k.float().numpy(),
                                       causal, window, softcap),
                               rtol=TOL_LSE, atol=TOL_LSE)


# ------------------------------------------ flash backward on tensor cores
def _valid(qpos, kpos, causal, window):
    valid = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool)
    if causal:
        valid &= kpos <= qpos
    if window is not None:
        valid &= kpos > qpos - window
    return valid


def tensor_core_backward(q, k, v, o, lse, do, causal=False, window=None,
                         softcap=None):
    """The bf16 tensor-core backward's arithmetic, in torch on the CPU: q,
    k, v, o, do in bf16; D = rowsum(do * o) in f32 from the bf16 values;
    over tiles of Q_TILE queries and KV_TILE keys, S and dP in f32 (exact
    bf16 products, f32 sums), P = 2^(x * log2e - lse * log2e) with masked
    P set to 0 and dS = P (dP - D) [* (1 - tanh^2) under softcap] in f32;
    P and dS rounded to bf16 before dV += P^T dO, dK += dS^T Q and
    dQ += dS K, which accumulate in f32; dq and dk scaled, and each
    gradient rounded once. -> (dq, dk, dv) in bf16."""
    b, s, nq, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale, log2e = hd ** -0.5, 1.0 / math.log(2.0)
    qf, dof = (x.float().transpose(1, 2) for x in (q, do))    # [B,nq,S,hd]
    kf, vf = (x.float().repeat_interleave(g, 2).transpose(1, 2)
              for x in (k, v))                                # [B,nq,T,hd]
    dsum = (do.float() * o.float()).sum(-1).transpose(1, 2)   # [B,nq,S]
    lse2 = lse * log2e
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), \
        torch.zeros_like(vf)
    for q0 in range(0, s, Q_TILE):
        qs = slice(q0, q0 + Q_TILE)
        qpos = torch.arange(q0, min(q0 + Q_TILE, s))[:, None]
        for k0 in range(0, t, KV_TILE):
            ks = slice(k0, k0 + KV_TILE)
            kpos = torch.arange(k0, min(k0 + KV_TILE, t))[None, :]
            x = qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2) * scale
            if softcap is not None:
                th = torch.tanh(x / softcap)
                x = th * softcap
            p = torch.where(_valid(qpos, kpos, causal, window),
                            torch.exp2(x * log2e - lse2[:, :, qs, None]),
                            torch.tensor(0.0))
            dp = dof[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
            ds = p * (dp - dsum[:, :, qs, None])
            if softcap is not None:
                ds = ds * (1 - th * th)
            pb, dsb = (y.to(torch.bfloat16).float() for y in (p, ds))
            dv[:, :, ks] += pb.transpose(-1, -2) @ dof[:, :, qs]
            dk[:, :, ks] += dsb.transpose(-1, -2) @ qf[:, :, qs]
            dq[:, :, qs] += dsb @ kf[:, :, ks]

    def per_kv_head(x):                      # sum over each query group
        return x.reshape(b, nkv, g, t, hd).sum(2).transpose(1, 2)

    return ((dq * scale).transpose(1, 2).to(torch.bfloat16),
            (per_kv_head(dk) * scale).to(torch.bfloat16),
            per_kv_head(dv).to(torch.bfloat16))


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_tensor_core_backward_model_fits_the_bound(case):
    b, s, nq, nkv, hd, causal, window, softcap = GRAD_CASES[case]
    kw = dict(causal=causal, window=window, softcap=softcap)
    rng = np.random.RandomState(5)
    (jq, q), (jk, k), (jv, v), (jdo, do) = (
        _both(rng.randn(*shape), jnp.bfloat16, torch.bfloat16)
        for shape in ((b, s, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd),
                      (b, s, nq, hd)))
    o, lse = tensor_core_forward(q, k, v, **kw)
    grads = tensor_core_backward(q, k, v, o, lse, do, **kw)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.attention_ref(q_, k_, v_, **kw),
                     jq, jk, jv)
    for g, w in zip(grads, vjp(jdo)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=TOL_GRAD, atol=TOL_GRAD)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_hands_the_kernels_aligned_inputs(dtype, monkeypatch):
    """`flash_attention_bwd` on CUDA passes bf16 o and do (with q, k, v)
    through `cp_async_ready`: an unaligned one reaches the kernels as an
    aligned copy, an aligned one as itself; f32 inputs (CUDA-core
    kernels, any strides) as they are. Here the launches are recorded,
    not run, on CPU tensors taken down the CUDA path."""
    launched = []
    monkeypatch.setattr(fa, "_device_type", lambda q: "cuda")
    monkeypatch.setattr(fa, "_launch", lambda entry, args, q: launched.append(
        (entry, args.q, args.o, args.dout, args.o_sh, args.do_sh)))
    monkeypatch.setattr(fa.flash_attention_bwd, "launches", 0)
    b, s, nq, nkv, hd = 1, 8, 4, 2, 16
    q = torch.randn(b, s, nq, hd, dtype=dtype)
    k, v = (torch.randn(b, s, nkv, hd, dtype=dtype) for _ in range(2))
    lse = torch.zeros(b, nq, s)
    o = torch.randn(b * s * nq * hd + 1, dtype=dtype)[1:].view(b, s, nq, hd)
    do = torch.randn(b, s, nq, 20, dtype=dtype)[..., :hd]  # 40-byte heads
    assert q.data_ptr() % 16 == 0 and o.data_ptr() % 16
    fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert [x[0] for x in launched] == ["flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkdv"]
    assert fa.flash_attention_bwd.launches == 2
    for _, q_ptr, o_ptr, do_ptr, o_sh, do_sh in launched:
        assert q_ptr == q.data_ptr()         # aligned: read in place
        if dtype == torch.bfloat16:
            assert o_ptr % 16 == 0 and do_ptr % 16 == 0
            assert o_sh == do_sh == hd       # contiguous copies
        else:
            assert (o_ptr, do_ptr) == (o.data_ptr(), do.data_ptr())
            assert do_sh == 20


def test_cp_async_ready_keeps_aligned_inputs():
    q = torch.randn(2, 64, 4, 16, dtype=torch.bfloat16)
    assert cp_async_ready(q) is q
    # the k heads of a fused q/k/v projection: read through its strides
    k = torch.randn(2, 64, 3 * 4, 16, dtype=torch.bfloat16)[:, :, 4:8]
    assert not k.is_contiguous() and cp_async_ready(k) is k


@pytest.mark.parametrize("what", ["base", "head stride"])
def test_cp_async_ready_copies_unaligned_inputs(what):
    if what == "base":
        t = torch.randn(2 * 8 * 2 * 16 + 1, dtype=torch.bfloat16)[1:] \
            .view(2, 8, 2, 16)
    else:                        # heads of 20 elements: 40 bytes apart
        t = torch.randn(2, 8, 2, 20, dtype=torch.bfloat16)[..., :16]
    assert t.data_ptr() % 16 or t.stride(2) * 2 % 16
    c = cp_async_ready(t)
    assert c.data_ptr() % 16 == 0 and c.is_contiguous()
    assert torch.equal(c, t)
