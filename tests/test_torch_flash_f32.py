"""The f32 flash kernels' design, checked on the CPU against the JAX
package before any card runs it.

A numerical model of the CUDA-core f32 kernels, written here and not in
the package (as `test_torch_tensor_core.py` models the bf16 ones):

- the forward walks key tiles of 32 for each warp's rows (32 a warp, 16 at
  hd 128), skips the tiles that hold no live pair for those rows, and runs
  the online softmax in base 2 with the scale folded into one multiply-add
  before exp2; masked p are 0, the denominator is clamped at 1e-30, o is
  rounded once and lse returned in base e. It holds against JAX's
  `flash_attention(..., interpret=True)` at 2e-5 and its lse against a
  numpy float64 logsumexp at 1e-5, the tolerances `chip_smoke.py` applies
  to the kernel on the card.
- the backward recomputes P = 2^(dot * scale * log2e - lse * log2e) tile by
  tile; dq sums dS K over key tiles in order; dk and dv are summed over
  query tiles for each query head (the dk/dv kernel's partials) and then
  over each group's heads in the order g = 0, 1, ... (the third launch).
  It holds against `jax.vjp` of JAX's `attention_ref` at 1e-4.
- a row's o and lse do not depend on S or B: every tile has one shape, so
  the same rows give the same bits in a shorter or narrower call.

The wrapper's side of the f32 route (its launches and aligned inputs) is
checked with its launches recorded instead of run.
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from test_torch_flash_attention import GRAD_CASES  # noqa: E402
from test_torch_tensor_core import FWD_CASES, _np_lse  # noqa: E402

STREAM = 32                      # keys (queries in dk/dv) a streamed tile
NEG_INF = -1e30                  # the kernels' masked score
LOG2E = 1.0 / math.log(2.0)
TOL_O, TOL_LSE, TOL_GRAD = 2e-5, 1e-5, 1e-4   # chip_smoke.py's f32 bounds


def _warp_rows(hd):
    """Query rows a warp of the forward owns."""
    return 32 if hd <= 64 else 16


def _live(q0, nq, k0, nk, causal, window):
    """Queries [q0, q0 + nq) and keys [k0, k0 + nk) hold a live pair."""
    if causal and k0 > q0 + nq - 1:
        return False
    return not (window is not None and k0 + nk - 1 <= q0 - window)


def _valid(qpos, kpos, s, t, causal, window):
    valid = (qpos < s) & (kpos < t)
    if causal:
        valid &= kpos <= qpos
    if window is not None:
        valid &= kpos > qpos - window
    return valid


def _tiles(x, n, dim):
    """x split along `dim` into tiles of n, the last zero-padded to n."""
    pad = -x.shape[dim] % n
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, torch.zeros(shape, dtype=x.dtype)], dim)
    return x.split(n, dim)


def _heads(q, k, v):
    """[B,S,nq,hd] q and [B,T,nkv,hd] k, v as [B,nq,*,hd], k and v
    repeated over each group."""
    g = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2), k.repeat_interleave(g, 2).transpose(1, 2),
            v.repeat_interleave(g, 2).transpose(1, 2))


def f32_forward(q, k, v, causal=False, window=None, softcap=None):
    """The f32 forward's arithmetic -> (o [B,S,nq,hd], lse [B,nq,S])."""
    b, s, nq, hd = q.shape
    t = k.shape[1]
    wr, scale = _warp_rows(hd), hd ** -0.5
    sl2 = scale * LOG2E
    qh, kh, vh = _heads(q, k, v)
    k_tiles, v_tiles = _tiles(kh, STREAM, 2), _tiles(vh, STREAM, 2)
    o_rows, lse_rows = [], []
    for r, q_t in enumerate(_tiles(qh, wr, 2)):
        q0 = r * wr
        qpos = torch.arange(q0, q0 + wr)[:, None]
        m = torch.full((b, nq, wr), NEG_INF)
        l = torch.zeros((b, nq, wr))
        o = torch.zeros((b, nq, wr, hd))
        for c, (k_t, v_t) in enumerate(zip(k_tiles, v_tiles)):
            k0 = c * STREAM
            if not _live(q0, wr, k0, STREAM, causal, window):
                continue
            valid = _valid(qpos, torch.arange(k0, k0 + STREAM)[None, :], s,
                           t, causal, window)
            x = q_t @ k_t.transpose(-1, -2)
            if softcap is not None:
                x = torch.tanh(x * scale / softcap) * softcap * LOG2E
            x = torch.where(valid, x, torch.tensor(NEG_INF))
            mx = x.amax(-1)
            m_new = torch.maximum(m, mx if softcap is not None
                                  else mx * sl2)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None] if softcap is not None
                           else x * sl2 - m_new[..., None])
            p = torch.where(valid, p, torch.tensor(0.0))
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + p @ v_t
            m = m_new
        o_rows.append(o / l.clamp_min(1e-30)[..., None])
        lse_rows.append((m + torch.log2(l)) / LOG2E)
    o = torch.cat(o_rows, 2)[:, :, :s].transpose(1, 2)
    return o, torch.cat(lse_rows, 2)[..., :s]


def f32_backward(q, k, v, o, lse, do, causal=False, window=None,
                 softcap=None):
    """The f32 backward's arithmetic -> (dq, dk, dv)."""
    b, s, nq, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = hd ** -0.5
    sl2 = scale * LOG2E
    qh, kh, vh = _heads(q, k, v)
    doh = do.transpose(1, 2)
    lse2 = lse * LOG2E                                       # [B,nq,S]
    dsum = (do * o).sum(-1).transpose(1, 2)                  # [B,nq,S]
    pad = torch.zeros((b, nq, -s % STREAM))
    lse2_t = torch.cat([lse2, pad], -1).split(STREAM, -1)
    dsum_t = torch.cat([dsum, pad], -1).split(STREAM, -1)

    def p_ds(q_t, do_t, k_t, v_t, q0, k0, lse2_q, d_q):
        """P and dS of a (query tile, key tile) pair, [B,nq,q,k]."""
        valid = _valid(torch.arange(q0, q0 + q_t.shape[2])[:, None],
                       torch.arange(k0, k0 + k_t.shape[2])[None, :], s, t,
                       causal, window)
        x = q_t @ k_t.transpose(-1, -2)
        dcap = 1.0
        if softcap is not None:
            th = torch.tanh(x * scale / softcap)
            dcap = 1 - th * th
            p = torch.exp2(th * softcap * LOG2E - lse2_q[..., None])
        else:
            p = torch.exp2(x * sl2 - lse2_q[..., None])
        p = torch.where(valid, p, torch.tensor(0.0))
        dp = do_t @ v_t.transpose(-1, -2)
        return p, p * (dp - d_q[..., None]) * dcap

    # dq: warps of 16 rows over key tiles of 32, in order
    k_tiles, v_tiles = _tiles(kh, STREAM, 2), _tiles(vh, STREAM, 2)
    dq = []
    for r, (q_t, do_t) in enumerate(zip(_tiles(qh, 16, 2),
                                        _tiles(doh, 16, 2))):
        q0 = r * 16
        lse2_q = torch.cat([lse2, pad], -1)[..., q0:q0 + 16]
        d_q = torch.cat([dsum, pad], -1)[..., q0:q0 + 16]
        acc = torch.zeros((b, nq, 16, hd))
        for c, (k_t, v_t) in enumerate(zip(k_tiles, v_tiles)):
            if _live(q0, 16, c * STREAM, STREAM, causal, window):
                _, ds = p_ds(q_t, do_t, k_t, v_t, q0, c * STREAM, lse2_q,
                             d_q)
                acc = acc + ds @ k_t
        dq.append(acc)
    dq = (torch.cat(dq, 2)[:, :, :s] * scale).transpose(1, 2)

    # dk/dv: warps of 16 keys over query tiles of 32, each query head's
    # partials, then each group's heads summed in order
    q_tiles, do_tiles = _tiles(qh, STREAM, 2), _tiles(doh, STREAM, 2)
    dk_part, dv_part = [], []
    for r, (k_t, v_t) in enumerate(zip(_tiles(kh, 16, 2),
                                       _tiles(vh, 16, 2))):
        k0 = r * 16
        dk_acc = torch.zeros((b, nq, 16, hd))
        dv_acc = torch.zeros((b, nq, 16, hd))
        for c, (q_t, do_t) in enumerate(zip(q_tiles, do_tiles)):
            if _live(c * STREAM, STREAM, k0, 16, causal, window):
                p, ds = p_ds(q_t, do_t, k_t, v_t, c * STREAM, k0, lse2_t[c],
                             dsum_t[c])
                dv_acc = dv_acc + p.transpose(-1, -2) @ do_t
                dk_acc = dk_acc + ds.transpose(-1, -2) @ q_t
        dk_part.append(dk_acc)
        dv_part.append(dv_acc)

    def group_sum(parts):                    # [B,nq,T,hd] -> [B,T,nkv,hd]
        x = torch.cat(parts, 2)[:, :, :t].reshape(b, nkv, g, t, hd)
        total = x[:, :, 0]
        for i in range(1, g):
            total = total + x[:, :, i]
        return total.transpose(1, 2)

    return dq, group_sum(dk_part) * scale, group_sum(dv_part)


def _both(a):
    """One numpy array as a JAX f32 array and a torch f32 tensor."""
    return jnp.asarray(a, jnp.float32), torch.from_numpy(
        np.asarray(a, np.float32))


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_f32_forward_model_fits_the_bound(case):
    b, s, nq, nkv, hd, causal, window, softcap = FWD_CASES[case]
    kw = dict(causal=causal, window=window, softcap=softcap)
    rng = np.random.RandomState(6)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.randn(*shape))
        for shape in ((b, s, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd)))
    o, lse = f32_forward(q, k, v, **kw)
    assert o.dtype == torch.float32 and o.shape == q.shape
    want = jax_flash_attention(jq, jk, jv, blk_q=64, blk_k=64,
                               interpret=True, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=TOL_O,
                               atol=TOL_O)
    np.testing.assert_allclose(lse.numpy(),
                               _np_lse(q.numpy(), k.numpy(), causal, window,
                                       softcap),
                               rtol=TOL_LSE, atol=TOL_LSE)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_f32_backward_model_fits_the_bound(case):
    b, s, nq, nkv, hd, causal, window, softcap = GRAD_CASES[case]
    kw = dict(causal=causal, window=window, softcap=softcap)
    rng = np.random.RandomState(7)
    (jq, q), (jk, k), (jv, v), (jdo, do) = (
        _both(rng.randn(*shape))
        for shape in ((b, s, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd),
                      (b, s, nq, hd)))
    o, lse = f32_forward(q, k, v, **kw)
    grads = f32_backward(q, k, v, o, lse, do, **kw)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.attention_ref(q_, k_, v_, **kw),
                     jq, jk, jv)
    for g, w in zip(grads, vjp(jdo)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL_GRAD,
                                   atol=TOL_GRAD)


@pytest.mark.parametrize("case", ["GQA 14:2", "window+softcap", "MQA hd128"])
def test_f32_forward_rows_do_not_depend_on_s_or_b(case):
    """Rows 0 .. n-1 of a call are the same bits in a call on the first n
    positions, and a batch row the same bits in a call on it alone."""
    b, s, nq, nkv, hd, causal, window, softcap = FWD_CASES[case]
    kw = dict(causal=causal, window=window, softcap=softcap)
    b = max(b, 2)
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               for shape in ((b, s, nq, hd), (b, s, nkv, hd),
                             (b, s, nkv, hd)))
    o, lse = f32_forward(q, k, v, **kw)
    n = s // 2 + 3                         # a ragged shorter call
    o_s, lse_s = f32_forward(q[:, :n], k[:, :n], v[:, :n], **kw)
    assert torch.equal(o[:, :n], o_s) and torch.equal(lse[..., :n], lse_s)
    o_b, lse_b = f32_forward(q[1:2], k[1:2], v[1:2], **kw)
    assert torch.equal(o[1:2], o_b) and torch.equal(lse[1:2], lse_b)


def _record_launches(monkeypatch):
    """Take CPU tensors down the CUDA path of the wrappers, recording each
    launch's entry and arguments instead of running it."""
    launched = []
    monkeypatch.setattr(fa, "_device_type", lambda q: "cuda")
    monkeypatch.setattr(fa, "_launch", lambda entry, args, q: launched.append(
        (entry, args)))
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    monkeypatch.setattr(fa.flash_attention_bwd, "launches", 0)
    monkeypatch.setattr(fa.flash_attention_bwd, "by_shape",
                        fa.collections.Counter())
    return launched


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_launch_counts_follow_the_dtype(dtype, monkeypatch):
    """bf16: dq, then dk/dv. f32: dq, dk/dv into each query head's
    partials, then their sum by group; the partials' pointers reach the
    f32 kernels only. Each launch counts once, in total and by shape."""
    launched = _record_launches(monkeypatch)
    b, s, nq, nkv, hd = 2, 24, 4, 2, 16
    q, do = (torch.randn(b, s, nq, hd, dtype=dtype) for _ in range(2))
    k, v = (torch.randn(b, s, nkv, hd, dtype=dtype) for _ in range(2))
    o, lse = torch.randn(b, s, nq, hd, dtype=dtype), torch.zeros(b, nq, s)
    for _ in range(2):
        fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = {torch.bfloat16: ["flash_attention_bwd_dq",
                             "flash_attention_bwd_dkdv"],
            torch.float32: ["flash_attention_bwd_dq",
                            "flash_attention_bwd_dkdv",
                            "flash_attention_bwd_sum"]}[dtype]
    assert [e for e, _ in launched] == 2 * want
    assert fa.BWD_LAUNCHES[dtype] == len(want)
    assert fa.flash_attention_bwd.launches == 2 * len(want)
    key = fa.shape_key(q, k, True, None, None)
    assert fa.flash_attention_bwd.by_shape == {key: 2 * len(want)}
    for _, args in launched:
        assert bool(args.dk_part) == bool(args.dv_part) == \
            (dtype == torch.float32)
