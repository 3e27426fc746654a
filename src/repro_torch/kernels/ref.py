"""Plain PyTorch versions of the kernels: the numerical contract.

Counterpart of `repro/kernels/ref.py`. Each hand-written kernel is held
against its function here (the CPU tests against the JAX oracles, and
`chip_smoke.py` on the card). Products take f32 operands built from the
inputs' own values (bf16 products are exact in f32), so the accumulation
is f32 as with JAX's ``preferred_element_type=jnp.float32``.
`flash_attention_ref` and `flash_attention_bwd_ref` are the plain versions
of the flash-attention kernels: the forward's arithmetic as
`repro/kernels/flash_attention.py` does it (f32 softmax weights, a
start-aligned causal mask), and the backward the kernel computes.
`moe_gemm_bwd_ref` is the plain version of the `moe_gemm` backward
kernels (dx and dw, which the JAX package leaves to autodiff).
`selective_scan_ref` and `ssm_scan_ref` walk time in a Python loop in f32;
the JAX oracle's chunked `jax.checkpoint` (a memory device for its
backward) does not change the result and is left out.
`selective_scan_bwd_ref` is the plain version of the selective-scan
backward kernel (the JAX package differentiates its oracle instead): it
keeps the states at chunk boundaries only, as that checkpoint does, and
walks time in reverse.
`mlstm_step` and `slstm_step` are xLSTM's one-step recurrences
(`repro/models/ssm.py:_mlstm_step`, `_slstm_step`), which the models'
decode calls; `mlstm_scan_ref` and `slstm_scan_ref` loop them over time
from a zero state and are the plain versions of the xLSTM scan kernels
(JAX runs them as `lax.scan` bodies and has no Pallas kernel for them).
`slstm_scan_trails_ref` is the plain version of the sLSTM kernel that
also keeps the trails its backward reads. `mlstm_scan_bwd_ref` and
`slstm_scan_bwd_ref` are the plain xLSTM backwards (JAX differentiates
the `lax.scan`), reverse walks in the step form, which the CPU path
runs; `mlstm_scan_bwd_chunkwise_ref` and `slstm_scan_dpre_affine_ref`
are the plain versions of the backward kernels, in their passes and
orders (the mLSTM's in the chunkwise form, the sLSTM's cell as an affine
map, its recurrent sum as the cluster's 8 block partials);
`slstm_grad_weights` is the recurrent weights' and bias's gradient, a
plain product outside any kernel on both devices.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, window: Optional[int] = None,
                  kv_len: Union[None, int, torch.Tensor] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention oracle.

    q [B,S,nq,hd]; k/v [B,T,nkv,hd] with nq % nkv == 0.
    causal     — standard causal mask (queries at positions T-S..T-1)
    window     — additionally restrict to a trailing sliding window
    kv_len     — scalar or [B]: only keys < kv_len are valid (decode)
    softcap    — tanh softcapping of attention logits (Gemma-2)
    """
    b, s, nq, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(b, s, nkv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    kpos = torch.arange(t, device=q.device)
    if kv_len is not None:
        # decode: query position is kv_len-1 (cache padded to t)
        kv = torch.as_tensor(kv_len, device=q.device)
        if kv.ndim == 0:
            kv = kv[None]
        valid = kpos[None, :] < kv[:, None]          # [B,T]
        if window is not None:
            valid &= kpos[None, :] > (kv[:, None] - 1) - window
        m5 = valid[:, None, None, None, :]           # [B,1,1,1,T]
    else:
        qpos = torch.arange(s, device=q.device) + (t - s)  # align to seq end
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        m5 = mask[None, None, None]
    scores = torch.where(m5, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype).float(), v.float())
    return o.reshape(b, s, nq, hd).to(q.dtype)


def _flash_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  window: Optional[int], softcap: Optional[float]):
    """Masked f32 scores [B,nkv,g,S,T], the mask, and tanh(u/softcap)
    (None without softcap). Query i sits at position i (start-aligned,
    as in the flash kernel)."""
    b, s, nq, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, nkv, nq // nkv, hd)
    x = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * hd ** -0.5
    cap = None
    if softcap is not None:
        cap = torch.tanh(x / softcap)
        x = cap * softcap
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return torch.where(mask, x, torch.full_like(x, NEG_INF)), mask, cap


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False, window: Optional[int] = None,
                        softcap: Optional[float] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain flash-attention forward: (o [B,S,nq,hd] in q's dtype, lse
    [B,nq,S] f32), lse the log-sum-exp of each row's masked scores."""
    b, s, nq, hd = q.shape
    x, _, _ = _flash_scores(q, k, causal, window, softcap)
    lse = torch.logsumexp(x, dim=-1)                     # [B,nkv,g,S]
    w = torch.exp(x - lse[..., None])
    o = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return o.reshape(b, s, nq, hd).to(q.dtype), lse.reshape(b, nq, s)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = False,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain flash-attention backward: (dq, dk, dv) in the inputs' dtypes
    from the forward's o and lse and the output gradient do, in f32:
    P = exp(x - lse), D = rowsum(do * o), dS = P * (dP - D), times
    1 - tanh^2 under softcap; dq = scale dS K, dk = scale dS^T Q,
    dv = P^T dO (summed over each kv head's query group)."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    x, mask, cap = _flash_scores(q, k, causal, window, softcap)
    p = torch.where(mask, torch.exp(x - lse.reshape(b, nkv, g, s, 1)),
                    torch.zeros_like(x))
    dog = do.reshape(b, s, nkv, g, hd).float()
    dsum = (do.float() * o.float()).sum(-1)              # [B,S,nq]
    dsum = dsum.reshape(b, s, nkv, g).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bskgh,btkh->bkgst", dog, v.float())
    ds = p * (dp - dsum)
    if cap is not None:
        ds = ds * (1 - cap * cap)
    scale = hd ** -0.5
    qg = q.reshape(b, s, nkv, g, hd).float()
    dq = torch.einsum("bkgst,btkh->bskgh", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    return (dq.reshape(b, s, nq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def ssm_scan_ref(a: torch.Tensor, bx: torch.Tensor,
                 h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear recurrence oracle: h_t = a_t * h_{t-1} + bx_t over axis 1 in
    f32, every h_t returned in bx's dtype. a/bx [B, S, ...]
    (elementwise), h0 [B, ...]."""
    h = (torch.zeros_like(bx[:, 0], dtype=torch.float32) if h0 is None
         else h0.float())
    af, bf = a.float(), bx.float()
    hs = []
    for t in range(bx.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(bx.dtype)


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       d: torch.Tensor, h0: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Mamba selective scan oracle (never materializes [B,S,D,N]).

    x/dt [B,S,D]; a_log [D,N] (A = -exp(a_log)); b/c [B,S,N]; d [D].
    h_t = exp(dt_t A) h_{t-1} + dt_t b_t x_t ;  y_t = h_t c_t + d x_t.
    Returns (y [B,S,D] in x's dtype, h_last [B,D,N] f32).
    """
    bsz, s, dd = x.shape
    n = a_log.shape[1]
    h = (torch.zeros((bsz, dd, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    a = -torch.exp(a_log.float())
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    ys = []
    for t in range(s):
        dtt = dtf[:, t]                                  # [B,D]
        da = torch.exp(dtt[..., None] * a[None])         # [B,D,N]
        h = da * h + (dtt * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * d.float()[None, None]
    return y.to(x.dtype), h


def selective_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                           a_log: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor, d: torch.Tensor,
                           h0: Optional[torch.Tensor], dy: torch.Tensor,
                           dh_last: Optional[torch.Tensor] = None,
                           chunk: int = 128) -> tuple[torch.Tensor, ...]:
    """Plain selective-scan backward: the gradients of
    `selective_scan_ref(x, dt, a_log, b, c, d, h0)` for the output
    gradients dy [B,S,D] and dh_last [B,D,N] (None: zero), in f32.

    With A = -exp(a_log), da_t = exp(dt_t A) and g_t the gradient of h_t,
    seeded with dh_last:
      g_t = dy_t C_t + da_{t+1} g_{t+1}
      dC_t = sum_d dy_t h_t          dB_t = sum_d g_t dt_t x_t
      dx_t = sum_n g_t dt_t B_t + dy_t D
      ddt_t = sum_n g_t (A da_t h_{t-1} + x_t B_t)
      da_log = A * sum_{b,t} g_t dt_t da_t h_{t-1}
      dD = sum_{b,t} dy_t x_t        dh0 = da_1 g_1
    The states are kept only at every `chunk`-th step and each chunk's
    are recomputed from its first when the reverse walk reaches it, so
    [B,S,D,N] is never held. Returns (dx, ddt, da_log, db, dc, dd, dh0):
    dx, ddt, db and dc in their inputs' dtypes, the rest f32.
    """
    bsz, s, dd = x.shape
    n = a_log.shape[1]
    a = -torch.exp(a_log.float())                        # [D,N]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    dyf, df = dy.float(), d.float()
    h = (torch.zeros((bsz, dd, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())

    def step(h, t):
        da = torch.exp(dtf[:, t, :, None] * a[None])     # [B,D,N]
        return da, da * h + (dtf[:, t] * xf[:, t])[..., None] \
            * bf[:, t, None, :]

    starts = []                                          # h before chunk k
    for t in range(s):
        if t % chunk == 0:
            starts.append(h)
        h = step(h, t)[1]
    carry = (torch.zeros_like(h) if dh_last is None
             else dh_last.float().clone())               # da_{t+1} g_{t+1}
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    acc_a = torch.zeros((dd, n), dtype=torch.float32, device=x.device)
    for k in reversed(range(len(starts))):
        t0 = k * chunk
        hs = [starts[k]]                                 # hs[i]: h before t0+i
        for t in range(t0, min(s, t0 + chunk) - 1):
            hs.append(step(hs[-1], t)[1])
        for t in reversed(range(t0, min(s, t0 + chunk))):
            h_prev = hs[t - t0]
            da, h_t = step(h_prev, t)
            g = carry + dyf[:, t, :, None] * cf[:, t, None, :]
            dc[:, t] = torch.einsum("bdn,bd->bn", h_t, dyf[:, t])
            db[:, t] = torch.einsum("bdn,bd->bn", g, dtf[:, t] * xf[:, t])
            sx = torch.einsum("bdn,bn->bd", g, bf[:, t])
            dx[:, t] = dtf[:, t] * sx + dyf[:, t] * df
            gdh = g * da * h_prev
            ddt[:, t] = (gdh * a).sum(-1) + xf[:, t] * sx
            acc_a += (gdh * dtf[:, t, :, None]).sum(0)
            carry = da * g
    dd_ = (dyf * xf).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), a * acc_a, db.to(b.dtype),
            dc.to(c.dtype), dd_, carry)


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped (per-expert) matmul: x [E,C,d] @ w [E,d,f] -> [E,C,f],
    accumulating in f32, output in x's dtype."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def moe_gemm_dx_ref(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx [E,C,d] = dy [E,C,f] @ w[E,d,f]^T in f32, in dy's dtype."""
    return torch.bmm(dy.float(), w.float().transpose(1, 2)).to(dy.dtype)


def moe_gemm_dw_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw [E,d,f] = x[E,C,d]^T @ dy [E,C,f] in f32, in dy's dtype."""
    return torch.bmm(x.float().transpose(1, 2), dy.float()).to(dy.dtype)


def moe_gemm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain `moe_gemm` backward: (dx [E,C,d], dw [E,d,f]) from the
    forward's x and w and the output gradient dy [E,C,f], f32 products
    rounded once to the operands' dtype."""
    return moe_gemm_dx_ref(dy, w), moe_gemm_dw_ref(x, dy)


def mlstm_step(carry: tuple, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, i: torch.Tensor, f: torch.Tensor
               ) -> tuple[tuple, torch.Tensor]:
    """One mLSTM step (repro/models/ssm.py:_mlstm_step). carry (C
    [B,H,hd,hd], n [B,H,hd], m [B,H]); q (pre-scaled), k, v [B,H,hd]; i, f
    [B,H] gate pre-activations -> (carry, y [B,H,hd]). The stabiliser m
    starts at 0; y = C q / max(|n . q|, 1)."""
    c, n, m = carry
    log_f = F.logsigmoid(f)
    m_new = torch.maximum(log_f + m, i)
    i_p = torch.exp(i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p[..., None, None] * c + i_p[..., None, None] * \
        (v[..., :, None] * k[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", c, q)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), min=1.0)
    return (c, n, m_new), num / den[..., None]


def slstm_step(carry: tuple, pre: torch.Tensor, w_r: torch.Tensor,
               bias: torch.Tensor) -> tuple[tuple, torch.Tensor]:
    """One sLSTM step (repro/models/ssm.py:_slstm_step). carry (c, n, h, m)
    [B,H,hd] each; pre [B,4,H,hd] the input pre-activations of the i, f,
    z, o gates; w_r [4,H,hd,hd] block-diagonal recurrent weights; bias
    [4,H,hd] -> (carry, h [B,H,hd])."""
    c, n, h, m = carry
    rec = torch.einsum("khvw,bhw->bkhv", w_r, h)
    pre = pre + rec + bias[None]
    it, ft, zt, ot = pre.unbind(1)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p * c + i_p * torch.tanh(zt)
    n = f_p * n + i_p
    h = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
    return (c, n, h, m_new), h


def _scan_dtype(t: torch.Tensor) -> torch.dtype:
    """f32, or f64 for f64 inputs (a reference of higher precision)."""
    return torch.promote_types(t.dtype, torch.float32)


def mlstm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """mLSTM over time from a zero state: q (pre-scaled), k, v [B,S,H,hd];
    i, f [B,S,H] -> y [B,S,H,hd], in f32 (f64 for f64 inputs)."""
    bsz, s, nh, hd = q.shape
    dt = _scan_dtype(q)
    q, k, v, i, f = (t.to(dt) for t in (q, k, v, i, f))
    carry = (q.new_zeros((bsz, nh, hd, hd)), q.new_zeros((bsz, nh, hd)),
             q.new_zeros((bsz, nh)))
    ys = []
    for t in range(s):
        carry, y = mlstm_step(carry, q[:, t], k[:, t], v[:, t], i[:, t],
                              f[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1)


def _mlstm_chunks(t: torch.Tensor, chunk: int, fill: float = 0.0
                  ) -> torch.Tensor:
    """[B,S,H,...] -> [B,H,N,chunk,...]: S cut into N chunks of `chunk`
    steps, the last padded with `fill`."""
    bsz, s, nh = t.shape[:3]
    nch = -(-s // chunk)
    pad = t.new_full((bsz, nch * chunk - s, *t.shape[2:]), fill)
    t = torch.cat([t, pad], dim=1).reshape(bsz, nch, chunk, *t.shape[2:])
    return t.movedim(3, 1)


def _mlstm_chunk_gates(i: torch.Tensor, f: torch.Tensor, chunk: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunkwise mLSTM's gate terms, in float64 (a chunk-local sum of
    up to `chunk` log forget gates keeps its small differences there): b
    [B,H,N,L] the chunk-local inclusive cumulative sum of log_sigmoid(f),
    and c = i - b, -inf at the steps past S. log_sigmoid itself is taken
    in the inputs' dtype, as the step does."""
    lf = _mlstm_chunks(F.logsigmoid(f.to(_scan_dtype(f))), chunk).double()
    b = lf.cumsum(-1)
    i = _mlstm_chunks(i.double(), chunk, float("-inf"))
    return b, i - b


def mlstm_chunk_states_ref(k: torch.Tensor, v: torch.Tensor, i: torch.Tensor,
                           f: torch.Tensor, chunk: int
                           ) -> tuple[torch.Tensor, ...]:
    """The chunkwise mLSTM's first pass (csrc/xlstm_scan.cu,
    mlstm_scan_state_kernel): the stabilised state before each chunk's
    first step, k, v [B,S,H,hd]; i, f [B,S,H] -> C [B,H,N,hd,hd] (v row,
    k column), n [B,H,N,hd], m [B,H,N] (chunk 0's: zeros), N = ceil(S /
    chunk); f32 (f64 for f64 inputs). For a chunk with state (C, n, m),
    M = max(m, max_s c_s) over its steps, C' = e C + sum_s w_s v_s k_s^T
    and n' = e n + sum_s w_s k_s with w_s = exp(c_s - M), e = exp(m - M)
    (both <= 1), and m' = b_last + M rounded to the working dtype."""
    bsz, s, nh, hd = k.shape
    dt = _scan_dtype(k)
    kc, vc = (_mlstm_chunks(t.to(dt), chunk) for t in (k, v))
    b, c = _mlstm_chunk_gates(i, f, chunk)
    nch = b.shape[2]
    cs = [k.new_zeros((bsz, nh, hd, hd), dtype=dt)]
    ns = [k.new_zeros((bsz, nh, hd), dtype=dt)]
    ms = [k.new_zeros((bsz, nh), dtype=dt)]
    for j in range(nch - 1):
        big = torch.maximum(ms[-1].double(), c[:, :, j].amax(-1))
        w = torch.exp((c[:, :, j] - big[..., None]).to(dt))
        e = torch.exp((ms[-1].double() - big).to(dt))
        wv = w[..., None] * vc[:, :, j]
        cs.append(e[..., None, None] * cs[-1]
                  + torch.einsum("bhsv,bhsk->bhvk", wv, kc[:, :, j]))
        ns.append(e[..., None] * ns[-1]
                  + torch.einsum("bhs,bhsk->bhk", w, kc[:, :, j]))
        ms.append((b[:, :, j, -1] + big).to(dt))
    return torch.stack(cs, 2), torch.stack(ns, 2), torch.stack(ms, 2)


def mlstm_scan_chunkwise_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, i: torch.Tensor,
                             f: torch.Tensor, chunk: int) -> torch.Tensor:
    """mLSTM over time from a zero state in the chunkwise form the kernels
    take (csrc/xlstm_scan.cu): the chunk-start states
    (`mlstm_chunk_states_ref`), then every chunk's outputs at once, as
    mlstm_scan_out_kernel forms them. For step t of a chunk with state (C,
    n, m): M_t = max(m, max_{s<=t} c_s), D_ts = exp(c_s - M_t) (s <= t),
    e_t = exp(m - M_t); num_t = e_t C q_t + sum_s D_ts (k_s . q_t) v_s,
    den_t = e_t n . q_t + sum_s D_ts (k_s . q_t), y_t = num_t /
    max(|den_t|, 1). Equals `mlstm_scan_ref` up to rounding (its m_t is
    b_t + M_t). Same arguments as `mlstm_scan_ref`, plus the chunk length;
    f32 (f64 for f64 inputs)."""
    return mlstm_scan_states_ref(q, k, v, i, f, chunk)[0]


def mlstm_scan_states_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          i: torch.Tensor, f: torch.Tensor, chunk: int
                          ) -> tuple[torch.Tensor, tuple]:
    """`mlstm_scan_chunkwise_ref` keeping what the backward kernels read,
    in the kernels' layouts: (y, (C^T [B*H,N,hd,hd] ([k][v]), n [B*H,N,hd],
    m [B*H,N], the state before each chunk, and den' [B,S,H], each step's
    denominator before its clamp)); the plain version of the forward
    kernels under autograd."""
    bsz, s, nh, hd = q.shape
    dt = _scan_dtype(q)
    cst, nst, mst = mlstm_chunk_states_ref(k, v, i, f, chunk)
    qc, kc, vc = (_mlstm_chunks(t.to(dt), chunk) for t in (q, k, v))
    _, c = _mlstm_chunk_gates(i, f, chunk)
    big = torch.maximum(mst.double()[..., None], c.cummax(-1).values)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=q.device).tril()
    d = torch.where(causal, torch.exp((c[..., None, :] - big[..., None])
                                      .to(dt)), 0.0)
    e = torch.exp((mst.double()[..., None] - big).to(dt))
    p = torch.einsum("bhntk,bhnsk->bhnts", qc, kc) * d
    den = e * torch.einsum("bhntk,bhnk->bhnt", qc, nst) + p.sum(-1)
    num = e[..., None] * torch.einsum("bhntk,bhnvk->bhntv", qc, cst) + \
        torch.einsum("bhnts,bhnsv->bhntv", p, vc)
    y = num / torch.clamp(den.abs(), min=1.0)[..., None]
    nch = cst.shape[2]
    return _unchunk(y, s), (cst.transpose(-1, -2).reshape(-1, nch, hd, hd),
                            nst.reshape(-1, nch, hd), mst.reshape(-1, nch),
                            _unchunk(den, s))


def slstm_scan_ref(pre: torch.Tensor, w_r: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """sLSTM over time from a zero state: pre [B,S,4,H,hd]; w_r
    [4,H,hd,hd]; bias [4,H,hd] -> the h trail [B,S,H,hd], in f32 (f64 for
    f64 inputs)."""
    bsz, s, _, nh, hd = pre.shape
    dt = _scan_dtype(pre)
    pre, w_r, bias = (t.to(dt) for t in (pre, w_r, bias))
    z = pre.new_zeros((bsz, nh, hd))
    carry = (z, z, z, z)
    ys = []
    for t in range(s):
        carry, h = slstm_step(carry, pre[:, t], w_r, bias)
        ys.append(h)
    return torch.stack(ys, dim=1)


def mlstm_scan_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       i: torch.Tensor, f: torch.Tensor, y: torch.Tensor,
                       dy: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Plain mLSTM backward: the gradients (dq, dk, dv, di, df) of
    `mlstm_scan_ref(q, k, v, i, f)` for the output gradient dy, given its
    output y; f32 (f64 for f64 inputs). Ties split as autograd splits them:
    a max's gradient half to each side, a clamp's whole to its input.

    The step form, the CPU path's (the backward kernels take the chunkwise
    form, `mlstm_scan_bwd_chunkwise_ref`), in its passes:
      prep, forward: the m chain, f' and i' and which arm each max took;
        n from zero, den_t = max(|n_t . q_t|, 1) and
        g_t = -(dy_t . y_t) / den_t sign(n_t . q_t) [|n_t . q_t| >= 1]
      A, forward: C from zero, dq_t = C_t^T dy_t / den_t + g_t n_t
      B, reverse: dC_t = f'_{t+1} dC_{t+1} + (dy_t / den_t) q_t^T,
        dn_t = f'_{t+1} dn_{t+1} + g_t q_t,
        dk_t = i'_t (dC_t^T v_t + dn_t), dv_t = i'_t dC_t k_t
      gates, reverse: with log f' and log i' as the variables, their
        gradients are a_t = sum_{u>=t} (q_u . dq_u - k_u . dk_u) and
        b_t = k_t . dk_t (no C needed); M, the gradient of m_t from the
        steps after t, then gives
        dlog_sigmoid(f_t) = a_t + sel_t (M - a_t - b_t),
        di_t = b_t + (1 - sel_t) (M - a_t - b_t), and M becomes
        dlog_sigmoid(f_t) for step t - 1 (sel_t: 1 where the max took
        log_sigmoid(f_t) + m_{t-1}, 0 where it took i_t, 1/2 at a tie).
    """
    bsz, s, nh, hd = q.shape
    dt = _scan_dtype(q)
    q, k, v, i, f, y, dy = (t.to(dt) for t in (q, k, v, i, f, y, dy))
    # prep
    lf = F.logsigmoid(f)
    fp, ip, sel, den, g = (torch.empty_like(i) for _ in range(5))
    m = q.new_zeros((bsz, nh))
    n = q.new_zeros((bsz, nh, hd))
    for t in range(s):
        mf = lf[:, t] + m
        m_new = torch.maximum(mf, i[:, t])
        fp[:, t] = torch.exp(mf - m_new)
        ip[:, t] = torch.exp(i[:, t] - m_new)
        sel[:, t] = torch.where(mf > i[:, t], 1.0,
                                torch.where(mf < i[:, t], 0.0, 0.5))
        m = m_new
        n = fp[:, t, :, None] * n + ip[:, t, :, None] * k[:, t]
        dot = (n * q[:, t]).sum(-1)
        den[:, t] = torch.clamp(dot.abs(), min=1.0)
        g[:, t] = -(dy[:, t] * y[:, t]).sum(-1) / den[:, t] * \
            torch.sign(dot) * (dot.abs() >= 1.0)
    dnum = dy / den[..., None]
    # pass A
    dq = torch.empty_like(q)
    c = q.new_zeros((bsz, nh, hd, hd))
    n = q.new_zeros((bsz, nh, hd))
    for t in range(s):
        c = fp[:, t, :, None, None] * c + ip[:, t, :, None, None] * \
            (v[:, t, :, :, None] * k[:, t, :, None, :])
        n = fp[:, t, :, None] * n + ip[:, t, :, None] * k[:, t]
        dq[:, t] = torch.einsum("bhvk,bhv->bhk", c, dnum[:, t]) + \
            g[:, t, :, None] * n
    # pass B
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dc = q.new_zeros((bsz, nh, hd, hd))
    dn = q.new_zeros((bsz, nh, hd))
    for t in reversed(range(s)):
        if t + 1 < s:
            dc = fp[:, t + 1, :, None, None] * dc
            dn = fp[:, t + 1, :, None] * dn
        dc = dc + dnum[:, t, :, :, None] * q[:, t, :, None, :]
        dn = dn + g[:, t, :, None] * q[:, t]
        dk[:, t] = ip[:, t, :, None] * (
            torch.einsum("bhvk,bhv->bhk", dc, v[:, t]) + dn)
        dv[:, t] = ip[:, t, :, None] * torch.einsum("bhvk,bhk->bhv", dc,
                                                    k[:, t])
    return (dq, dk, dv,
            *_mlstm_gate_grads((q * dq).sum(-1), (k * dk).sum(-1), sel, f))


def _mlstm_gate_grads(qdq: torch.Tensor, kdk: torch.Tensor,
                      sel: torch.Tensor, f: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The mLSTM's gate gradients (di, df) [B,S,H] from q . dq and k . dk
    of each step and sel, the share of each step's max that went to its
    forget arm: a_t = sum_{u>=t} (q . dq - k . dk)_u, then the reverse walk
    of `mlstm_scan_bwd_ref`'s notes."""
    a = (qdq - kdk).flip(1).cumsum(1).flip(1)
    di, df = torch.empty_like(qdq), torch.empty_like(qdq)
    after = qdq.new_zeros((qdq.shape[0], qdq.shape[2]))     # M
    for t in reversed(range(qdq.shape[1])):
        rest = after - a[:, t] - kdk[:, t]
        dlf = a[:, t] + sel[:, t] * rest
        di[:, t] = kdk[:, t] + (1.0 - sel[:, t]) * rest
        df[:, t] = dlf * torch.sigmoid(-f[:, t])
        after = dlf
    return di, df


def _unchunk(t: torch.Tensor, s: int) -> torch.Tensor:
    """[B,H,N,L,...] -> [B,S,H,...], the inverse of `_mlstm_chunks`."""
    t = t.movedim(1, 3)
    return t.reshape(t.shape[0], -1, *t.shape[3:])[:, :s]


def mlstm_scan_bwd_chunkwise_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, i: torch.Tensor,
                                 f: torch.Tensor, y: torch.Tensor,
                                 dy: torch.Tensor, chunk: int
                                 ) -> tuple[torch.Tensor, ...]:
    """The mLSTM backward in the chunkwise form the backward kernels take
    (csrc/xlstm_scan_bwd.cu): the gradients (dq, dk, dv, di, df) of
    `mlstm_scan_ref(q, k, v, i, f)` for dy, given its output y, chunks of
    `chunk` steps; f32 (f64 for f64 inputs). Its passes:
      states: the state (C, n, m) before each chunk
        (`mlstm_chunk_states_ref`; the kernels read the forward's);
      prep: den'_t = e_t n . q_t + sum_s D_ts k_s . q_t as the forward
        forms it (the kernels keep the forward's), den_t = max(|den'_t|,
        1), g_t = -(dy_t . y_t) / den_t sign(den'_t) [|den'_t| >= 1], and
        the step form's m chain's arms (sel);
      reverse walk: dC_k = e dC_{k+1} + sum_t e_t dnum_t q_t^T (dnum =
        dy / den), dn_k = e dn_{k+1} + sum_t e_t g_t q_t, from 0 after
        the last chunk;
      chunks: with A_ts = D_ts (v_s . dnum_t + g_t), P_ts = D_ts (k_s .
        q_t) (s <= t),
        dq_t = e_t (C_k^T dnum_t + g_t n_k) + sum_s A_ts k_s,
        dk_s = sum_t A_ts q_t + w_s (dC_{k+1}^T v_s + dn_{k+1}),
        dv_s = sum_t P_ts dnum_t + w_s dC_{k+1} k_s;
      gates: `mlstm_scan_bwd_ref`'s reverse walk over q . dq, k . dk and
        sel.
    Equals `mlstm_scan_bwd_ref` up to rounding, ties split alike."""
    bsz, s, nh, hd = q.shape
    dt = _scan_dtype(q)
    q, k, v, i, f, y, dy = (t.to(dt) for t in (q, k, v, i, f, y, dy))
    cst, nst, mst = mlstm_chunk_states_ref(k, v, i, f, chunk)
    qc, kc, vc, yc, dyc = (_mlstm_chunks(t, chunk) for t in (q, k, v, y, dy))
    _, c = _mlstm_chunk_gates(i, f, chunk)
    big = torch.maximum(mst.double()[..., None], c.cummax(-1).values)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=q.device).tril()
    d = torch.where(causal, torch.exp((c[..., None, :] - big[..., None])
                                      .to(dt)), 0.0)
    e = torch.exp((mst.double()[..., None] - big).to(dt))   # [B,H,N,L]
    w = torch.exp((c - big[..., -1:]).to(dt))
    # prep
    qk = torch.einsum("bhntk,bhnsk->bhnts", qc, kc)
    den_p = e * torch.einsum("bhntk,bhnk->bhnt", qc, nst) + (qk * d).sum(-1)
    den = torch.clamp(den_p.abs(), min=1.0)
    g = -(dyc * yc).sum(-1) / den * torch.sign(den_p) * (den_p.abs() >= 1.0)
    dnum = dyc / den[..., None]
    lf = F.logsigmoid(f)
    sel = torch.empty_like(i)
    m = q.new_zeros((bsz, nh))
    for t in range(s):
        mf = lf[:, t] + m
        sel[:, t] = torch.where(mf > i[:, t], 1.0,
                                torch.where(mf < i[:, t], 0.0, 0.5))
        m = torch.maximum(mf, i[:, t])
    # reverse walk: the state gradient after each chunk
    nch = qc.shape[2]
    dcs = [q.new_zeros((bsz, nh, hd, hd))]
    dns = [q.new_zeros((bsz, nh, hd))]
    for j in reversed(range(1, nch)):
        ej = e[:, :, j, -1]
        dcs.append(ej[..., None, None] * dcs[-1] + torch.einsum(
            "bhtv,bhtk->bhvk", e[:, :, j, :, None] * dnum[:, :, j],
            qc[:, :, j]))
        dns.append(ej[..., None] * dns[-1] + torch.einsum(
            "bht,bhtk->bhk", e[:, :, j] * g[:, :, j], qc[:, :, j]))
    dcs, dns = torch.stack(dcs[::-1], 2), torch.stack(dns[::-1], 2)
    # chunks
    am = d * (torch.einsum("bhntv,bhnsv->bhnts", dnum, vc) + g[..., None])
    pm = d * qk
    dq = e[..., None] * (torch.einsum("bhnvk,bhntv->bhntk", cst, dnum)
                         + g[..., None] * nst[:, :, :, None]) + \
        torch.einsum("bhnts,bhnsk->bhntk", am, kc)
    dk = torch.einsum("bhnts,bhntk->bhnsk", am, qc) + w[..., None] * (
        torch.einsum("bhnvk,bhnsv->bhnsk", dcs, vc) + dns[:, :, :, None])
    dv = torch.einsum("bhnts,bhntv->bhnsv", pm, dnum) + \
        w[..., None] * torch.einsum("bhnvk,bhnsk->bhnsv", dcs, kc)
    dq, dk, dv = (_unchunk(t, s) for t in (dq, dk, dv))
    return (dq, dk, dv,
            *_mlstm_gate_grads((q * dq).sum(-1), (k * dk).sum(-1), sel, f))


def slstm_scan_trails_ref(pre: torch.Tensor, w_r: torch.Tensor,
                          bias: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """`slstm_scan_ref` keeping what its backward reads: (the h trail
    [B,S,H,hd], the gates' full pre-activations x + W h + bias
    [B,S,4,H,hd], and c, n, m after each step [B,S,H,hd]); f32 (f64 for f64
    inputs)."""
    bsz, s, _, nh, hd = pre.shape
    dt = _scan_dtype(pre)
    pre, w_r, bias = (t.to(dt) for t in (pre, w_r, bias))
    z = pre.new_zeros((bsz, nh, hd))
    carry = (z, z, z, z)
    p = torch.empty_like(pre)
    hs, cs, ns, ms = (pre.new_empty((bsz, s, nh, hd)) for _ in range(4))
    for t in range(s):
        p[:, t] = pre[:, t] + torch.einsum("khvw,bhw->bkhv", w_r,
                                           carry[2]) + bias[None]
        carry, hs[:, t] = slstm_step(carry, pre[:, t], w_r, bias)
        cs[:, t], ns[:, t], _, ms[:, t] = carry
    return hs, p, cs, ns, ms


def slstm_scan_dpre_ref(w_r: torch.Tensor, dy: torch.Tensor,
                        trails: tuple) -> torch.Tensor:
    """The sLSTM's reverse walk (the CPU path's; the backward kernel takes
    `slstm_scan_dpre_affine_ref`'s order of operations): the gradient of
    the gates' pre-activations dpre [B,S,4,H,hd] for the output gradient
    dy [B,S,H,hd], from the trails of
    `slstm_scan_trails_ref` (p, c, n, m; the h trail is not read). Each
    step recomputes its cell from p and the previous c, n, m as the
    forward does, then
      dh_t = dy_t + sum_g W_g^T dp_{g,t+1}
    back through h = sigmoid(o) c / max(n, 1), the c, n and m chains and
    the gates. dpre is also the gradient of x, and of the bias summed."""
    p, cs, ns, ms = trails
    bsz, s, _, nh, hd = p.shape
    dt = _scan_dtype(p)
    p, cs, ns, ms, w_r, dy = (t.to(dt) for t in (p, cs, ns, ms, w_r, dy))
    z = p.new_zeros((bsz, nh, hd))
    dc, dn, dm, rec = z, z, z, z
    dpre = torch.empty_like(p)
    for t in reversed(range(s)):
        pi, pf, pz, po = p[:, t].unbind(1)
        c0, n0, m0 = (cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]) if t \
            else (z, z, z)
        mf = F.logsigmoid(pf) + m0
        m_new = torch.maximum(mf, pi)
        i_p = torch.exp(pi - m_new)
        f_p = torch.exp(mf - m_new)
        tz = torch.tanh(pz)
        c = f_p * c0 + i_p * tz
        n = f_p * n0 + i_p
        sig = torch.sigmoid(po)
        nc = torch.clamp(n, min=1.0)
        dh = dy[:, t] + rec
        dc = dc + dh * sig / nc
        dn = dn - torch.where(n >= 1.0, dh * sig * c / (nc * nc), 0.0)
        dpo = dh * c / nc * sig * (1.0 - sig)
        dfp = dc * c0 + dn * n0
        dip = dc * tz + dn
        dpz = dc * i_p * (1.0 - tz * tz)
        rest = dm - dip * i_p - dfp * f_p
        sel = torch.where(mf > pi, 1.0, torch.where(mf < pi, 0.0, 0.5))
        dmf = dfp * f_p + sel * rest
        dpi = dip * i_p + (1.0 - sel) * rest
        dpf = dmf * torch.sigmoid(-pf)
        dc, dn, dm = dc * f_p, dn * f_p, dmf
        dp = torch.stack([dpi, dpf, dpz, dpo], dim=1)         # [B,4,H,hd]
        dpre[:, t] = dp
        rec = torch.einsum("khvw,bkhv->bhw", w_r, dp)
    return dpre


SLSTM_BLOCKS = 8      # kSCluster of csrc/xlstm_scan_bwd.cu: blocks a cluster


def slstm_scan_dpre_affine_ref(w_r: torch.Tensor, dy: torch.Tensor,
                               trails: tuple) -> torch.Tensor:
    """`slstm_scan_dpre_ref` in the order of operations of the backward
    kernel (csrc/xlstm_scan_bwd.cu): each step's cell backward as an
    affine map of (dh, dc, dn, dm) whose coefficients come from the
    trails alone (p; c, n, m of the step before and of the step itself,
    the forward's), and the recurrent sum sum_g W_g^T dp_g as
    SLSTM_BLOCKS partials, each over one block's rows of dp (hd /
    SLSTM_BLOCKS of them), added in rank order. Equals
    `slstm_scan_dpre_ref` up to rounding."""
    p, cs, ns, ms = trails
    bsz, s, _, nh, hd = p.shape
    dt = _scan_dtype(p)
    p, cs, ns, ms, w_r, dy = (t.to(dt) for t in (p, cs, ns, ms, w_r, dy))
    blocks = SLSTM_BLOCKS
    rb = hd // blocks
    z = p.new_zeros((bsz, nh, hd))
    dc, dn, dm, rec = z, z, z, z
    dpre = torch.empty_like(p)
    for t in reversed(range(s)):
        pi, pf, pz, po = p[:, t].unbind(1)
        c0, n0, m0 = (cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]) if t \
            else (z, z, z)
        c, n, m = cs[:, t], ns[:, t], ms[:, t]
        # the coefficients
        mf = F.logsigmoid(pf) + m0
        i_p, f_p = torch.exp(pi - m), torch.exp(mf - m)
        tz, sig = torch.tanh(pz), torch.sigmoid(po)
        rn = 1.0 / torch.clamp(n, min=1.0)
        sel = torch.where(mf > pi, 1.0, torch.where(mf < pi, 0.0, 0.5))
        a1 = sig * rn
        a2 = torch.where(n >= 1.0, -(a1 * c * rn), 0.0)
        a3 = c * rn * sig * (1.0 - sig)
        bz = i_p * (1.0 - tz * tz)
        g1 = (1.0 - sel) * f_p * c0 - sel * i_p * tz
        g2 = (1.0 - sel) * f_p * n0 - sel * i_p
        # the chain
        dh = dy[:, t] + rec
        x, y = dc + a1 * dh, dn + a2 * dh
        dmf = g1 * x + (g2 * y + sel * dm)
        dp = torch.stack([dm - dmf, torch.sigmoid(-pf) * dmf, bz * x,
                          a3 * dh], dim=1)                   # [B,4,H,hd]
        dc, dn, dm = f_p * x, f_p * y, dmf
        dpre[:, t] = dp
        parts = torch.einsum("khrvw,bkhrv->rbhw",
                             w_r.reshape(4, nh, blocks, rb, hd),
                             dp.reshape(bsz, 4, nh, blocks, rb))
        rec = parts[0]
        for part in parts[1:]:
            rec = rec + part
    return dpre


def slstm_grad_weights(dpre: torch.Tensor, h: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrent weights' and bias's gradients from dpre [B,S,4,H,hd]
    and the h trail [B,S,H,hd]: dW_g = sum_{b,t} dp_{g,t} h_{t-1}^T (h_{-1}
    = 0) and dbias = sum_{b,t} dp_t, in dpre's dtype."""
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return (torch.einsum("bskhv,bshw->khvw", dpre, h_prev.to(dpre.dtype)),
            dpre.sum((0, 1)))


def slstm_scan_bwd_ref(pre: torch.Tensor, w_r: torch.Tensor,
                       bias: torch.Tensor, dy: torch.Tensor,
                       trails: Optional[tuple] = None
                       ) -> tuple[torch.Tensor, ...]:
    """Plain sLSTM backward: the gradients (dpre, dw_r, dbias) of
    `slstm_scan_ref(pre, w_r, bias)` for the output gradient dy, f32 (f64
    for f64 inputs). `trails`: those of `slstm_scan_trails_ref` (h, p, c,
    n, m), recomputed when None. A max's gradient splits half to each side
    at a tie, a clamp's goes whole to its input, as autograd's."""
    if trails is None:
        trails = slstm_scan_trails_ref(pre, w_r, bias)
    dpre = slstm_scan_dpre_ref(w_r, dy, trails[1:])
    return (dpre, *slstm_grad_weights(dpre, trails[0]))
