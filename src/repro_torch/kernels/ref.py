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
The SSM scan oracles are ported with their kernels (ROADMAP, Queue 2).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

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


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped (per-expert) matmul: x [E,C,d] @ w [E,d,f] -> [E,C,f],
    accumulating in f32, output in x's dtype."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)
