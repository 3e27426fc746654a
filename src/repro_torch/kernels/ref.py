"""Plain PyTorch versions of the kernels: the numerical contract.

Counterpart of `repro/kernels/ref.py`. Each hand-written kernel is held
against its function here (the CPU tests against the JAX oracles, and
`chip_smoke.py` on the card). Products take f32 operands built from the
inputs' own values (bf16 products are exact in f32), so the accumulation
is f32 as with JAX's ``preferred_element_type=jnp.float32``.
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


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped (per-expert) matmul: x [E,C,d] @ w [E,d,f] -> [E,C,f],
    accumulating in f32, output in x's dtype."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)
