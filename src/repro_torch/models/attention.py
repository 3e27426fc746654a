"""Grouped-query attention: QKV projections with optional bias (Qwen2),
sliding-window local attention and logit softcapping (Gemma-2), RoPE;
counterpart of `repro/models/attention.py` for the decoder-only archs.

The inner attention math goes through `repro_torch.kernels.ops.attention`
with the structured causal/window/kv_len arguments of the JAX package.
Decode updates the KV cache in place (the JAX version returns a new one):
the engine keeps one cache for its whole life.
"""
from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import apply_rope, const_param, normal_param, rope_cos_sin

Cache = Dict[str, torch.Tensor]


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: torch.Generator, local: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nq, nkv = cfg.num_heads, cfg.num_kv_heads
        dt = cfg.torch_dtype
        s = (1.0 / d) ** 0.5
        self.cfg = cfg
        self.local = local
        self.wq = normal_param((d, nq * hd), s, dt, device, gen)
        self.wk = normal_param((d, nkv * hd), s, dt, device, gen)
        self.wv = normal_param((d, nkv * hd), s, dt, device, gen)
        self.wo = normal_param((nq * hd, d), s, dt, device, gen)
        if cfg.qkv_bias:
            self.bq = const_param((nq * hd,), 0.0, dt, device)
            self.bk = const_param((nkv * hd,), 0.0, dt, device)
            self.bv = const_param((nkv * hd,), 0.0, dt, device)

    @property
    def window(self):
        return self.cfg.sliding_window if self.local else None

    def _project_q(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        q = x @ self.wq
        if self.cfg.qkv_bias:
            q = q + self.bq
        return q.reshape(b, s, self.cfg.num_heads, self.cfg.resolved_head_dim)

    def _project_kv(self, x: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        b, s, _ = x.shape
        k = x @ self.wk
        v = x @ self.wv
        if self.cfg.qkv_bias:
            k = k + self.bk
            v = v + self.bv
        shape = (b, s, self.cfg.num_kv_heads, self.cfg.resolved_head_dim)
        return k.reshape(shape), v.reshape(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal self-attention (attention_train). On CUDA
        the attention goes through the flash-attention kernels, forward
        and backward; q, k, v come out of the RoPE concat contiguous, as
        the kernels read them through strides with a contiguous head
        dim."""
        b, s, _ = x.shape
        q = self._project_q(x)
        k, v = self._project_kv(x)
        cos, sin = rope_cos_sin(torch.arange(s, device=x.device),
                                self.cfg.resolved_head_dim,
                                self.cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = kops.attention(q, k, v, causal=True, window=self.window,
                           softcap=self.cfg.attn_softcap)
        return o.reshape(b, s, -1) @ self.wo

    def decode(self, x: torch.Tensor, cache: Cache,
               pos: Union[int, torch.Tensor]) -> torch.Tensor:
        """One-token decode. x [B,1,d]; cache k/v [B,L,nkv,hd], written in
        place at `pos`; pos a scalar (int or 0-d tensor) or per-slot [B]."""
        b = x.shape[0]
        q = self._project_q(x)                           # [B,1,nq,hd]
        kn, vn = self._project_kv(x)                     # [B,1,nkv,hd]
        pos_t = torch.as_tensor(pos, device=x.device)
        pos_b = pos_t.expand(b) if pos_t.ndim == 0 else pos_t
        cos, sin = rope_cos_sin(pos_b[:, None], self.cfg.resolved_head_dim,
                                self.cfg.rope_theta)     # [B,1,hd/2]
        q = apply_rope(q, cos, sin)
        kn = apply_rope(kn, cos, sin)
        k, v = cache["k"], cache["v"]
        if pos_t.ndim == 0:
            k[:, pos_t] = kn[:, 0].to(k.dtype)
            v[:, pos_t] = vn[:, 0].to(v.dtype)
        else:                                            # per-slot positions
            rows = torch.arange(b, device=x.device)
            k[rows, pos_b] = kn[:, 0].to(k.dtype)
            v[rows, pos_b] = vn[:, 0].to(v.dtype)
        o = kops.attention(q, k, v, kv_len=pos_b + 1, window=self.window,
                           softcap=self.cfg.attn_softcap)
        return o.reshape(b, 1, -1) @ self.wo


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device) -> Cache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}
