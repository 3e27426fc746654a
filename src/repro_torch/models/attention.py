"""Grouped-query attention: QKV projections with optional bias (Qwen2),
sliding-window local attention and logit softcapping (Gemma-2),
cross-attention and bidirectional self-attention (Whisper), RoPE or
none; counterpart of `repro/models/attention.py`.

The inner attention math goes through `repro_torch.kernels.ops.attention`
with the structured causal/window/kv_len arguments of the JAX package,
and so routes as it does: self-attention over a whole sequence (S == T,
causal or not) to the flash kernels on CUDA, cross-attention (K/V from
`memory`, S != T in general) and decode to the plain op.
Decode updates the KV cache in place (the JAX version returns a new one):
the engine keeps one cache for its whole life. The `constrain` calls are
the JAX file's sharding constraints (attention.py:48,57,58,87,112): the
identity unless the dry-run's mesh is in scope.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from ..kernels import ops as kops
from ..parallel.collectives import constrain
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
        q = constrain(x @ self.wq, "dp", None, "model")
        if self.cfg.qkv_bias:
            q = q + self.bq
        return q.reshape(b, s, self.cfg.num_heads, self.cfg.resolved_head_dim)

    def _project_kv(self, x: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        b, s, _ = x.shape
        k = constrain(x @ self.wk, "dp", None, "model")
        v = constrain(x @ self.wv, "dp", None, "model")
        if self.cfg.qkv_bias:
            k = k + self.bk
            v = v + self.bv
        shape = (b, s, self.cfg.num_kv_heads, self.cfg.resolved_head_dim)
        return k.reshape(shape), v.reshape(shape)

    def forward(self, x: torch.Tensor, *, use_rope: bool = True,
                causal: bool = True,
                memory: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence attention (attention_train). `memory` [B,T,d]
        given: cross-attention, K/V from `memory`, no mask and no RoPE.
        `causal=False` and no `memory`: bidirectional self-attention (the
        Whisper encoder). The window applies only to a causal local layer.
        On CUDA a self-attention call goes through the flash-attention
        kernels, forward and backward; q, k, v come out of the RoPE concat
        contiguous, as the kernels read them through strides with a
        contiguous head dim."""
        b, s, _ = x.shape
        q = self._project_q(x)
        k, v = self._project_kv(x if memory is None else memory)
        if memory is None and use_rope:
            cos, sin = rope_cos_sin(torch.arange(s, device=x.device),
                                    self.cfg.resolved_head_dim,
                                    self.cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        is_causal = causal and memory is None
        o = kops.attention(q, k, v, causal=is_causal,
                           window=self.window if is_causal else None,
                           softcap=self.cfg.attn_softcap)
        return constrain(o.reshape(b, s, -1) @ self.wo, "dp", None, None)

    def decode(self, x: torch.Tensor, cache: Cache,
               pos: Union[int, torch.Tensor], *, use_rope: bool = True,
               memory_kv: Optional[Cache] = None) -> torch.Tensor:
        """One-token decode. x [B,1,d]; cache k/v [B,L,nkv,hd], written in
        place at `pos`; pos a scalar (int or 0-d tensor) or per-slot [B].
        `memory_kv` {"k", "v"} given: cross-attention against the
        precomputed encoder K/V, the cache left as it is."""
        b = x.shape[0]
        q = self._project_q(x)                           # [B,1,nq,hd]
        # replicated on the model axis: the cache is context-parallel
        q = constrain(q, "dp", None, None, None)
        if memory_kv is not None:
            o = kops.attention(q, memory_kv["k"], memory_kv["v"],
                               softcap=self.cfg.attn_softcap)
            return o.reshape(b, 1, -1) @ self.wo
        kn, vn = self._project_kv(x)                     # [B,1,nkv,hd]
        pos_t = torch.as_tensor(pos, device=x.device)
        pos_b = pos_t.expand(b) if pos_t.ndim == 0 else pos_t
        if use_rope:
            cos, sin = rope_cos_sin(pos_b[:, None],
                                    self.cfg.resolved_head_dim,
                                    self.cfg.rope_theta)  # [B,1,hd/2]
            q = apply_rope(q, cos, sin)
            kn = apply_rope(kn, cos, sin)
        k, v = cache["k"], cache["v"]
        # A position past the cache writes its last row, as the reference's
        # dynamic_update_slice clamps its start index, while RoPE and
        # kv_len keep the true position. That is parity with the JAX
        # package, not a claim that overwriting the last row is right.
        last = k.shape[1] - 1
        if pos_t.ndim == 0:
            row = pos_t.clamp(max=last)
            k[:, row] = kn[:, 0].to(k.dtype)
            v[:, row] = vn[:, 0].to(v.dtype)
        else:                                            # per-slot positions
            rows = torch.arange(b, device=x.device)
            row = pos_b.clamp(max=last)
            k[rows, row] = kn[:, 0].to(k.dtype)
            v[rows, row] = vn[:, 0].to(v.dtype)
        o = kops.attention(q, k, v, kv_len=pos_b + 1, window=self.window,
                           softcap=self.cfg.attn_softcap)
        return o.reshape(b, 1, -1) @ self.wo

    def precompute_cross_kv(self, memory: torch.Tensor) -> Cache:
        """This cross-attention layer's K/V [B,T,nkv,hd] over the encoder
        output `memory` [B,T,d], for `decode(memory_kv=...)`."""
        k, v = self._project_kv(memory)
        return {"k": k, "v": v}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device) -> Cache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}
