"""Shared layers: norms, RoPE, MLPs, embeddings; counterpart of
`repro/models/layers.py`.

Parameters live in `nn.Module`s whose attribute names are the JAX leaf
names, so `repro_torch.convert` maps the JAX pytree onto `state_dict()`
keys one to one. Weights keep the JAX layout (`x @ w`, w [d_in, d_out]).
Random init draws from an explicit `torch.Generator` on the target device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import constrain
from .config import ModelConfig


def normal_param(shape: Sequence[int], scale: float, dtype: torch.dtype,
                 device: torch.device, gen: torch.Generator) -> nn.Parameter:
    """N(0, scale^2) drawn in `dtype` on `device` (no f32 temporary)."""
    t = torch.randn(tuple(shape), generator=gen, dtype=dtype, device=device)
    return nn.Parameter(t.mul_(scale))


def const_param(shape: Sequence[int], value: float, dtype: torch.dtype,
                device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.full(tuple(shape), value, dtype=dtype,
                                   device=device))


# ---------------------------------------------------------------- norms
class Norm(nn.Module):
    """rmsnorm or layernorm, computed in f32, output in x's dtype."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 d: Optional[int] = None):
        super().__init__()
        d = d or cfg.d_model
        self.layernorm = cfg.norm == "layernorm"
        self.scale = const_param((d,), 1.0, cfg.torch_dtype, device)
        if self.layernorm:
            self.bias = const_param((d,), 0.0, cfg.torch_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.layernorm:
            mu = xf.mean(-1, keepdim=True)
            var = ((xf - mu) ** 2).mean(-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + 1e-6)
            y = y * self.scale.float() + self.bias.float()
        else:
            ms = (xf * xf).mean(-1, keepdim=True)
            y = xf * torch.rsqrt(ms + 1e-6) * self.scale.float()
        return y.to(x.dtype)


# ---------------------------------------------------------------- rope
def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...] int -> cos/sin [..., head_dim/2] f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., n_heads, head_dim]; cos/sin broadcastable [..., hd/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :]          # broadcast over heads
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------- mlp
class MLP(nn.Module):
    """Gated-silu MLP (w_gate, w_up, w_down) or gelu MLP with biases."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: torch.Generator, d_ff: Optional[int] = None,
                 d_in: Optional[int] = None):
        super().__init__()
        d = d_in or cfg.d_model
        f = d_ff or cfg.d_ff
        dt = cfg.torch_dtype
        s_in = (2.0 / (d + f)) ** 0.5
        self.gated = cfg.act == "silu"
        if self.gated:
            self.w_gate = normal_param((d, f), s_in, dt, device, gen)
            self.w_up = normal_param((d, f), s_in, dt, device, gen)
            self.w_down = normal_param((f, d), s_in, dt, device, gen)
        else:
            self.w_up = normal_param((d, f), s_in, dt, device, gen)
            self.b_up = const_param((f,), 0.0, dt, device)
            self.w_down = normal_param((f, d), s_in, dt, device, gen)
            self.b_down = const_param((d,), 0.0, dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the JAX file's constraints (layers.py:81-84)
        nd = x.ndim
        mid = ("dp",) + (None,) * (nd - 2) + ("model",)
        out = ("dp",) + (None,) * (nd - 1)
        if self.gated:
            h = constrain(F.silu(x @ self.w_gate) * (x @ self.w_up), *mid)
            return constrain(h @ self.w_down, *out)
        h = constrain(F.gelu(x @ self.w_up + self.b_up, approximate="tanh"),
                      *mid)
        return constrain(h @ self.w_down + self.b_down, *out)


# ---------------------------------------------------------------- embed
def padded_vocab(cfg: ModelConfig, multiple: int = 256) -> int:
    """Vocab padded to a multiple of 256, as in the JAX package (there it
    lets the table shard on any mesh axis; here it keeps shapes equal)."""
    v = cfg.vocab_size
    return ((v + multiple - 1) // multiple) * multiple


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: torch.Generator):
        super().__init__()
        v = padded_vocab(cfg)
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.embedding = normal_param((v, cfg.d_model), 0.02, dt, device, gen)
        if not cfg.tie_embeddings:
            self.unembed = normal_param((cfg.d_model, v), 0.02, dt, device,
                                        gen)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embedding[tokens.long()]
        if self.cfg.name.startswith("gemma2"):
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            out = x @ self.embedding.T
        else:
            out = x @ self.unembed
        return softcap(out, self.cfg.logits_softcap)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
