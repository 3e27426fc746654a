"""Whisper-style encoder-decoder; counterpart of `repro/models/encdec.py`.

The audio conv frontend is a stub, as in the JAX package: the encoder
takes precomputed frame embeddings [B, encoder_seq, d_model]. Positions
are sinusoidal, computed on the fly; no layer uses RoPE.

Each layer is its own module in an `nn.ModuleList` (`encoder.{i}`,
`decoder.{i}`), as `transformer.py` keeps its layers; the JAX package
stacks each leaf over layers with `jax.vmap` and `repro_torch.convert`
unstacks them. On CUDA the encoder's bidirectional self-attention (S ==
T, not causal) and the decoder's causal self-attention go through the
flash-attention kernels, forward and backward; cross-attention, whose
queries are the decoder's S tokens and whose keys are the encoder's
frames, and every decode call take the plain op, as in JAX
(`kernels/ops.py`).

The cache is one dict a decoder layer: the self-attention KV cache "k",
"v" [B, max_len, nkv, hd], written in place, and the cross-attention
K/V "cross_k", "cross_v" [B, encoder_seq, nkv, hd], which
`fill_cross_cache` replaces with the K/V of encoded frames.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import nn

from .attention import Attention, Cache, init_kv_cache
from .config import ModelConfig
from .layers import MLP, Embed, Norm


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions [N] -> [N, d] f32: sin over the first half, cos over the
    second, frequencies 10000^(-i / (d/2 - 1))."""
    half = d // 2
    step = torch.log(torch.tensor(10000.0, device=positions.device)) \
        / (half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * step)
    ang = positions.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: torch.Generator):
        super().__init__()
        self.norm1 = Norm(cfg, device)
        self.attn = Attention(cfg, device, gen)
        self.norm2 = Norm(cfg, device)
        self.mlp = MLP(cfg, device, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), use_rope=False, causal=False)
        return x + self.mlp(self.norm2(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: torch.Generator):
        super().__init__()
        self.norm1 = Norm(cfg, device)
        self.self_attn = Attention(cfg, device, gen)
        self.norm2 = Norm(cfg, device)
        self.cross_attn = Attention(cfg, device, gen)
        self.norm3 = Norm(cfg, device)
        self.mlp = MLP(cfg, device, gen)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), use_rope=False)
        x = x + self.cross_attn(self.norm2(x), use_rope=False, memory=memory)
        return x + self.mlp(self.norm3(x))

    def decode(self, x: torch.Tensor, cache: Cache,
               pos: Union[int, torch.Tensor]) -> torch.Tensor:
        x = x + self.self_attn.decode(self.norm1(x), cache, pos,
                                      use_rope=False)
        x = x + self.cross_attn.decode(
            self.norm2(x), cache, pos,
            memory_kv={"k": cache["cross_k"], "v": cache["cross_v"]})
        return x + self.mlp(self.norm3(x))


class EncoderDecoder(nn.Module):
    """The parameters and the paths: `encode`, `forward` (teacher forcing
    over encoder memory), `fill_cross_cache` and `decode_step`."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: torch.Generator):
        super().__init__()
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        self.embed = Embed(cfg, device, gen)
        self.encoder = nn.ModuleList(EncoderLayer(cfg, device, gen)
                                     for _ in range(cfg.encoder_layers))
        self.enc_final_norm = Norm(cfg, device)
        self.decoder = nn.ModuleList(DecoderLayer(cfg, device, gen)
                                     for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg, device)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, T, d] (the stub frontend's output) -> memory
        [B, T, d]."""
        pos = torch.arange(frames.shape[1], device=frames.device)
        x = frames + sinusoidal(pos, self.cfg.d_model)[None].to(frames.dtype)
        for layer in self.encoder:
            x = layer(x)
        return self.enc_final_norm(x)

    def forward(self, tokens: torch.Tensor,
                frames: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens [B,S], frames [B,T,d] (zeros [B, encoder_seq, d] when
        not given) -> (logits [B,S,V], aux = 0)."""
        b, s = tokens.shape
        if frames is None:
            frames = torch.zeros((b, self.cfg.encoder_seq, self.cfg.d_model),
                                 dtype=self.cfg.torch_dtype,
                                 device=tokens.device)
        memory = self.encode(frames)
        x = self.embed.embed(tokens)
        pos = torch.arange(s, device=tokens.device)
        x = x + sinusoidal(pos, self.cfg.d_model)[None].to(x.dtype)
        for layer in self.decoder:
            x = layer(x, memory)
        logits = self.embed.logits(self.final_norm(x))
        return logits, logits.new_zeros((), dtype=torch.float32)

    def fill_cross_cache(self, cache: List[Cache],
                         frames: torch.Tensor) -> List[Cache]:
        """Run the encoder once over `frames` and put every decoder
        layer's cross-attention K/V into `cache`."""
        memory = self.encode(frames)
        for layer, c in zip(self.decoder, cache):
            kv = layer.cross_attn.precompute_cross_kv(memory)
            c["cross_k"], c["cross_v"] = kv["k"], kv["v"]
        return cache

    def decode_step(self, cache: List[Cache], tokens: torch.Tensor,
                    pos: Union[int, torch.Tensor]
                    ) -> tuple[torch.Tensor, List[Cache]]:
        """tokens [B]; pos scalar or per-slot [B]. Returns (logits [B,V],
        cache), the self-attention caches updated in place."""
        b = tokens.shape[0]
        x = self.embed.embed(tokens[:, None])
        pos_b = torch.as_tensor(pos, device=tokens.device).expand(b)
        x = x + sinusoidal(pos_b, self.cfg.d_model)[:, None].to(x.dtype)
        for layer, c in zip(self.decoder, cache):
            x = layer.decode(x, c, pos)
        return self.embed.logits(self.final_norm(x))[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> List[Cache]:
    """One dict a decoder layer: self-attention "k", "v" [B, max_len, nkv,
    hd] and cross-attention "cross_k", "cross_v" [B, encoder_seq, nkv, hd],
    all zeros."""
    shape = (batch, cfg.encoder_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return [{**init_kv_cache(cfg, batch, max_len, device),
             "cross_k": torch.zeros(shape, dtype=cfg.torch_dtype,
                                    device=device),
             "cross_v": torch.zeros(shape, dtype=cfg.torch_dtype,
                                    device=device)}
            for _ in range(cfg.num_layers)]
