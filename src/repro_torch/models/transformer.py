"""Pattern-based decoder-only LM; counterpart of
`repro/models/transformer.py` for blocks with attention mixers and MLP or
MoE FFNs (the dense and MoE families).

Layers are `cfg.pattern` repeated `cfg.repeats` times, as in the JAX
package, but each layer is its own `Block` in an `nn.ModuleList`:
layer i is pattern position `i % len(pattern)` of repeat
`i // len(pattern)`. The JAX package stacks each position's leaves over
repeats for `lax.scan`; here that would mean one 8.9 GB expert tensor
per projection for qwen2-moe-a2.7b, so nothing is stacked.
Mamba and xLSTM mixers are still to be ported and raise.
"""
from __future__ import annotations

from typing import List, Union

import torch
from torch import nn

from .attention import Attention, Cache, init_kv_cache
from .config import BlockSpec, ModelConfig
from .layers import MLP, Embed, Norm
from .moe import MoE


def _check_mixer(bspec: BlockSpec) -> None:
    if bspec.mixer not in ("attn", "attn_local"):
        raise NotImplementedError(f"{bspec.mixer} mixer not ported yet")


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, bspec: BlockSpec,
                 device: torch.device, gen: torch.Generator):
        super().__init__()
        _check_mixer(bspec)
        self.cfg = cfg
        self.ffn_kind = bspec.ffn
        self.norm_mixer = Norm(cfg, device)
        self.mixer = Attention(cfg, device, gen,
                               local=bspec.mixer == "attn_local")
        if cfg.post_norm:
            self.post_norm_mixer = Norm(cfg, device)
        if bspec.ffn == "mlp":
            self.norm_ffn = Norm(cfg, device)
            self.ffn = MLP(cfg, device, gen)
        elif bspec.ffn == "moe":
            self.norm_ffn = Norm(cfg, device)
            self.ffn = MoE(cfg, device, gen)
        if cfg.post_norm and bspec.ffn != "none":
            self.post_norm_ffn = Norm(cfg, device)

    def _ffn(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = self.norm_ffn(x)
        if self.ffn_kind == "moe":
            h, aux = self.ffn(h)
        else:
            h, aux = self.ffn(h), x.new_zeros((), dtype=torch.float32)
        if self.cfg.post_norm:
            h = self.post_norm_ffn(h)
        return x + h, aux

    def _mixed(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.post_norm:
            h = self.post_norm_mixer(h)
        return x + h

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self._mixed(x, self.mixer(self.norm_mixer(x)))
        if self.ffn_kind == "none":
            return x, x.new_zeros((), dtype=torch.float32)
        return self._ffn(x)

    def decode(self, x: torch.Tensor, cache: Cache,
               pos: Union[int, torch.Tensor]) -> torch.Tensor:
        x = self._mixed(x, self.mixer.decode(self.norm_mixer(x), cache, pos))
        if self.ffn_kind == "none":
            return x
        return self._ffn(x)[0]


class Transformer(nn.Module):
    """The parameters and the two paths: `forward` (teacher forcing over
    a sequence) and `decode_step` (one token per batch row)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: torch.Generator):
        super().__init__()
        if cfg.is_encoder_decoder:
            raise NotImplementedError("encoder-decoder models not ported yet")
        self.cfg = cfg
        self.embed = Embed(cfg, device, gen)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.pattern[i % len(cfg.pattern)], device, gen)
            for i in range(cfg.num_layers))
        self.final_norm = Norm(cfg, device)

    def forward(self, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens [B,S] -> (logits [B,S,V], MoE aux loss), differentiable
        on CUDA and on the CPU. The JAX forward rematerialises each period
        in the backward (`@jax.checkpoint`, transformer.py:110), which
        does not change the result; this one keeps every activation for
        autograd: about 11 GB for full-width qwen2-0.5b at B=4, S=2048
        (arithmetic), besides the logits and the loss's f32 copies."""
        x = self.embed.embed(tokens)
        aux = x.new_zeros((), dtype=torch.float32)
        for block in self.layers:
            x, a = block(x)
            aux = aux + a
        return self.embed.logits(self.final_norm(x)), aux

    def decode_step(self, cache: List[Cache], tokens: torch.Tensor,
                    pos: Union[int, torch.Tensor]
                    ) -> tuple[torch.Tensor, List[Cache]]:
        """tokens [B]; pos scalar or per-slot [B]. Returns (logits [B,V],
        cache), the cache updated in place."""
        x = self.embed.embed(tokens[:, None])
        for block, c in zip(self.layers, cache):
            x = block.decode(x, c, pos)
        return self.embed.logits(self.final_norm(x))[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> List[Cache]:
    """One KV cache per layer, [B, max_len, nkv, hd] each."""
    for bspec in cfg.pattern:
        _check_mixer(bspec)
    return [init_kv_cache(cfg, batch, max_len, device)
            for _ in range(cfg.num_layers)]
