"""Pattern-based decoder-only LM; counterpart of
`repro/models/transformer.py` for blocks with attention, local-attention,
Mamba, mLSTM or sLSTM mixers and MLP, MoE or no FFNs (the dense, MoE,
hybrid and xLSTM families).

Layers are `cfg.pattern` repeated `cfg.repeats` times, as in the JAX
package, but each layer is its own `Block` in an `nn.ModuleList`:
layer i is pattern position `i % len(pattern)` of repeat
`i // len(pattern)`. The JAX package stacks each position's leaves over
repeats for `lax.scan`; here that would mean one 8.9 GB expert tensor
per projection for qwen2-moe-a2.7b, so nothing is stacked.
The cache is one entry per layer: a KV cache for an attention layer, a
recurrent state for a Mamba, mLSTM or sLSTM layer.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import nn

from ..parallel.collectives import constrain
from .attention import Attention, Cache, init_kv_cache
from .config import BlockSpec, ModelConfig
from .layers import MLP, Embed, Norm
from .moe import MoE
from .ssm import (MLSTM, SLSTM, Mamba, init_mamba_state, init_mlstm_state,
                  init_slstm_state)

# mixer kind -> (module, its decode state's init; None: a KV cache)
_MIXERS = {"attn": (None, None), "attn_local": (None, None),
           "mamba": (Mamba, init_mamba_state),
           "mlstm": (MLSTM, init_mlstm_state),
           "slstm": (SLSTM, init_slstm_state)}


def _check_mixer(bspec: BlockSpec) -> None:
    if bspec.mixer not in _MIXERS:
        raise ValueError(f"unknown mixer {bspec.mixer!r}")


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, bspec: BlockSpec,
                 device: torch.device, gen: torch.Generator):
        super().__init__()
        _check_mixer(bspec)
        self.cfg = cfg
        self.ffn_kind = bspec.ffn
        self.norm_mixer = Norm(cfg, device)
        recurrent = _MIXERS[bspec.mixer][0]
        if recurrent is not None:
            self.mixer = recurrent(cfg, device, gen)
        else:
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
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it "
                             f"with models.encdec (registry.get_model does)")
        self.cfg = cfg
        self.embed = Embed(cfg, device, gen)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.pattern[i % len(cfg.pattern)], device, gen)
            for i in range(cfg.num_layers))
        self.final_norm = Norm(cfg, device)

    def forward(self, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens [B,S] (or `embeds` [B,S,d] from a modality frontend, used
        in place of the embedding lookup) -> (logits [B,S,V], MoE aux
        loss). Differentiable
        on both devices for every mixer: on CUDA through the backward
        kernels of flash attention, `moe_gemm`, the selective scan and the
        mLSTM and sLSTM scans (on the CPU autograd differentiates their
        plain versions). The prefill (`train_step.make_prefill_step`)
        is this forward under inference mode, as in the JAX package, where
        the prefill_32k cell lowers the same forward. The JAX forward
        rematerialises each period in the backward (`@jax.checkpoint`,
        transformer.py:110), which does not change the result; this one
        keeps every activation for autograd: about 11 GB for full-width qwen2-0.5b at B=4, S=2048
        (arithmetic), besides the logits and the loss's f32 copies."""
        x = embeds if embeds is not None else self.embed.embed(tokens)
        x = constrain(x, "dp", None, None)     # transformer.py:107,115
        aux = x.new_zeros((), dtype=torch.float32)
        for block in self.layers:
            x, a = block(x)
            x = constrain(x, "dp", None, None)
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
    """One entry per layer, by its pattern position: a KV cache
    [B, max_len, nkv, hd] for attention, the mixer's zero state for Mamba,
    mLSTM and sLSTM."""
    for bspec in cfg.pattern:
        _check_mixer(bspec)
    out = []
    for i in range(cfg.num_layers):
        init = _MIXERS[cfg.pattern[i % len(cfg.pattern)].mixer][1]
        out.append(init_kv_cache(cfg, batch, max_len, device) if init is None
                   else init(cfg, batch, device))
    return out
