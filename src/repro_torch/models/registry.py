"""Uniform model API over the decoder-only family and the
encoder-decoder family; counterpart of `repro/models/registry.py`."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from . import encdec, transformer
from .config import ModelConfig


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable[[torch.Generator], nn.Module]
    forward: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[[int, int], List[Dict[str, torch.Tensor]]]


def get_model(cfg: ModelConfig, device: DeviceLike = "cuda") -> ModelAPI:
    """The model's functions on `device` (raises if CUDA is asked for and
    absent). `init_params` takes a `torch.Generator` on that device."""
    dev = resolve_device(device)
    if cfg.is_encoder_decoder:
        return ModelAPI(
            cfg=cfg, device=dev,
            init_params=lambda gen: encdec.EncoderDecoder(cfg, dev, gen),
            forward=lambda params, batch: params(
                batch["tokens"], frames=batch.get("frames")),
            decode_step=lambda params, cache, tokens, pos:
                params.decode_step(cache, tokens, pos),
            init_cache=lambda batch, max_len:
                encdec.init_cache(cfg, batch, max_len, dev),
        )

    def forward(params: transformer.Transformer, batch: Dict[str, Any]):
        return params(batch["tokens"], embeds=batch.get("embeds"))

    def decode_step(params: transformer.Transformer, cache, tokens, pos):
        return params.decode_step(cache, tokens, pos)

    return ModelAPI(
        cfg=cfg, device=dev,
        init_params=lambda gen: transformer.Transformer(cfg, dev, gen),
        forward=forward,
        decode_step=decode_step,
        init_cache=lambda batch, max_len:
            transformer.init_cache(cfg, batch, max_len, dev),
    )
