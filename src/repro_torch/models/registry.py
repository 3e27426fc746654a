"""Uniform model API over the decoder-only family and the
encoder-decoder family, and `param_specs`, `cache_specs` and
`input_specs`: the stand-ins every dry-run cell runs against, built on
the `meta` device (shapes and dtypes, no allocation); counterpart of
`repro/models/registry.py`."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from . import encdec, transformer
from .config import ModelConfig, ShapeSpec


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


_META = torch.device("meta")


def param_specs(cfg: ModelConfig) -> nn.Module:
    """The model's parameters on the meta device (no allocation)."""
    return get_model(cfg, _META).init_params(None)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> List[Dict[str, torch.Tensor]]:
    """The decode cache (one dict a layer) on the meta device."""
    return get_model(cfg, _META).init_cache(batch, max_len)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Stand-ins for every model input of the given shape cell, on the
    meta device.

    train/prefill -> {tokens, labels [B,S] int32[, frames [B,T,d]]}
    decode        -> {tokens [B] int32, pos scalar int32, cache}
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {
            "tokens": torch.empty((b, s), dtype=i32, device=_META),
            "labels": torch.empty((b, s), dtype=i32, device=_META),
        }
        if cfg.is_encoder_decoder:
            specs["frames"] = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                                          dtype=cfg.torch_dtype,
                                          device=_META)
        return specs
    # decode: one new token against a seq_len cache
    return {
        "tokens": torch.empty((b,), dtype=i32, device=_META),
        "pos": torch.empty((), dtype=i32, device=_META),
        "cache": cache_specs(cfg, b, s),
    }
