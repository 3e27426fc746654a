"""Assigned-architecture configs (exact published dims) + tiny smoke
variants; copy of `repro/configs/__init__.py`. Select with --arch <id>."""
from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig, ShapeSpec, SHAPES, get_shape

from .whisper_base import CONFIG as whisper_base
from .qwen3_moe_235b import CONFIG as qwen3_moe_235b
from .qwen2_moe_a2_7b import CONFIG as qwen2_moe_a2_7b
from .qwen2_0_5b import CONFIG as qwen2_0_5b
from .qwen2_72b import CONFIG as qwen2_72b
from .minitron_4b import CONFIG as minitron_4b
from .gemma2_27b import CONFIG as gemma2_27b
from .chameleon_34b import CONFIG as chameleon_34b
from .jamba_52b import CONFIG as jamba_52b
from .xlstm_125m import CONFIG as xlstm_125m

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in [
    whisper_base, qwen3_moe_235b, qwen2_moe_a2_7b, qwen2_0_5b, qwen2_72b,
    minitron_4b, gemma2_27b, chameleon_34b, jamba_52b, xlstm_125m,
]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def tiny_config(name: str) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests: small width/depth,
    few experts, tiny vocab — structure (pattern, family, flags) intact."""
    cfg = get_config(name)
    over = dict(
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        repeats=min(cfg.repeats, 2),
        sliding_window=16,
        encoder_seq=24 if cfg.is_encoder_decoder else cfg.encoder_seq,
    )
    if cfg.num_experts:
        over.update(num_experts=8, experts_per_tok=min(cfg.experts_per_tok, 2),
                    moe_d_ff=32)
    if cfg.family in ("ssm", "hybrid"):
        over.update(ssm_d_state=8)
    if cfg.is_encoder_decoder:
        # keep a 2-layer encoder: encoder_layers is an explicit field
        over.update(encoder_layers=2)
    # xlstm: pattern positions stay, repeats shrink
    if len(cfg.pattern) > 4:
        over["pattern"] = cfg.pattern[:4]
    return cfg.scaled(**over)


__all__ = ["ARCHS", "get_config", "tiny_config", "ModelConfig",
           "ShapeSpec", "SHAPES", "get_shape"]
