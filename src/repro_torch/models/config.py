"""Model configuration shared by all 10 assigned architectures.

Copy of `repro/models/config.py` (same fields, same defaults, same
parameter counts) with `torch_dtype` in place of `jnp_dtype`. A config
fully describes one architecture: the block pattern (a period repeated
`repeats` times), attention flavor, MoE, SSM and frontend details.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch


@dataclass(frozen=True)
class BlockSpec:
    """One position inside the repeating layer pattern."""
    mixer: str = "attn"      # attn | attn_local | mamba | mlstm | slstm
    ffn: str = "mlp"         # mlp | moe | none  (xLSTM blocks carry no FFN)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # layer pattern: `pattern` repeated `repeats` times = all layers
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    repeats: int = 1
    head_dim: Optional[int] = None   # default: d_model // num_heads
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 4096       # for attn_local mixers
    attn_softcap: Optional[float] = None     # gemma2: 50.0
    logits_softcap: Optional[float] = None   # gemma2: 30.0
    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    capacity_factor: float = 1.25
    # SSM (mamba / xlstm)
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper: fixed 30 s of audio frames
    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    frontend_dim: int = 0            # dim of precomputed frame/patch embeds
    # misc
    post_norm: bool = False          # gemma2: extra norm after sublayers
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # sub-quadratic? (drives the long_500k skip policy)
    subquadratic: bool = False

    # ------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Approximate parameter count (for 6·N·D roofline checks)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # unembed
        per = {}
        for bs in self.pattern:
            if bs.mixer in ("attn", "attn_local"):
                a = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
                if self.qkv_bias:
                    a += (nq + 2 * nkv) * hd
            elif bs.mixer == "mamba":
                di = self.ssm_expand * d
                a = d * 2 * di + di * self.ssm_d_conv + \
                    di * (2 * self.ssm_d_state + 1) + di * d + di * self.ssm_d_state
            else:  # mlstm / slstm
                di = self.ssm_expand * d
                a = d * 4 * di + di * d
            if bs.ffn == "mlp":
                f = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
            elif bs.ffn == "moe":
                f = self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts
                f += self.num_shared_experts * 3 * d * self.moe_d_ff
            else:
                f = 0
            per[bs] = a + f
        n += sum(per[bs] for bs in self.pattern) * self.repeats
        if self.is_encoder_decoder:
            n += self.num_layers * 4 * d * d          # decoder cross-attn
            n += self.encoder_layers * (4 * d * d + 2 * d * self.d_ff)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed-to experts)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        moe_blocks = sum(1 for b in self.pattern if b.ffn == "moe") * self.repeats
        all_routed = moe_blocks * self.num_experts * 3 * d * self.moe_d_ff
        act_routed = moe_blocks * self.experts_per_tok * 3 * d * self.moe_d_ff
        return full - all_routed + act_routed

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str      # train | prefill | decode


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")
