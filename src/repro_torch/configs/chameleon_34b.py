"""chameleon-34b [vlm]: 48L, d_model=8192, 64H (GQA kv=8), d_ff=22016,
vocab=65536 (early fusion: VQ image tokens live in the same vocab; the
image tokenizer frontend is a STUB — the backbone consumes tokens).
[arXiv:2405.09818]"""
from ..models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    d_model=8192, num_heads=64, num_kv_heads=8, d_ff=22016,
    vocab_size=65536,
    pattern=(BlockSpec(mixer="attn", ffn="mlp"),), repeats=48,
    frontend="vision",
)
