"""qwen2-72b [dense]: 80L, d_model=8192, 64H (GQA kv=8), d_ff=29568,
vocab=152064, QKV bias. [arXiv:2407.10671]"""
from ..models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    d_model=8192, num_heads=64, num_kv_heads=8, d_ff=29568,
    vocab_size=152064,
    pattern=(BlockSpec(mixer="attn", ffn="mlp"),), repeats=80,
    qkv_bias=True, rope_theta=1_000_000.0,
)
