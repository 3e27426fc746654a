"""qwen3-moe-235b-a22b [moe]: 94L, d_model=4096, 64H (GQA kv=4),
head_dim=128, MoE 128 experts top-8, expert d_ff=1536, vocab=151936.
[hf:Qwen/Qwen3 family]"""
from ..models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    pattern=(BlockSpec(mixer="attn", ffn="moe"),), repeats=94,
    num_experts=128, experts_per_tok=8, moe_d_ff=1536,
    rope_theta=1_000_000.0,
)
