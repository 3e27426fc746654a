"""qwen2-moe-a2.7b [moe]: 24L, d_model=2048, 16H (kv=16), expert
d_ff=1408, 60 routed top-4 + 4 shared experts, vocab=151936.
60 experts don't divide a 16-way EP axis: routed experts pad to 64 with
router-logit masking (semantics unchanged). [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from ..models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    d_model=2048, num_heads=16, num_kv_heads=16, d_ff=1408,
    vocab_size=151936,
    pattern=(BlockSpec(mixer="attn", ffn="moe"),), repeats=24,
    num_experts=60, experts_per_tok=4, num_shared_experts=4, moe_d_ff=1408,
    qkv_bias=True,
)
