"""minitron-4b [dense]: 32L, d_model=3072, 24H (GQA kv=8), head_dim=128,
d_ff=9216, vocab=256000 (pruned Nemotron). [arXiv:2407.14679]"""
from ..models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256000,
    pattern=(BlockSpec(mixer="attn", ffn="mlp"),), repeats=32,
)
