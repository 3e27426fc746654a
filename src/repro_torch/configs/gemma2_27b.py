"""gemma2-27b [dense]: 46L alternating local(4096-window)/global
attention, d_model=4608, 32H (GQA kv=16), head_dim=128, d_ff=36864,
vocab=256000, attn softcap 50, logit softcap 30, pre+post norms, tied
embeddings. [arXiv:2408.00118]"""
from ..models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    pattern=(BlockSpec(mixer="attn_local", ffn="mlp"),
             BlockSpec(mixer="attn", ffn="mlp")),
    repeats=23,
    sliding_window=4096, attn_softcap=50.0, logits_softcap=30.0,
    post_norm=True, tie_embeddings=True, act="silu",  # gemma2 uses gated-GELU; silu-gated is the TPU-matmul-equivalent stand-in
)
