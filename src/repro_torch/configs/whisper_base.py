"""whisper-base [audio]: 6L enc + 6L dec, d_model=512, 8H (kv=8),
d_ff=2048, vocab=51865. Enc-dec; conv audio frontend is a STUB —
input_specs provides precomputed frame embeddings. [arXiv:2212.04356]"""
from ..models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    d_model=512, num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=51865,
    pattern=(BlockSpec(mixer="attn", ffn="mlp"),), repeats=6,
    encoder_layers=6, encoder_seq=1500,
    frontend="audio", frontend_dim=512,
    qkv_bias=True, norm="layernorm", act="gelu", tie_embeddings=True,
)
