"""jamba-v0.1-52b [hybrid]: 32L, period-8 blocks (1 attention : 7 Mamba,
attention at position 4), MoE (16 experts top-2) every second layer,
d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=65536. Sub-quadratic
(mamba layers) -> runs long_500k. [arXiv:2403.19887]"""
from ..models.config import BlockSpec, ModelConfig

_PERIOD = tuple(
    BlockSpec(mixer="attn" if i == 4 else "mamba",
              ffn="moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    d_model=4096, num_heads=32, num_kv_heads=8, d_ff=14336,
    vocab_size=65536,
    pattern=_PERIOD, repeats=4,
    num_experts=16, experts_per_tok=2, moe_d_ff=14336,
    ssm_d_state=16, ssm_d_conv=4, ssm_expand=2,
    subquadratic=True,
)
