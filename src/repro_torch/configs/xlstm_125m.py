"""xlstm-125m [ssm]: 12 blocks, d_model=768, 4H (head_dim=192),
vocab=50304, no separate FFN (d_ff=0: xLSTM blocks carry their own
projections). sLSTM at positions 1, 5, 9; mLSTM elsewhere.
Sub-quadratic -> runs long_500k. [arXiv:2405.04517]"""
from ..models.config import BlockSpec, ModelConfig

_PERIOD = (BlockSpec(mixer="mlstm", ffn="none"),
           BlockSpec(mixer="slstm", ffn="none"),
           BlockSpec(mixer="mlstm", ffn="none"),
           BlockSpec(mixer="mlstm", ffn="none"))

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    d_model=768, num_heads=4, num_kv_heads=4, head_dim=192, d_ff=0,
    vocab_size=50304,
    pattern=_PERIOD, repeats=3,
    tie_embeddings=True,
    subquadratic=True,
)
