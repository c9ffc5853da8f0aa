"""xLSTM-125M — sLSTM + mLSTM blocks [arXiv:2405.04517].

12 blocks, d_model=768, 4 heads, vocab=50304; d_ff=0 (the blocks carry
their own up/down projections). sLSTM at blocks 3 and 9, mLSTM elsewhere.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    rope_theta=None,
    slstm_layers=(3, 9),
    citation="arXiv:2405.04517",
)
