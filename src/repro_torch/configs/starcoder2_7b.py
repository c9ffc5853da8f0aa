"""StarCoder2-7B — GQA + RoPE code model [arXiv:2402.19173].

32L, d_model=4608, 36 heads (GQA kv=4), d_ff=18432, vocab=49152;
LayerNorm with biases and a non-gated gelu MLP (c_fc/c_proj with biases).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    arch_type="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    rope_theta=1000000.0,
    norm="layernorm",
    mlp="gelu",
    sliding_window=4096,  # engages only past 65536 tokens (models/model.py)
    fsdp=True,  # the reference's: weights shard over the data axis too
    citation="arXiv:2402.19173",
)
