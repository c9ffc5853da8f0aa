"""StarCoder2-3B — GQA + RoPE code model [arXiv:2402.19173].

30L, d_model=3072, 24 heads (GQA kv=2), d_ff=12288, vocab=49152;
LayerNorm with biases and a non-gated gelu MLP (c_fc/c_proj with biases).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=999999.0,
    norm="layernorm",
    mlp="gelu",
    sliding_window=4096,  # engages only past 65536 tokens (models/model.py)
    citation="arXiv:2402.19173",
)
