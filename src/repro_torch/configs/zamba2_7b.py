"""Zamba2-7B — Mamba2 backbone + a shared attention block [arXiv:2411.15242].

81 Mamba2 layers, d_model=3584, ssm_state=64; one SHARED attention + SwiGLU
block (32 heads MHA of 112, d_ff=14336) is applied after every 6th Mamba2
layer, its weights reused at every application.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,  # 32 * 112 = 3584
    d_ff=14336,
    vocab_size=32000,
    rope_theta=10000.0,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    sliding_window=8192,  # engages only past 65536 tokens (models/model.py)
    fsdp=True,  # the reference's: weights shard over the data axis too
    citation="arXiv:2411.15242",
)
