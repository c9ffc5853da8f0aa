"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060].

16L, d_model=2048, 16 heads (MHA kv=16), per-expert d_ff=1024, vocab=50304.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,  # per expert
    vocab_size=50304,
    rope_theta=10000.0,
    n_experts=64,
    moe_top_k=8,
    sliding_window=8192,  # engages only past 65536 tokens (models/model.py)
    citation="arXiv:2409.02060",
)
