"""TinyLlama-1.1B — llama2-architecture small model [arXiv:2401.02385].

22L, d_model=2048, 32 heads (GQA kv=4), d_ff=5632, vocab=32000.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=10000.0,
    sliding_window=8192,  # engages only past 65536 tokens (models/model.py)
    citation="arXiv:2401.02385",
)
