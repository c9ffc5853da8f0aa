"""InternVL2-Llama3-76B — InternViT + LLM backbone VLM [arXiv:2404.16821].

Backbone: 80L, d_model=8192, 64 heads (GQA kv=8), d_ff=28672, vocab=128256.
The vision frontend (InternViT-6B, output width 3200) is not run:
precomputed patch embeddings feed the projector, as in the reference.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,  # llama3 backbone
    d_frontend=3200,  # InternViT-6B embedding width
    frontend_tokens=256,  # visual tokens per frame after pixel-shuffle
    sliding_window=8192,  # engages only past 65536 tokens (models/model.py)
    citation="arXiv:2404.16821",
)
