"""Llama-4-Scout-17B-16E — MoE with early fusion [hf:meta-llama/Llama-4-Scout-17B-16E].

48L, d_model=5120, 40 heads (GQA kv=8), per-expert d_ff=8192, vocab=202048.
16 routed experts top-1 + an always-on shared expert. Early-fusion
multimodal: the vision encoder is not run; precomputed patch embeddings
feed the projector, as in the VLM family.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,  # per expert (and shared expert)
    vocab_size=202048,
    rope_theta=500000.0,
    n_experts=16,
    moe_top_k=1,
    moe_shared_expert=True,
    d_frontend=1408,  # vision embedding width (MetaCLIP-style stub)
    frontend_tokens=144,
    sliding_window=8192,  # engages only past 65536 tokens (models/model.py)
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
