"""Granite-3.0-2B-base — GQA dense decoder [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model=2048, 32 heads (GQA kv=8), d_ff=8192, vocab=49155; the LM
head is the transposed token embedding (tied).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    arch_type="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    rope_theta=10000.0,
    tie_embeddings=True,
    sliding_window=8192,  # engages only past 65536 tokens (models/model.py)
    citation="hf:ibm-granite/granite-3.0-2b-base",
)
