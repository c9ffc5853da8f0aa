"""Whisper-small — encoder-decoder ASR backbone [arXiv:2212.04356].

12 encoder + 12 decoder layers, d_model=768, 12 heads (MHA), d_ff=3072,
vocab=51865; LayerNorm, the gelu MLP, sinusoidal encoder and learned
decoder positions, no RoPE. The mel-spectrogram and conv feature extractor
are a stub, as in the reference: the frontend is 1500 frame embeddings of
width 768.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    n_layers=12,  # decoder depth
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    rope_theta=None,  # absolute positions
    norm="layernorm",
    mlp="gelu",
    d_frontend=768,  # the stubbed conv frontend's output width
    frontend_tokens=1500,  # audio context positions
    sliding_window=8192,  # engages only past 65536 tokens (models/model.py)
    citation="arXiv:2212.04356",
)
