"""Shared model building blocks: norms, RoPE, activations, sinusoidal
positions and the causal mask (the port's copy of ``repro.models.common``;
params are plain dicts of tensors)."""
from __future__ import annotations

import numpy as np
import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with a bias, in f32 and cast back (the reference's
    biased variance)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of gelu (``jax.nn.gelu``'s default)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def sinusoidal_positions(n_pos: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (n_pos, dim), f32: computed in
    numpy float64 and rounded once, as the reference does."""
    pos = np.arange(n_pos)[:, None]
    idx = np.arange(dim // 2)[None, :]
    angles = pos / np.power(10000.0, 2 * idx / dim)
    emb = np.concatenate([np.sin(angles), np.cos(angles)], axis=-1)
    return torch.tensor(emb, dtype=torch.float32, device=device)


def causal_mask(q_len: int, kv_len: int, q_offset, device=None) -> torch.Tensor:
    """(q_len, kv_len) bool mask: query i attends key j iff j <= i + offset."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    return kj <= qi


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
