"""Prompt construction from a numpy seed (the reference's ``make_dummy_batch``
draws the same arrays from the same seed).

Geometry, as in the reference:
  * text LMs: tokens (B, S);
  * early-fusion VLMs: tokens (B, S - n_front) + frontend (B, n_front,
    d_frontend) with n_front = min(frontend_tokens, S // 2), so the residual
    stream is S long;
  * the audio encoder-decoder: tokens (B, S) for the decoder + frontend
    (B, frontend_tokens, d_frontend), the encoder's frames (the stubbed
    conv frontend's output).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import InputShape, ModelConfig

FRONT_DTYPE = torch.bfloat16


def _geometry(cfg: ModelConfig, shape: InputShape) -> Dict[str, Tuple[int, ...]]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        return {"tokens": (b, s), "frontend": (b, cfg.frontend_tokens, cfg.d_frontend)}
    if cfg.d_frontend:
        n_front = min(cfg.frontend_tokens, s // 2)
        return {"tokens": (b, s - n_front), "frontend": (b, n_front, cfg.d_frontend)}
    return {"tokens": (b, s)}


def make_dummy_batch(cfg: ModelConfig, shape: InputShape, seed: int = 0,
                     device=None) -> Dict[str, torch.Tensor]:
    """{"tokens": (B, S_text) int64 uniform over the vocabulary, and for a
    VLM or the audio family "frontend": (B, n, d_frontend) bf16 standard
    normals}, drawn
    from one ``np.random.default_rng(seed)`` in the reference's order, on
    ``device`` (default ``cuda``; no card raises)."""
    device = resolve_device(device)
    if shape.is_decode:
        raise ValueError("decode shapes take a cache, not a prompt")
    rng = np.random.default_rng(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, shp in _geometry(cfg, shape).items():
        if name == "tokens":
            out[name] = torch.from_numpy(rng.integers(0, cfg.vocab_size, shp)).to(device)
        else:
            out[name] = torch.from_numpy(rng.normal(0, 1, shp)).to(FRONT_DTYPE).to(device)
    return out
