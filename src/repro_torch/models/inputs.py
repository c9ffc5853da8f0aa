"""Prompt construction: token ids from a numpy seed (the reference's
``make_dummy_batch`` draws the same ids from the same seed)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import InputShape, ModelConfig


def make_dummy_batch(cfg: ModelConfig, shape: InputShape, seed: int = 0,
                     device=None) -> Dict[str, torch.Tensor]:
    """{"tokens": (B, S) int64} drawn uniformly from the vocabulary, on
    ``device`` (default ``cuda``; no card raises)."""
    device = resolve_device(device)
    if shape.is_decode:
        raise ValueError("decode shapes take a cache, not a prompt")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (shape.global_batch, shape.seq_len))
    return {"tokens": torch.from_numpy(toks).to(device)}
