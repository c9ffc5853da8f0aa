"""Carry the JAX reference's parameters over into the port.

The reference's params arrive as a pytree of numpy arrays
(``jax.device_get``). bf16 leaves are ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses, so they go through float32 and back to bf16 —
lossless, since every bf16 value is a float32 value. int8 payloads
(``_q8``) and float32 scales (``_sc``) pass through as they are.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device

def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_reference(params_np: Dict[str, Any], cfg, device=None) -> Dict[str, Any]:
    """Reference param pytree (numpy leaves; stacked (L, ...) layer leaves,
    optional ``_q8``/``_sc`` quantized leaves) → the port's params dict on
    ``device`` (default ``cuda``; no card raises). Checks each leaf's shape
    against the port's model (the VLM ``projector``, LayerNorm biases, the
    gelu MLP's leaves and a MoE layer's router, experts and shared expert
    included; no ``head`` when the embeddings are tied)."""
    from .model import Model

    device = resolve_device(device)

    want = Model(cfg).param_shapes()
    out: Dict[str, Any] = {}
    for name, leaf in params_np.items():
        if isinstance(leaf, dict):
            out[name] = {sub: _leaf(v, device) for sub, v in leaf.items()}
        else:
            out[name] = _leaf(leaf, device)
    for key, (shape, _) in want.items():
        top, _, sub = key.partition("/")
        got = out.get(top, {}).get(sub) if sub else out.get(top)
        if got is None:
            raise ValueError(f"reference params have no leaf {key} (shape {shape})")
        if tuple(got.shape) != shape:
            raise ValueError(f"reference leaf {key} has shape {tuple(got.shape)}, "
                             f"the port expects {shape}")
    return out
