"""Carry the JAX reference's parameters, caches and recurrent states over
into the port.

The reference's trees arrive as pytrees of numpy arrays
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
    """Reference param pytree (numpy leaves, two levels deep: stacked (L,
    ...) layer leaves, optional ``_q8``/``_sc`` quantized leaves) → the
    port's params dict on ``device`` (default ``cuda``; no card raises).
    Checks every leaf the port's model has against its shape (the VLM
    ``projector``, LayerNorm biases, the gelu MLP's leaves, a MoE layer's
    router, experts and shared expert; Zamba's ``mamba_groups``,
    ``mamba_tail`` and ``shared``; xLSTM's ``block_i``; Whisper's
    ``encoder``, ``decoder``, ``pos_embed_dec``, ``frontend_proj`` and
    ``enc_final_w``/``_b``; no ``head`` when the embeddings are tied)."""
    from .model import Model

    device = resolve_device(device)

    want = Model(cfg).param_shapes()
    out: Dict[str, Any] = {}
    for name, leaf in params_np.items():
        if isinstance(leaf, dict):
            out[name] = {sub: _leaf(v, device) for sub, v in leaf.items()}
        else:
            out[name] = _leaf(leaf, device)
    for key, (shape, *_) in want.items():
        top, _, sub = key.partition("/")
        got = out.get(top, {}).get(sub) if sub else out.get(top)
        if got is None:
            raise ValueError(f"reference params have no leaf {key} (shape {shape})")
        if tuple(got.shape) != shape:
            raise ValueError(f"reference leaf {key} has shape {tuple(got.shape)}, "
                             f"the port expects {shape}")
    return out


def cache_from_reference(cache_np, device=None):
    """A reference cache or recurrent state (numpy leaves in dicts and
    tuples, as ``jax.device_get`` gives them) → the port's layout on
    ``device`` (default ``cuda``): the same nesting with tensor leaves, and
    a scalar ``length`` as the host int the port's single-stream caches
    keep."""
    device = resolve_device(device)

    def carry(key, leaf):
        if isinstance(leaf, dict):
            return {k: carry(k, v) for k, v in leaf.items()}
        if isinstance(leaf, (tuple, list)):
            return tuple(carry(key, v) for v in leaf)
        if key == "length" and np.ndim(leaf) == 0:
            return int(leaf)
        return _leaf(leaf, device)

    return carry(None, cache_np)
