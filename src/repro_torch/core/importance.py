"""Neuron importance scores (paper App. B.2).

Importance of input neuron i of a weight matrix is |a_i| for one token and
the mean of |a_i| over tokens otherwise: one importance vector shared by
every token of a step.
"""
from __future__ import annotations

import numpy as np
import torch


def importance(acts: torch.Tensor) -> torch.Tensor:
    """|a| averaged over all leading (token/batch) axes.

    acts: (..., N) activations entering a weight matrix's input dim.
    Returns (N,) float32 importance.
    """
    a = acts.to(torch.float32).abs()
    if a.ndim == 1:
        return a
    return a.reshape(-1, a.shape[-1]).mean(dim=0)


def importance_np(acts: np.ndarray) -> np.ndarray:
    a = np.abs(np.asarray(acts, np.float32))
    if a.ndim == 1:
        return a
    return a.reshape(-1, a.shape[-1]).mean(axis=0)


def coefficient_of_variation(v: torch.Tensor) -> torch.Tensor:
    """CV = std/mean of an importance vector (population std): the
    smoothness metric of the paper's Table 1."""
    v = v.to(torch.float32)
    return torch.std(v, correction=0) / torch.clamp_min(v.mean(), 1e-12)


def retention(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Importance retention Σ_selected V / Σ V, the accuracy proxy of the
    paper's plain-LLM study (App. N)."""
    v = v.to(torch.float32)
    return (v * mask.to(torch.float32)).sum() / torch.clamp_min(v.sum(), 1e-12)
