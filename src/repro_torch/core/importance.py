"""Neuron importance scores (paper App. B.2).

Importance of input neuron i of a weight matrix is |a_i| for one token and
the mean of |a_i| over tokens otherwise: one importance vector shared by
every token of a step.
"""
from __future__ import annotations

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
