"""TEAL-style layer-wise sparsity allocation (paper §4.1 comparison setup);
the port's copy of ``repro.core.sparsity_alloc`` (host-side numpy).

TEAL [24] profiles per-layer activation distributions on a calibration set and
allocates *different* sparsity levels per (layer, projection) so that a global
average sparsity target is met with minimal total error. We implement the
greedy marginal-error variant:

  * error proxy e_l(s): fraction of L1 activation mass removed when layer l
    keeps its top-(1-s) neurons (computed from calibration importances);
  * allocate sparsity in `step` increments, always to the layer with the
    smallest marginal error increase, until mean sparsity hits the target.

Both the top-k baseline and Neuron Chunking consume the resulting per-layer
budgets, exactly as in the paper's comparison setup.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np


@dataclasses.dataclass
class LayerProfile:
    """Calibration profile of one (layer, projection) matrix's input."""

    name: str
    importance: np.ndarray  # (N,) mean |a| over calibration tokens

    def error_at(self, sparsity: float) -> float:
        """Removed L1 mass fraction at a given sparsity (lower = better)."""
        v = np.sort(np.asarray(self.importance, np.float64))  # ascending
        n = v.shape[0]
        k = int(round(sparsity * n))  # k smallest neurons are dropped
        total = v.sum()
        if total <= 0:
            return 0.0
        return float(v[:k].sum() / total)


def allocate_sparsity(
    profiles: Sequence[LayerProfile],
    target_sparsity: float,
    step: float = 0.05,
    max_layer_sparsity: float = 0.95,
) -> Dict[str, float]:
    """Greedy marginal-error allocation. Returns {layer name: sparsity}."""
    if not 0.0 <= target_sparsity < 1.0:
        raise ValueError(f"target_sparsity must be in [0,1), got {target_sparsity}")
    n_layers = len(profiles)
    alloc = np.zeros(n_layers)
    # total increments needed so that mean(alloc) == target
    total_steps = int(round(target_sparsity * n_layers / step))
    cur_err = np.array([p.error_at(0.0) for p in profiles])
    for _ in range(total_steps):
        best, best_delta = -1, np.inf
        for i, p in enumerate(profiles):
            s_new = alloc[i] + step
            if s_new > max_layer_sparsity + 1e-9:
                continue
            delta = p.error_at(s_new) - cur_err[i]
            if delta < best_delta:
                best, best_delta = i, delta
        if best < 0:
            break
        alloc[best] += step
        cur_err[best] += best_delta
    return {p.name: float(round(a, 6)) for p, a in zip(profiles, alloc)}


def budgets_from_sparsity(
    sparsity: Dict[str, float], sizes: Dict[str, int]
) -> Dict[str, int]:
    """Per-layer row budgets R = (1 - s) * N."""
    return {k: int(round((1.0 - s) * sizes[k])) for k, s in sparsity.items()}
