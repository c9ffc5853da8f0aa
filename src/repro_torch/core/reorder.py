"""Hot–cold offline neuron reordering (paper §3.3, App. F/G).

Count how often each input neuron is "active" (in the top 50% by
importance) over a calibration set, sort neurons by decreasing activation
frequency, and permute the weight rows so frequently active neurons are
stored contiguously. At runtime the same permutation is applied to the
activation vector, a gather on its last axis. The co-activation-greedy
reorderer is Ripple's scheme, for the App. G ablation.

The calibration-time functions are numpy, as in ``repro.core.reorder``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Reordering:
    """perm[i] = original index stored at new position i.

    weights_new[i] = weights_old[perm[i]];  acts_new = acts_old[..., perm].
    ``inverse`` maps original → new position.
    """

    perm: np.ndarray

    @property
    def inverse(self) -> np.ndarray:
        inv = np.empty_like(self.perm)
        inv[self.perm] = np.arange(self.perm.shape[0])
        return inv

    def apply_to_rows(self, w):
        """Permute weight rows (numpy array or tensor)."""
        if isinstance(w, torch.Tensor):
            return w[torch.as_tensor(self.perm, device=w.device)]
        return w[self.perm]

    def apply_to_acts(self, a: torch.Tensor) -> torch.Tensor:
        """Permute the trailing activation axis to match reordered rows."""
        return torch.index_select(a, -1, torch.as_tensor(self.perm, device=a.device))

    def unapply_mask(self, mask) -> np.ndarray:
        """Map a mask over reordered positions back to original indices."""
        if isinstance(mask, torch.Tensor):
            mask = mask.cpu().numpy()
        out = np.zeros_like(np.asarray(mask))
        out[self.perm] = np.asarray(mask)
        return out

    @staticmethod
    def identity(n: int) -> "Reordering":
        return Reordering(np.arange(n))


def _active(cal_importance: np.ndarray, active_fraction: float) -> np.ndarray:
    """(S, N) bool: each sample's top ``active_fraction`` neurons (ties at
    the k-th largest value included)."""
    cal = np.asarray(cal_importance, np.float32)
    if cal.ndim == 1:
        cal = cal[None]
    n = cal.shape[1]
    k = max(1, int(round(active_fraction * n)))
    thresh = np.partition(cal, n - k, axis=1)[:, n - k]
    return cal >= thresh[:, None]


def activation_frequency(cal_importance: np.ndarray, active_fraction: float = 0.5) -> np.ndarray:
    """Per-neuron activation frequency in [0, 1] over (S, N) calibration
    importances: the share of samples in which the neuron is active."""
    return _active(cal_importance, active_fraction).mean(axis=0)


def hot_cold_reordering(cal_importance: np.ndarray, active_fraction: float = 0.5) -> Reordering:
    """Sort neurons by decreasing activation frequency (§3.3); the sort is
    stable, so equal-frequency neurons keep their original order."""
    freq = activation_frequency(cal_importance, active_fraction)
    return Reordering(np.argsort(-freq, kind="stable"))


def coactivation_reordering(cal_importance: np.ndarray,
                            active_fraction: float = 0.5) -> Reordering:
    """Ripple-style greedy co-activation chaining (App. G): each next neuron
    maximizes its co-activation count with the previous one. O(N^2) memory,
    calibration time only."""
    active = _active(cal_importance, active_fraction).astype(np.float32)
    n = active.shape[1]
    co = active.T @ active  # (N, N) co-activation counts
    np.fill_diagonal(co, -1.0)
    freq = active.mean(axis=0)
    order = [int(np.argmax(freq))]
    visited = np.zeros(n, bool)
    visited[order[0]] = True
    for _ in range(n - 1):
        row = co[order[-1]].copy()
        row[visited] = -np.inf
        nxt = int(np.argmax(row))
        order.append(nxt)
        visited[nxt] = True
    return Reordering(np.asarray(order))
