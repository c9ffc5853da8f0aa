"""Comparison baselines (paper §4.1, App. L).

  * top-k magnitude sparsification — the paper's main baseline (TEAL /
    LLM-in-a-Flash style): keep the ``budget`` most important neurons
    regardless of storage layout.
  * threshold sparsification — CATS style: keep |a| above a calibrated
    threshold.
  * row-column bundling — LLM-in-a-Flash style (App. L, Table 3): rows of
    matrices sharing an input (q/k/v, gate/up) interleaved in storage, so
    one selected neuron's rows are one contiguous read across the bundle;
    modelled as a row-size multiplier on the latency table.
"""
from __future__ import annotations

import numpy as np
import torch

from .contiguity import mask_to_chunks_np
from .latency_model import DeviceProfile, profile_table


def topk_mask(v: torch.Tensor, budget) -> torch.Tensor:
    """Keep the ``budget`` highest-importance neurons: bool (..., N), batched
    over leading axes (``budget`` broadcasts against them). Ties go to the
    lower index (stable rank), as in the reference."""
    order = torch.argsort(-v.to(torch.float32), dim=-1, stable=True)
    n = v.shape[-1]
    iota = torch.arange(n, device=v.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, iota)
    budget = torch.as_tensor(budget, device=v.device)
    return rank < budget.unsqueeze(-1) if budget.ndim else rank < budget


def topk_mask_np(v: np.ndarray, budget: int) -> np.ndarray:
    """``topk_mask`` on the host: bool (N,)."""
    v = np.asarray(v, np.float32)
    mask = np.zeros(v.shape[0], bool)
    mask[np.argsort(-v, kind="stable")[:budget]] = True
    return mask


def threshold_mask(v: torch.Tensor, threshold: float) -> torch.Tensor:
    """CATS-style: keep the neurons whose importance exceeds a calibrated
    threshold (the sparsity then depends on the input)."""
    return v.to(torch.float32) > threshold


def calibrate_threshold(cal_importance: np.ndarray, sparsity: float) -> float:
    """The threshold that gives ``sparsity`` on the calibration set."""
    flat = np.asarray(cal_importance, np.float32).reshape(-1)
    return float(np.quantile(flat, sparsity))


def _chunk_latency(mask: np.ndarray, row_bytes: float, device: str | DeviceProfile) -> float:
    """Σ over the mask's chunks of T[size] for rows of ``row_bytes``."""
    chunks = mask_to_chunks_np(np.asarray(mask))
    if not chunks:
        return 0.0
    table = profile_table(device, row_bytes, max_rows=max(c.size for c in chunks),
                          torch_device="cpu")
    return sum(float(table.lookup(torch.tensor(c.size))) for c in chunks)


def bundled_latency(mask: np.ndarray, row_bytes: int, bundle: int,
                    device: str | DeviceProfile) -> float:
    """I/O latency of loading ``bundle`` matrices' rows for the selected
    neurons when those rows are interleaved in storage: a chunk of r
    neurons is one contiguous read of r · bundle · row_bytes. The
    favourable model of bundling; the selection stays layout-oblivious."""
    return float(_chunk_latency(mask, row_bytes * bundle, device))


def unbundled_latency(mask: np.ndarray, row_bytes: int, n_matrices: int,
                      device: str | DeviceProfile) -> float:
    """The same selection without bundling: each matrix issues its own
    reads (``n_matrices`` copies of the pattern)."""
    return float(_chunk_latency(mask, row_bytes, device) * n_matrices)
