"""Comparison baseline: top-k magnitude sparsification (paper §4.1) —
keep the ``budget`` most important neurons regardless of storage layout."""
from __future__ import annotations

import torch


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
