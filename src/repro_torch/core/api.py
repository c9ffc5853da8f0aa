"""High-level NeuronChunking facade: one planner per offloaded weight matrix.

The per-matrix runtime flow (``python -m repro_torch.launch.quickstart``):

    planner = NeuronChunkingPlanner.build(n_rows, n_cols, device="nano")
    plan    = planner.plan(acts, sparsity=0.4)         # K5 walk on the card
    starts, sizes = plan_to_kernel_table(plan.mask)    # block-aligned table
    y       = sparse_matmul(W, x, starts, sizes)       # K3

``plan`` carries the mask and the latency estimates, on the activations'
device; ``plan_topk`` is the layout-oblivious top-k baseline.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .baselines import topk_mask
from .chunking import ChunkConfig, ChunkSelector
from .importance import importance, retention
from .latency_model import DeviceProfile, LatencyTable
from .reorder import Reordering


@dataclasses.dataclass(frozen=True, eq=False)
class SparsePlan:
    """Output of one selection decision for one weight matrix."""

    mask: torch.Tensor  # (N,) bool over (possibly reordered) rows
    n_selected: torch.Tensor  # scalar int32
    est_latency_s: torch.Tensor  # additive-model latency of this plan
    importance_retention: torch.Tensor  # Σ selected V / Σ V


@dataclasses.dataclass(frozen=True, eq=False)
class NeuronChunkingPlanner:
    """Per-matrix planner: importance → utility-guided chunk plan."""

    n_rows: int
    n_cols: int
    row_bytes: int
    selector: ChunkSelector
    reordering: Optional[Reordering] = None

    @staticmethod
    def build(n_rows: int, n_cols: int, device: str | DeviceProfile = "nano",
              dtype_bytes: int = 2, cfg: Optional[ChunkConfig] = None,
              reordering: Optional[Reordering] = None,
              table: Optional[LatencyTable] = None) -> "NeuronChunkingPlanner":
        row_bytes = n_cols * dtype_bytes
        dev_name = device if isinstance(device, str) else device.name
        cfg = cfg or ChunkConfig.for_shape(n_rows, n_cols, dev_name)
        selector = ChunkSelector.build(n_rows, row_bytes, device=device, cfg=cfg, table=table)
        return NeuronChunkingPlanner(n_rows=n_rows, n_cols=n_cols, row_bytes=row_bytes,
                                     selector=selector, reordering=reordering)

    def _importance(self, acts: torch.Tensor) -> torch.Tensor:
        v = importance(acts)
        if self.reordering is not None:
            v = self.reordering.apply_to_acts(v)
        return v

    def _budget(self, sparsity: float) -> int:
        return round((1.0 - float(sparsity)) * self.n_rows)

    def plan(self, acts: torch.Tensor, sparsity: float) -> SparsePlan:
        """Utility-guided chunk selection at a given sparsity level."""
        v = self._importance(acts)
        mask, n_sel, lat = self.selector.select(v, self._budget(sparsity))
        return SparsePlan(mask=mask, n_selected=n_sel, est_latency_s=lat,
                          importance_retention=retention(v, mask))

    def plan_topk(self, acts: torch.Tensor, sparsity: float) -> SparsePlan:
        """Baseline plan: pure magnitude top-k (layout-oblivious)."""
        v = self._importance(acts)
        mask = topk_mask(v, self._budget(sparsity))
        _, table = self.selector.lane(v.device)
        return SparsePlan(mask=mask, n_selected=mask.sum(dtype=torch.int32),
                          est_latency_s=table.mask_latency(mask),
                          importance_retention=retention(v, mask))

    def dense_latency(self) -> float:
        """Full-matrix contiguous load latency (the no-sparsity floor)."""
        return float(self.selector.table.lookup(torch.tensor(self.n_rows)))
