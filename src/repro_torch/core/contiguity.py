"""Contiguity distribution: the paper's core abstraction (§3).

A selection mask M ∈ {0,1}^N reduces to the multiset of maximal contiguous
run lengths ("chunks"). Two forms, as in ``repro.core.contiguity``:

  * numpy (``*_np``) — reference semantics for tests and offline tools;
  * torch (``mask_run_sizes``, ``mask_to_runs``, ``resident_rows_in_windows``,
    ``contiguity_histogram``, ``average_chunk_size``) — static shapes, no
    host sync, batched over leading axes; the decode loop prices masks
    with them on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Chunk:
    """A maximal contiguous run of selected neuron indices [start, start+size)."""

    start: int
    size: int

    @property
    def stop(self) -> int:
        return self.start + self.size


def mask_to_chunks_np(mask: np.ndarray) -> List[Chunk]:
    """Decompose a binary mask into maximal contiguous chunks (numpy ref)."""
    mask = np.asarray(mask).astype(bool)
    if mask.ndim != 1:
        raise ValueError(f"mask must be 1-D, got shape {mask.shape}")
    if not mask.any():
        return []
    padded = np.concatenate([[False], mask, [False]])
    diff = np.diff(padded.astype(np.int8))
    starts = np.nonzero(diff == 1)[0]
    stops = np.nonzero(diff == -1)[0]
    return [Chunk(int(a), int(b - a)) for a, b in zip(starts, stops)]


def chunks_to_mask_np(chunks: List[Chunk], n: int) -> np.ndarray:
    """Inverse of mask_to_chunks_np (chunks may be unsorted but non-overlapping)."""
    mask = np.zeros(n, dtype=bool)
    for c in chunks:
        if c.start < 0 or c.stop > n:
            raise ValueError(f"chunk {c} out of bounds for n={n}")
        if mask[c.start: c.stop].any():
            raise ValueError(f"chunk {c} overlaps a previous chunk")
        mask[c.start: c.stop] = True
    return mask


def contiguity_distribution_np(mask: np.ndarray) -> Dict[int, int]:
    """Frequency distribution {chunk_size: count} of a mask's chunks."""
    dist: Dict[int, int] = {}
    for c in mask_to_chunks_np(mask):
        dist[c.size] = dist.get(c.size, 0) + 1
    return dist


def chunk_stats_np(mask: np.ndarray) -> Tuple[float, int]:
    """(average chunk size, modal chunk size); (0.0, 0) for an empty mask."""
    sizes = np.array([c.size for c in mask_to_chunks_np(mask)], dtype=np.int64)
    if sizes.size == 0:
        return 0.0, 0
    values, counts = np.unique(sizes, return_counts=True)
    return float(sizes.mean()), int(values[np.argmax(counts)])


def runs_to_padded_table_np(mask: np.ndarray, max_chunks: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(starts, sizes, n) of a mask's runs, padded or truncated to
    ``max_chunks`` entries; n is the number of real entries."""
    chunks = mask_to_chunks_np(mask)
    n = min(len(chunks), max_chunks)
    starts = np.zeros(max_chunks, np.int32)
    sizes = np.zeros(max_chunks, np.int32)
    for i, c in enumerate(chunks[:max_chunks]):
        starts[i] = c.start
        sizes[i] = c.size
    return starts, sizes, n


def mask_run_sizes(mask: torch.Tensor) -> torch.Tensor:
    """Run lengths of a (..., N) mask with a static shape: (..., N) int64
    whose first n_runs entries along the last axis are the runs' sizes in
    order and the rest are 0 (a mask of length N has at most N runs).
    Counts are integer scatter-adds, so the result is exact on any device
    and never syncs with the host."""
    m = mask.to(torch.bool)
    n = m.shape[-1]
    prev = torch.nn.functional.pad(m[..., :-1], (1, 0))
    run_id = torch.cumsum((m & ~prev).to(torch.int64), dim=-1) - 1
    dump = torch.where(m, run_id, torch.full_like(run_id, n))
    sizes = torch.zeros(m.shape[:-1] + (n + 1,), dtype=torch.int64, device=m.device)
    sizes.scatter_add_(-1, dump, m.to(torch.int64))
    return sizes[..., :n]


def mask_to_runs(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunk decomposition with static shapes, batched over leading axes
    (the reference's ``mask_to_runs_jax``): (starts, sizes, n_chunks) where
    ``starts``/``sizes`` are (..., N) int64 whose first ``n_chunks``
    entries along the last axis are the runs in order and the rest 0."""
    m = mask.to(torch.bool)
    n = m.shape[-1]
    prev = torch.nn.functional.pad(m[..., :-1], (1, 0))
    is_start = m & ~prev
    run_id = torch.cumsum(is_start.to(torch.int64), dim=-1) - 1
    idx = torch.arange(n, device=m.device).expand_as(run_id)
    dump = torch.where(is_start, run_id, torch.full_like(run_id, n))
    starts = torch.zeros(m.shape[:-1] + (n + 1,), dtype=torch.int64, device=m.device)
    starts.scatter_(-1, dump, idx)
    sizes = mask_run_sizes(m)
    n_chunks = is_start.sum(dim=-1)
    return starts[..., :n], sizes, n_chunks


def resident_rows_in_windows(starts: torch.Tensor, sizes: torch.Tensor,
                             resident: torch.Tensor) -> torch.Tensor:
    """Resident-row count inside each [start, start + size) window, from an
    integer prefix sum of ``resident`` (..., N): exact on any device. The
    windows (..., K) broadcast against ``resident``'s leading axes.
    Shared by ``LatencyTable.mask_latency_miss`` and the marginal-cost
    scoring of the selectors, as in the reference, so the selector's cost
    of a window and the final charge cannot diverge."""
    r = resident.to(torch.int64)
    rcum = torch.nn.functional.pad(torch.cumsum(r, dim=-1), (1, 0))
    starts = starts.to(torch.int64)
    ends = starts + sizes.to(torch.int64)
    shape = torch.broadcast_shapes(rcum.shape[:-1] + (1,), starts.shape)
    rcum = rcum.expand(shape[:-1] + rcum.shape[-1:])
    return rcum.gather(-1, ends.expand(shape)) - rcum.gather(-1, starts.expand(shape))


def contiguity_histogram(mask: torch.Tensor, max_size: int) -> torch.Tensor:
    """h[..., s] = number of chunks of size s, sizes above ``max_size``
    clamped to it; (..., max_size + 1) int64, h[..., 0] unused (0)."""
    sizes = mask_run_sizes(mask).clamp(0, max_size)
    h = torch.zeros(sizes.shape[:-1] + (max_size + 1,), dtype=torch.int64,
                    device=sizes.device)
    h.scatter_add_(-1, sizes, (sizes > 0).to(torch.int64))
    return h


def average_chunk_size(mask: torch.Tensor) -> torch.Tensor:
    """Mean chunk size of a mask (0.0 if empty), batched over leading axes;
    f32."""
    sizes = mask_run_sizes(mask)
    n_chunks = (sizes > 0).sum(dim=-1)
    total = sizes.sum(dim=-1).to(torch.float32)
    return torch.where(n_chunks > 0, total / n_chunks.clamp_min(1).to(torch.float32),
                       torch.zeros_like(total))
