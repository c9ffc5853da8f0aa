"""Overlapped I/O–compute decode pipeline timeline (two-stage prefetch).

The port's copy of ``repro.core.pipeline``: per-layer ``(io_s, compute_s)``
vectors run through a two-resource timeline (a fetch engine that may run
``prefetch_depth`` layers ahead of compute, cyclic across steps) —

    f[k] = max(f[k-1], c[k-1-depth]) + io[k]
    c[k] = max(c[k-1], f[k]) + compute[k]

— giving per-step critical-path latency, compute stalls and fetch bubbles.
Host-side numpy: it runs once per decode call on the synced estimates.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineTimeline:
    """Per-step accounting of one decode call's I/O–compute pipeline."""

    io_s: np.ndarray  # (n, L) per-layer I/O per step
    compute_s: np.ndarray  # (n, L) per-layer compute per step
    serial_s: np.ndarray  # (n,) Σ_l (io + compute)
    overlap_s: np.ndarray  # (n,) critical-path latency with prefetch
    stall_s: np.ndarray  # (n,) compute idle waiting on a fetch
    bubble_s: np.ndarray  # (n,) fetch engine idle waiting for a buffer

    @property
    def serial_total_s(self) -> float:
        return float(self.serial_s.sum())

    @property
    def overlap_total_s(self) -> float:
        return float(self.overlap_s.sum())

    @property
    def hidden_s(self) -> float:
        """The time overlapping removed (>= 0 by construction)."""
        return self.serial_total_s - self.overlap_total_s

    @property
    def hideable_s(self) -> float:
        """Per step a perfect two-stage overlap hides min(io, compute):
        the sum of that over the steps."""
        return float(np.minimum(self.io_s.sum(axis=1), self.compute_s.sum(axis=1)).sum())

    def overlap_efficiency(self) -> float:
        return overlap_efficiency(self.serial_s, self.overlap_s, self.io_s.sum(axis=1),
                                  self.compute_s.sum(axis=1))


def overlap_efficiency(serial_s, overlap_s, io_s, compute_s) -> float:
    """Hidden / hideable time, clipped to [0, 1]; 1.0 when nothing is
    hideable."""
    serial_s = np.asarray(serial_s, np.float64)
    overlap_s = np.asarray(overlap_s, np.float64)
    hideable = float(np.minimum(np.asarray(io_s, np.float64),
                                np.asarray(compute_s, np.float64)).sum())
    if hideable <= 0.0:
        return 1.0
    return float(np.clip((serial_s.sum() - overlap_s.sum()) / hideable, 0.0, 1.0))


@dataclasses.dataclass(frozen=True)
class PipelineModel:
    """Two-stage prefetch timeline; ``prefetch_depth`` is the same knob as
    the gather kernels' ring (``prefetch_depth + 1`` stages)."""

    prefetch_depth: int = 1

    def __post_init__(self):
        if self.prefetch_depth < 0:
            raise ValueError(f"prefetch_depth must be >= 0, got {self.prefetch_depth}")

    def with_depth(self, prefetch_depth: int) -> "PipelineModel":
        """The same model at another prefetch depth (depth sweeps)."""
        return dataclasses.replace(self, prefetch_depth=prefetch_depth)

    def timeline(self, io_s, compute_s) -> PipelineTimeline:
        io = np.asarray(io_s, np.float64)
        if io.ndim == 1:
            io = io[None, :]
        if io.ndim != 2:
            raise ValueError(f"io_s must be (n, L) or (L,), got {io.shape}")
        n, n_layers = io.shape
        comp = np.broadcast_to(np.asarray(compute_s, np.float64), (n, n_layers)).copy()
        if np.any(io < 0) or np.any(comp < 0):
            raise ValueError("io_s and compute_s must be non-negative")

        f = io.reshape(-1)
        c = comp.reshape(-1)
        k_total = n * n_layers
        compute_done = np.zeros(k_total)
        stall = np.zeros(k_total)
        bubble = np.zeros(k_total)
        fetch_done_prev = 0.0
        compute_done_prev = 0.0
        for k in range(k_total):
            gate_idx = k - 1 - self.prefetch_depth
            buffer_free = compute_done[gate_idx] if gate_idx >= 0 else 0.0
            fetch_start = max(fetch_done_prev, buffer_free)
            bubble[k] = fetch_start - fetch_done_prev
            fetch_done_prev = fetch_start + f[k]
            stall[k] = max(0.0, fetch_done_prev - compute_done_prev)
            compute_done_prev = max(compute_done_prev, fetch_done_prev) + c[k]
            compute_done[k] = compute_done_prev

        ends = compute_done.reshape(n, n_layers)[:, -1]
        return PipelineTimeline(
            io_s=io,
            compute_s=comp,
            serial_s=io.sum(axis=1) + comp.sum(axis=1),
            overlap_s=np.diff(ends, prepend=0.0),
            stall_s=stall.reshape(n, n_layers).sum(axis=1),
            bubble_s=bubble.reshape(n, n_layers).sum(axis=1),
        )

    def serial_timeline(self, io_s, compute_s) -> PipelineTimeline:
        """The baseline: the same inputs at depth 0, where each step's
        overlap_s equals its serial_s."""
        return self.with_depth(0).timeline(io_s, compute_s)
