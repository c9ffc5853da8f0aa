"""Chunk-based latency model (paper §3.1) + the flash device profiles.

Per chunk size s the profile gives the read latency T[s]; an access
pattern costs the sum of its chunks' latencies,
``L_total(mask) = Σ_i T[size_i * row_bytes]``. The profiles are the
reference's synthetic reconstructions of the paper's Jetson measurements
(``repro.core.latency_model``); they price simulated flash I/O and say
nothing about the GPU this package runs on.

``LatencyTable`` keeps its table as a float32 tensor built exactly like the
reference's (float64 values rounded once to float32), so lookups agree bit
for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from .contiguity import mask_run_sizes, mask_to_runs, resident_rows_in_windows

KB = 1024.0
MB = 1024.0 * 1024.0


def row_stream_bytes(cols: int, wbits: int = 16, block_rows: int = 8) -> float:
    """Streamed bytes per selected weight row at a given storage width:
    ``cols * 2`` at 16 bits; at 8 bits ``cols`` int8 bytes plus the
    per-``block_rows`` f32 scale amortized over the block's rows."""
    if wbits not in (16, 8):
        raise ValueError(f"wbits must be 16 or 8, got {wbits}")
    payload = cols * wbits / 8.0
    scale_overhead = (4.0 / block_rows) if wbits < 16 else 0.0
    return payload + scale_overhead


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Two-regime storage latency profile: ``T(s) = base + 1/iops + s/bw``.
    ``dram_cache_mb``: the default DRAM budget (MB) of the dynamic chunk
    residency cache (paper §5), used when an engine is given no
    ``cache_mb``; 0 turns the tier off."""

    name: str
    peak_bw: float  # bytes/sec
    iops: float  # sustained small requests/sec
    base_latency: float = 0.0
    interleave_lift: float = 1.0
    dram_cache_mb: float = 0.0

    def cache_capacity_bytes(self, cache_mb: Optional[float] = None) -> int:
        """Residency-tier capacity in bytes; ``cache_mb`` overrides the
        profile's default."""
        mb = self.dram_cache_mb if cache_mb is None else float(cache_mb)
        if mb < 0:
            raise ValueError(f"cache_mb must be >= 0, got {mb}")
        return int(mb * MB)

    def latency_bytes(self, nbytes) -> np.ndarray:
        s = np.asarray(nbytes, dtype=np.float64)
        return self.base_latency + 1.0 / self.iops + s / self.peak_bw

    def build_table(self, row_bytes: float, max_rows: int, device=None) -> "LatencyTable":
        """T[0..max_rows] for rows of ``row_bytes``, on ``device`` (default
        ``cuda``; no card raises)."""
        device = resolve_device(device)
        sizes = np.arange(max_rows + 1, dtype=np.float64) * row_bytes
        lat = self.latency_bytes(sizes)
        lat[0] = 0.0
        return LatencyTable(
            device=self.name,
            row_bytes=row_bytes,
            table=torch.tensor(lat, dtype=torch.float32, device=device),
        )


@dataclasses.dataclass(frozen=True, eq=False)
class LatencyTable:
    """T[r]: latency (sec) of loading one chunk of r contiguous rows;
    ``table`` is (max_rows+1,) float32 with table[0] == 0."""

    device: str
    row_bytes: float
    table: torch.Tensor

    @property
    def max_rows(self) -> int:
        return int(self.table.shape[0]) - 1

    def lookup(self, rows: torch.Tensor) -> torch.Tensor:
        """T[rows] with clamping + linear extrapolation above max_rows (the
        table is affine past the knee, so extrapolation is exact)."""
        r = torch.as_tensor(rows, device=self.table.device)
        rmax = self.max_rows
        slope = self.table[rmax] - self.table[rmax - 1] if rmax >= 2 else self.table[rmax]
        base = self.table[r.clamp(0, rmax).to(torch.int64)]
        extra = (r - rmax).clamp_min(0).to(torch.float32) * slope
        return base + extra

    def mask_latency(self, mask: torch.Tensor) -> torch.Tensor:
        """Estimated latency of an access pattern: Σ chunks T[size], for a
        (N,) mask or batched over leading axes. No host sync."""
        sizes = mask_run_sizes(mask)
        return (self.lookup(sizes) * (sizes > 0)).sum(dim=-1)

    def mask_latency_miss(self, mask: torch.Tensor, resident: torch.Tensor) -> torch.Tensor:
        """Residency-aware additive model: Σ over the mask's runs of T[miss
        rows in the run]. Each selected run is one request charged for its
        non-resident rows only (resident rows do not split it); a fully
        resident run costs nothing. Equals ``mask_latency`` when nothing is
        resident. Batched over leading axes; no host sync."""
        starts, sizes, _ = mask_to_runs(mask)
        miss = sizes - resident_rows_in_windows(starts, sizes, resident)
        return (self.lookup(miss) * (miss > 0)).sum(dim=-1)

    def padded_table(self, max_rows: int) -> np.ndarray:
        """T[0..max_rows] as a float64 host array, extrapolated past the
        table end like ``lookup`` (one row of a batched selector's cost
        matrix)."""
        return self.lookup(torch.arange(max_rows + 1)).cpu().numpy().astype(np.float64)


# Jetson Orin AGX + Samsung 990 Pro (7450 MB/s) and Orin Nano + SK Hynix
# P31 (3500 MB/s): the reference's calibrated reconstructions (see
# repro/core/latency_model.py for the calibration).
JETSON_AGX = DeviceProfile(
    name="jetson_agx_990pro", peak_bw=7450 * MB, iops=220_000.0, interleave_lift=1.18
)
JETSON_NANO = DeviceProfile(
    name="jetson_nano_p31", peak_bw=3500 * MB, iops=150_000.0, interleave_lift=1.31
)

PROFILES: Dict[str, DeviceProfile] = {p.name: p for p in (JETSON_AGX, JETSON_NANO)}
PROFILES["agx"] = JETSON_AGX
PROFILES["nano"] = JETSON_NANO


def get_profile(name: str) -> DeviceProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown device profile {name!r}; have {sorted(PROFILES)}") from None


def profile_table(device: str | DeviceProfile, row_bytes: float, max_rows: int,
                  torch_device=None) -> LatencyTable:
    """The profile's latency table on ``torch_device`` (default ``cuda``;
    no card raises)."""
    prof = device if isinstance(device, DeviceProfile) else get_profile(device)
    return prof.build_table(row_bytes=row_bytes, max_rows=max_rows, device=torch_device)
