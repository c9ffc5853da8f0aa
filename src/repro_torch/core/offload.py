"""Flash-offload I/O simulator, compute model and decode-site geometry.

The port's copy of the parts of ``repro.core.offload`` the one-stream
decode path uses. The simulator turns additive-model estimates into
"measured" latencies with the reference's lift + lognormal jitter, drawing
from the same numpy RNG stream, so equal estimates give equal simulated
times. These are simulated flash times of the paper's Jetson devices, not
times of the GPU. Fault injection and checksums come with the robustness
slice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .latency_model import DeviceProfile, get_profile
from .pipeline import PipelineModel


@dataclasses.dataclass
class IOEvent:
    """One simulated weight load: estimated transfer volume (float: the
    per-row cost is fractional at wbits=8), chunk count, charged latency
    and the residency-cache hit fraction (0 without the cache tier)."""

    name: str
    nbytes: float
    n_chunks: int
    latency_s: float
    hit_rate: float = 0.0


class FlashOffloadSimulator:
    """Simulated flash device with the paper-calibrated latency behaviour."""

    def __init__(self, device: str | DeviceProfile, seed: int = 0, noise: float = 0.04,
                 pipeline: Optional[PipelineModel] = None):
        self.profile = device if isinstance(device, DeviceProfile) else get_profile(device)
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.log: List[IOEvent] = []
        self.pipeline = pipeline or PipelineModel()

    def measure_from_estimate(self, est_s: float, n_chunks: int = 32,
                              diversity: float = 0.5, name: str = "",
                              hit_rate: float = 0.0, nbytes: float = 0.0) -> float:
        """An additive-model estimate → one simulated measurement (lift ×
        lognormal jitter); a zero estimate stays zero and draws nothing."""
        if est_s <= 0.0:
            return 0.0
        lift = self.profile.interleave_lift * (1.0 + 0.1 * diversity)
        latency = est_s * lift * self.rng.lognormal(mean=0.0, sigma=self.noise)
        self.log.append(IOEvent(name=name, nbytes=float(nbytes), n_chunks=n_chunks,
                                latency_s=latency, hit_rate=float(hit_rate)))
        return latency

    def measure_from_estimate_batch(self, est_s: np.ndarray, n_chunks: int = 32,
                                    diversity: float = 0.5, name: str = "",
                                    hit_rates: Optional[np.ndarray] = None,
                                    nbytes: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized ``measure_from_estimate`` for one decode call's
        (n_steps,) estimates: one jitter draw and one IOEvent per positive
        estimate, in order — the same RNG stream as the scalar path."""
        est = np.asarray(est_s, dtype=np.float64).reshape(-1)
        lift = self.profile.interleave_lift * (1.0 + 0.1 * diversity)
        pos = est > 0.0
        jitter = np.ones_like(est)
        jitter[pos] = self.rng.lognormal(mean=0.0, sigma=self.noise, size=int(pos.sum()))
        latency = np.where(pos, est * lift * jitter, 0.0)
        for i in np.flatnonzero(pos):
            self.log.append(IOEvent(
                name=f"{name}[{i}]" if name else name,
                nbytes=float(nbytes[i]) if nbytes is not None else 0.0,
                n_chunks=n_chunks, latency_s=float(latency[i]),
                hit_rate=float(hit_rates[i]) if hit_rates is not None else 0.0,
            ))
        return latency


SITE_KINDS = ("hidden_attn", "hidden_mlp", "ffn", "attn_out")


def normalize_site_sparsity(sparsity) -> dict:
    """A scalar sparsity → the per-site dict form; dicts pass through."""
    if isinstance(sparsity, dict):
        return sparsity
    return {k: float(sparsity) for k in SITE_KINDS}


def decode_site_shapes(cfg):
    """[(site kind, input rows, output cols per sharing matrix)] for every
    sparsification site of one decoder layer (paper App. A: q/k/v share the
    hidden mask, gate/up share theirs)."""
    d = cfg.d_model
    hd_all = cfg.n_heads * cfg.resolved_head_dim
    kv_all = cfg.n_kv_heads * cfg.resolved_head_dim
    sites = [
        ("hidden_attn", d, (hd_all, kv_all, kv_all)),
        ("attn_out", hd_all, (d,)),
    ]
    if cfg.d_ff and not cfg.has_moe:
        sites.append(("hidden_mlp", d, (cfg.d_ff, cfg.d_ff)))
        sites.append(("ffn", cfg.d_ff, (d,)))
    return sites


@dataclasses.dataclass
class ComputeModel:
    """First-order compute-time model of the edge device the paper targets
    (≈ Jetson Orin Nano GEMV rate) — the overlap pipeline's compute lane."""

    flops_per_s: float = 1.2e12

    def matmul_seconds(self, rows_loaded, cols: int, tokens: int = 1) -> float:
        return 2.0 * rows_loaded * cols * tokens / self.flops_per_s

    def decode_layer_seconds(self, cfg, sparsity=0.0, tokens: int = 1) -> np.ndarray:
        """Per-layer decode-step compute seconds, (n_layers,): each site's
        GEMV over its kept rows ``(1 - sparsity) * N``."""
        sp = normalize_site_sparsity(sparsity)
        sec = sum(
            self.matmul_seconds((1.0 - sp.get(kind, 0.0)) * n, sum(cols), tokens)
            for kind, n, cols in decode_site_shapes(cfg)
        )
        return np.full((cfg.n_layers,), sec, np.float64)
