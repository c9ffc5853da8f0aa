"""Flash-offload I/O simulator, compute model and decode-site geometry.

The port's copy of the parts of ``repro.core.offload`` the one-stream
decode path uses. The simulator turns additive-model estimates into
"measured" latencies with the reference's lift + lognormal jitter, drawing
from the same numpy RNG stream, so equal estimates give equal simulated
times. These are simulated flash times of the paper's Jetson devices, not
times of the GPU. A ``FaultModel`` (core/faults.py) perturbs each measured
event at this boundary, with its own RNG stream; the integrity ladder's
re-read seconds (``integrity_s``) are added after it. ``pack_checksums``
emits the bf16 pack path's checksum lane.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..kernels.quantize import QUANT_SUFFIX_CHECKSUM, block_checksums
from .faults import FaultModel
from .latency_model import DeviceProfile, get_profile
from .pipeline import PipelineModel


@dataclasses.dataclass
class IOEvent:
    """One simulated weight load: estimated transfer volume (float: the
    per-row cost is fractional at wbits=8), chunk count, charged latency
    and the residency-cache hit fraction (0 without the cache tier).
    ``retries`` / ``fault_s``: transient read failures retried on the event
    and the seconds the fault model charged above the clean latency;
    ``integrity_s``: the integrity ladder's re-read + backoff seconds. All
    three stay at their defaults with faults and corruption off, so such a
    log equals one without them."""

    name: str
    nbytes: float
    n_chunks: int
    latency_s: float
    hit_rate: float = 0.0
    retries: int = 0
    fault_s: float = 0.0
    integrity_s: float = 0.0


class FlashOffloadSimulator:
    """Simulated flash device with the paper-calibrated latency behaviour.
    ``faults``: an optional ``FaultModel`` applied to every measured event
    (its own RNG stream, so the jitter stream is the same with or without
    it); ``device_time_s`` is the busy clock its thermal trajectory reads."""

    def __init__(self, device: str | DeviceProfile, seed: int = 0, noise: float = 0.04,
                 pipeline: Optional[PipelineModel] = None,
                 faults: Optional[FaultModel] = None):
        self.profile = device if isinstance(device, DeviceProfile) else get_profile(device)
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.log: List[IOEvent] = []
        self.pipeline = pipeline or PipelineModel()
        self.faults = faults
        self.device_time_s = 0.0

    def _charge(self, latency_s: float) -> Tuple[float, int, float]:
        """One clean measured latency through the fault model (if any),
        advancing the busy clock: (charged latency, retries, extra fault
        seconds)."""
        if self.faults is None or not self.faults.enabled or latency_s <= 0.0:
            self.device_time_s += latency_s
            return latency_s, 0, 0.0
        out = self.faults.perturb(latency_s, self.device_time_s)
        self.device_time_s += out.charged_s
        return out.charged_s, out.retries, out.extra_s

    def measure_from_estimate(self, est_s: float, n_chunks: int = 32,
                              diversity: float = 0.5, name: str = "",
                              hit_rate: float = 0.0, nbytes: float = 0.0,
                              integrity_s: float = 0.0) -> float:
        """An additive-model estimate → one simulated measurement (lift ×
        lognormal jitter, then the fault model), plus ``integrity_s``
        verbatim (re-reads draw no jitter); a zero estimate draws nothing,
        and with no re-read seconds logs nothing either."""
        if est_s <= 0.0 and integrity_s <= 0.0:
            return 0.0
        lift = self.profile.interleave_lift * (1.0 + 0.1 * diversity)
        if est_s > 0.0:
            jitter = self.rng.lognormal(mean=0.0, sigma=self.noise)
            latency, retries, fault_s = self._charge(est_s * lift * jitter)
        else:
            latency, retries, fault_s = 0.0, 0, 0.0
        if integrity_s > 0.0:
            latency += float(integrity_s)
            self.device_time_s += float(integrity_s)
        self.log.append(IOEvent(name=name, nbytes=float(nbytes), n_chunks=n_chunks,
                                latency_s=latency, hit_rate=float(hit_rate), retries=retries,
                                fault_s=fault_s, integrity_s=float(integrity_s)))
        return latency

    def measure_from_estimate_batch(self, est_s: np.ndarray, n_chunks: int = 32,
                                    diversity: float = 0.5, name: str = "",
                                    hit_rates: Optional[np.ndarray] = None,
                                    nbytes: Optional[np.ndarray] = None,
                                    integrity_s: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized ``measure_from_estimate`` for one decode call's
        (n_steps,) estimates: one jitter draw per positive estimate, in
        order — the same RNG stream as the scalar path — then, event by
        event (the thermal clock advances in log order), the fault model and
        the step's re-read seconds; one IOEvent per step that charged
        anything."""
        est = np.asarray(est_s, dtype=np.float64).reshape(-1)
        extra = (np.zeros_like(est) if integrity_s is None
                 else np.asarray(integrity_s, dtype=np.float64).reshape(-1))
        lift = self.profile.interleave_lift * (1.0 + 0.1 * diversity)
        pos = est > 0.0
        jitter = np.ones_like(est)
        jitter[pos] = self.rng.lognormal(mean=0.0, sigma=self.noise, size=int(pos.sum()))
        latency = np.where(pos, est * lift * jitter, 0.0)
        for i in np.flatnonzero(pos | (extra > 0.0)):
            charged, retries, fault_s = (self._charge(float(latency[i])) if pos[i]
                                         else (0.0, 0, 0.0))
            if extra[i] > 0.0:
                charged += float(extra[i])
                self.device_time_s += float(extra[i])
            latency[i] = charged
            self.log.append(IOEvent(
                name=f"{name}[{i}]" if name else name,
                nbytes=float(nbytes[i]) if nbytes is not None else 0.0,
                n_chunks=n_chunks, latency_s=float(latency[i]),
                hit_rate=float(hit_rates[i]) if hit_rates is not None else 0.0,
                retries=retries, fault_s=fault_s, integrity_s=float(extra[i]),
            ))
        return latency


def pack_checksums(layers, names, block_rows: int = 8):
    """The bf16 pack path's integrity lane (wbits 16): one ``block_checksums``
    word per ``block_rows`` rows of each named stacked (L, N, D) leaf, as new
    ``<name>_ck`` leaves (leading L kept). The wbits-8 twin is
    ``quantize_params(checksums=True)`` over the int8 payload: each width
    checksums the bytes the kernels stream. Missing names are skipped."""
    return {name + QUANT_SUFFIX_CHECKSUM: block_checksums(layers[name], block_rows)
            for name in names if name in layers}


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
