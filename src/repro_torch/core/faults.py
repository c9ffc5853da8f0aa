"""Storage fault and data-corruption injection (the port's copy of
``repro.core.faults``).

``FaultModel`` perturbs the *time* of each simulated I/O event at the
measurement boundary of ``FlashOffloadSimulator`` (core/offload.py):
thermal throttling (a deterministic ``ThermalTrajectory`` over the device's
busy clock), tail-latency spikes and transient read failures retried with
exponential backoff. Selection keeps planning against the clean latency
table, so faults never change which rows are selected or which tokens come
out. It draws from its own ``numpy`` Generator, stream for stream the
reference's: a (profile, seed) replays the reference's outcomes exactly, and
attaching it never shifts the simulator's jitter stream.

``CorruptionModel`` perturbs the *bytes* of fetched 8-row blocks: per
fetched block and refresh epoch, with probability ``p_block``, one bit
flipped (``mode="flip"``) or the whole block zeroed (``"zero"``); a
detected corruption is re-read up to ``max_reread`` times, each re-read
corrupt again with probability ``p_stuck``. The reference draws these from
``jax.random`` keys folded over (seed, layer, epoch, site, matrix). The port
draws them from a counter-based hash of (seed, layer, epoch, site, matrix,
stream, index) in plain torch integer ops: the same bits on the CPU and on
the card, independent of the order of the calls, and computed for every
layer at once. The two frameworks' draws differ; the tests feed the
reference's draws into the port's model (``draw_blocks``,
``draw_rereads``, ``corrupt_payload`` take the draws as arguments).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ThermalTrajectory:
    """Deterministic throughput derate over device-busy time: 1.0 until
    ``onset_s`` busy seconds, a linear ramp down to ``floor`` over
    ``ramp_s``, then held; ``period_s > 0`` instead repeats the pattern
    with a linear recovery to 1.0 in the second half of each period."""

    onset_s: float = 0.0
    ramp_s: float = 1.0
    floor: float = 0.5
    period_s: float = 0.0

    def __post_init__(self):
        if not (0.0 < self.floor <= 1.0):
            raise ValueError(f"floor must be in (0, 1], got {self.floor}")
        if self.onset_s < 0 or self.ramp_s < 0 or self.period_s < 0:
            raise ValueError("onset_s/ramp_s/period_s must be >= 0")

    def scale(self, busy_s: float) -> float:
        """Throughput derate at ``busy_s`` cumulative busy seconds (1.0 =
        full speed, ``floor`` = fully throttled)."""
        t = float(busy_s)
        if self.period_s > 0.0:
            t = math.fmod(t, self.period_s)
            half = self.period_s / 2.0
            if t >= half:
                frac = (t - half) / half
                lowest = self._ramp_value(half)
                return lowest + (1.0 - lowest) * frac
        return self._ramp_value(t)

    def _ramp_value(self, t: float) -> float:
        if t <= self.onset_s:
            return 1.0
        if self.ramp_s <= 0.0:
            return self.floor
        frac = min((t - self.onset_s) / self.ramp_s, 1.0)
        return 1.0 - (1.0 - self.floor) * frac


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """One named storage-turbulence scenario (see ``FAULT_PROFILES``)."""

    name: str
    spike_prob: float = 0.0
    spike_scale: float = 4.0
    fail_prob: float = 0.0
    max_retries: int = 3
    backoff_base_s: float = 0.5e-3
    backoff_mult: float = 2.0
    throttle: Optional[ThermalTrajectory] = None

    def __post_init__(self):
        if not (0.0 <= self.spike_prob < 1.0):
            raise ValueError(f"spike_prob must be in [0, 1), got {self.spike_prob}")
        if self.spike_scale < 1.0:
            raise ValueError(f"spike_scale must be >= 1, got {self.spike_scale}")
        if not (0.0 <= self.fail_prob < 1.0):
            raise ValueError(f"fail_prob must be in [0, 1), got {self.fail_prob}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base_s < 0 or self.backoff_mult < 1.0:
            raise ValueError("backoff_base_s must be >= 0 and backoff_mult >= 1")


# the reference's named profiles: tail spikes on ~5 % of events, flaky
# reads retrying ~8 % of attempts, thermal trajectories down to 25-50 %
FAULT_PROFILES: Dict[str, FaultProfile] = {
    p.name: p
    for p in (
        FaultProfile("none"),
        FaultProfile("tail_spikes", spike_prob=0.05, spike_scale=6.0),
        FaultProfile("flaky_reads", fail_prob=0.08, max_retries=4,
                     backoff_base_s=0.25e-3, backoff_mult=2.0),
        FaultProfile("thermal_throttle",
                     throttle=ThermalTrajectory(onset_s=2e-3, ramp_s=10e-3, floor=0.25)),
        FaultProfile("thermal_cycle",
                     throttle=ThermalTrajectory(onset_s=0.0, ramp_s=10e-3, floor=0.4,
                                                period_s=40e-3)),
        FaultProfile("degraded_nvme", spike_prob=0.03, spike_scale=5.0, fail_prob=0.04,
                     max_retries=4, backoff_base_s=0.25e-3,
                     throttle=ThermalTrajectory(onset_s=2e-3, ramp_s=10e-3, floor=0.35)),
    )
}


def get_fault_profile(name: str) -> FaultProfile:
    try:
        return FAULT_PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown fault profile {name!r}; have {sorted(FAULT_PROFILES)}") from None


@dataclasses.dataclass
class FaultOutcome:
    """What the fault model did to one I/O event."""

    charged_s: float
    clean_s: float
    throttle_scale: float = 1.0
    spiked: bool = False
    retries: int = 0
    backoff_s: float = 0.0

    @property
    def extra_s(self) -> float:
        return self.charged_s - self.clean_s


class FaultModel:
    """Seeded, deterministic storage-fault injector: ``perturb(latency_s,
    busy_s)`` once per positive-latency event, in event order. Per event
    the draws are fixed (a spike draw iff ``spike_prob > 0``, then one
    failure draw per attempt iff ``fail_prob > 0``), as in the reference."""

    def __init__(self, profile: str | FaultProfile = "none", seed: int = 0):
        self.profile = profile if isinstance(profile, FaultProfile) else get_fault_profile(profile)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.n_events = 0
        self.n_spikes = 0
        self.n_retries = 0
        self.backoff_s = 0.0
        self.extra_s = 0.0
        self.min_throttle_scale = 1.0

    @property
    def enabled(self) -> bool:
        p = self.profile
        return bool(p.spike_prob > 0 or p.fail_prob > 0 or p.throttle is not None)

    def perturb(self, latency_s: float, busy_s: float) -> FaultOutcome:
        """One event's clean simulated latency → its charged latency.
        ``busy_s``: the device's busy clock before the event (the thermal
        trajectory's input); each retry re-reads at the clock advanced by
        what the event has charged so far."""
        if latency_s < 0:
            raise ValueError(f"latency_s must be >= 0, got {latency_s}")
        p = self.profile
        out = FaultOutcome(charged_s=float(latency_s), clean_s=float(latency_s))
        if latency_s == 0.0:
            return out
        self.n_events += 1
        spike_mult = 1.0
        if p.spike_prob > 0 and float(self.rng.random()) < p.spike_prob:
            spike_mult = p.spike_scale
            out.spiked = True
            self.n_spikes += 1
        base = float(latency_s) * spike_mult

        def attempt_read(elapsed_s: float):
            if p.throttle is None:
                return base, 1.0
            s = p.throttle.scale(busy_s + elapsed_s)
            self.min_throttle_scale = min(self.min_throttle_scale, s)
            return base / s, s

        read, out.throttle_scale = attempt_read(0.0)
        charged = read
        if p.fail_prob > 0:
            backoff = p.backoff_base_s
            for _ in range(p.max_retries):
                if float(self.rng.random()) >= p.fail_prob:
                    break
                out.retries += 1
                out.backoff_s += backoff
                charged += backoff
                retry_read, _ = attempt_read(charged)
                charged += retry_read
                backoff *= p.backoff_mult
            self.n_retries += out.retries
            self.backoff_s += out.backoff_s
        out.charged_s = charged
        self.extra_s += charged - out.clean_s
        return out

    def summary(self) -> Dict[str, float]:
        return {
            "profile": self.profile.name,
            "seed": self.seed,
            "events": self.n_events,
            "spikes": self.n_spikes,
            "retries": self.n_retries,
            "backoff_s": self.backoff_s,
            "fault_extra_s": self.extra_s,
            "min_throttle_scale": self.min_throttle_scale,
        }


# ---------------------------------------------------------------------------
# data-plane corruption: faults that change bytes, not just time
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CorruptionProfile:
    """One named data-corruption scenario (see ``CORRUPTION_PROFILES``):
    per fetched 8-row block and refresh epoch, with probability
    ``p_block`` one bit flipped (``"flip"``) or the block zeroed
    (``"zero"``); each re-read comes back corrupt again with probability
    ``p_stuck``, and costs the block's read plus ``backoff_base_s ·
    backoff_mult^k`` after the k-th."""

    name: str
    p_block: float = 0.0
    mode: str = "flip"
    p_stuck: float = 0.0
    backoff_base_s: float = 5e-5
    backoff_mult: float = 2.0

    def __post_init__(self):
        if not (0.0 <= self.p_block < 1.0):
            raise ValueError(f"p_block must be in [0, 1), got {self.p_block}")
        if self.mode not in ("flip", "zero"):
            raise ValueError(f"mode must be 'flip' or 'zero', got {self.mode!r}")
        if not (0.0 <= self.p_stuck < 1.0):
            raise ValueError(f"p_stuck must be in [0, 1), got {self.p_stuck}")
        if self.backoff_base_s < 0 or self.backoff_mult < 1.0:
            raise ValueError("backoff_base_s must be >= 0 and backoff_mult >= 1")


# the reference's profiles: bit_rot's flips are always transient (every
# corruption recoverable), torn_read zeroes blocks that usually re-read
# clean, degraded_nand's flips often outlast the re-read budget
CORRUPTION_PROFILES: Dict[str, CorruptionProfile] = {
    p.name: p
    for p in (
        CorruptionProfile("none"),
        CorruptionProfile("bit_rot", p_block=0.02, mode="flip", p_stuck=0.0),
        CorruptionProfile("torn_read", p_block=0.01, mode="zero", p_stuck=0.35),
        CorruptionProfile("degraded_nand", p_block=0.05, mode="flip", p_stuck=0.65),
    )
}


def get_corruption_profile(name: str) -> CorruptionProfile:
    try:
        return CORRUPTION_PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown corruption profile {name!r}; "
                       f"have {sorted(CORRUPTION_PROFILES)}") from None


# the draw streams of one (layer, epoch, site, matrix): which fetched blocks
# arrive corrupt, how many re-reads stay corrupt, and a flip's element and bit
STREAM_BLOCKS, STREAM_REREADS, STREAM_ELEM, STREAM_BIT = 0, 1, 2, 3
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c,
    through 16-bit halves of c so no product leaves int64's range: the same
    bits on every device."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer finalizer (xor-shift-multiply rounds) on
    int64 values in [0, 2^32): every shift is of a non-negative value,
    every product is masked back to 32 bits."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_words(seed: int, layer, epoch, site: int, matrix: int, stream: int,
               index: torch.Tensor) -> torch.Tensor:
    """One 32-bit word (int64 in [0, 2^32)) per draw, a pure function of
    (seed, layer, epoch, site, matrix, stream, index): ``layer`` and
    ``epoch`` broadcast against ``index`` (e.g. (L, 1) against (nb,) gives
    every layer's words at once)."""
    dev = index.device
    h = _seed_word(seed)
    h = _mix32(torch.as_tensor(layer, dtype=torch.int64, device=dev) ^ h)
    h = _mix32(h ^ torch.as_tensor(epoch, dtype=torch.int64, device=dev))
    h = _mix32(h ^ ((site * 8 + matrix) * 16 + stream))
    return _mix32(_mix32(h ^ index.to(torch.int64)))


@functools.lru_cache(maxsize=None)
def _seed_word(seed: int) -> int:
    """The seed's 64 bits folded into one mixed 32-bit word (host int)."""
    h = _mix32(torch.tensor([(seed & _M32) ^ 0x5BD1E995], dtype=torch.int64))
    return int(_mix32(h ^ ((seed >> 32) & _M32)))


class CorruptionModel:
    """Seeded, deterministic data-plane corruption. The draws of one
    (layer, epoch, site, matrix) come from ``uniforms`` and ``integers``
    (the counter-based hash); ``draw_blocks``, ``draw_rereads``,
    ``backoff_seconds`` and ``corrupt_payload`` turn draws into outcomes
    exactly as the reference does, and take the draws as arguments."""

    def __init__(self, profile: str | CorruptionProfile = "none", seed: int = 0,
                 max_reread: int = 2, recover: bool = True):
        self.profile = (profile if isinstance(profile, CorruptionProfile)
                        else get_corruption_profile(profile))
        self.seed = int(seed)
        if max_reread < 0:
            raise ValueError(f"max_reread must be >= 0, got {max_reread}")
        self.max_reread = int(max_reread)
        self.recover = bool(recover)

    @property
    def enabled(self) -> bool:
        return self.profile.p_block > 0.0

    # -- the draws ------------------------------------------------------------
    def uniforms(self, stream: int, layer, epoch, site: int, matrix: int,
                 index: torch.Tensor) -> torch.Tensor:
        """f32 uniforms in (0, 1), one per ``index`` (broadcast against
        ``layer``/``epoch``): the word's top 24 bits, centred in their
        interval, so log(u) is finite."""
        w = hash_words(self.seed, layer, epoch, site, matrix, stream, index)
        return ((w >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)

    def integers(self, stream: int, layer, epoch, site: int, matrix: int,
                 index: torch.Tensor, high: int) -> torch.Tensor:
        """int64 draws in [0, high), one per ``index``."""
        return hash_words(self.seed, layer, epoch, site, matrix, stream, index) % high

    # -- draws → outcomes (the reference's arithmetic) ---------------------------
    def draw_blocks(self, fetched_blocks: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Which fetched blocks arrive corrupt: ``fetched & (u < p_block)``
        (resident rows never touch the storage data plane)."""
        # an f32 scalar kept on the host: no copy to the card, no sync
        return fetched_blocks & (u < torch.tensor(self.profile.p_block, dtype=torch.float32))

    def draw_rereads(self, corrupt: torch.Tensor, u: Optional[torch.Tensor]):
        """Per corrupt block: (re-reads charged, int32; recovered, bool).
        The run of still-corrupt re-reads is geometric with persistence
        ``p_stuck``, ``floor(log u / log p_stuck)`` in f32; a block recovers
        iff a clean re-read lands within ``max_reread``. Recovery off, or a
        budget of 0, charges and recovers nothing."""
        zeros = torch.zeros(corrupt.shape, dtype=torch.int32, device=corrupt.device)
        if not self.recover or self.max_reread == 0:
            return zeros, torch.zeros_like(corrupt)
        p = self.profile
        if p.p_stuck <= 0.0:
            fails = zeros
        else:
            lp = torch.log(torch.tensor(p.p_stuck, dtype=torch.float32))  # host f32 scalar
            fails = torch.floor(torch.log(u) / lp).to(torch.int32)
        rereads = torch.where(corrupt, torch.clamp(fails + 1, max=self.max_reread), zeros)
        return rereads, corrupt & (fails < self.max_reread)

    def backoff_seconds(self, rereads: torch.Tensor) -> torch.Tensor:
        """f32 backoff seconds of ``rereads`` attempts per block: Σ_k
        base · mult^k, the ladder ``FaultModel`` charges retries."""
        p = self.profile
        r = rereads.to(torch.float32)
        base = torch.tensor(p.backoff_base_s, dtype=torch.float32)  # host f32 scalar
        if p.backoff_mult == 1.0:
            return base * r
        m = torch.full_like(r, p.backoff_mult)
        return base * (torch.pow(m, r) - 1.0) / (m - 1.0)

    def corrupt_payload(self, w: torch.Tensor, corrupt_blocks: torch.Tensor,
                        elem: Optional[torch.Tensor] = None, bit: Optional[torch.Tensor] = None,
                        block_rows: int = 8) -> torch.Tensor:
        """A damaged copy of one (N, D) payload: ``"zero"`` zeroes every row
        of a corrupt block; ``"flip"`` XORs bit ``bit[b]`` of element
        ``elem[b]`` (row-major within the block) of each corrupt block b,
        on the element's raw bits, so int8 and float payloads damage alike.
        ``elem``/``bit``: (N // block_rows,) draws."""
        n, d = w.shape
        nb = n // block_rows
        if self.profile.mode == "zero":
            keep = ~corrupt_blocks.repeat_interleave(block_rows)
            return torch.where(keep[:, None], w, torch.zeros((), dtype=w.dtype, device=w.device))
        u = w.reshape(nb, block_rows * d).clone()
        idx = torch.arange(nb, device=w.device)
        flipped = flip_bits(u[idx, elem], bit)
        u[idx, elem] = torch.where(corrupt_blocks, flipped, u[idx, elem])
        return u.reshape(n, d)


def flip_bits(values: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """``values`` with bit ``bit`` of each element's raw representation
    flipped (1-, 2- or 4-byte elements), same dtype."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}[values.element_size()]
    raw = values.view(ints).to(torch.int64)
    width = 8 * values.element_size()
    raw = (raw ^ (1 << bit.to(torch.int64))) & ((1 << width) - 1)
    raw = torch.where(raw >= 1 << (width - 1), raw - (1 << width), raw)
    return raw.to(ints).view(values.dtype)
