"""Adaptive degradation control for the offloaded decode path (the port's
copy of ``repro.serving.degrade``; pure numpy, so ported line for line).

When the storage device degrades (thermal throttle, retry storms — see
core/faults.py), every chunk the selector planned against the clean
``LatencyTable`` costs more than it priced. The ``DegradationController``
watches the EWMA of the measured-vs-estimated step latency ratio at each
decode-call boundary and, while the device looks degraded, tightens the
selection budgets through the plan's ``bscale`` lane
(``sparse_exec.set_plan_budget_scale``), then relaxes them once the device
recovers. Detected corruption feeds the same loop as a second signal
(``observe_corruption``).

State machine (two thresholds give hysteresis):

                 ewma > degrade_ratio            ewma < recover_ratio
    HEALTHY ───────────────────────▶ DEGRADED ───────────────────────▶
      ▲            (scale -= step,      │          (scale += step,
      │             clamp min_scale)    │           clamp 1.0)
      └─────────────────────────────────┘  back to HEALTHY at scale 1.0

The engine observes and acts only at decode-call boundaries, so the fused
and the per-token loops see the same control; a healthy device's ratio is
centred at 1.0 (the engine divides out the deterministic lift), so the
scale stays 1.0, which is bit-exact the static budgets.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class DegradationController:
    """EWMA feedback controller on the measured/estimated latency ratio.

    ``observe(ratios)`` takes the per-step ratios of one decode call
    (already normalized by the deterministic lift, so healthy ≈ 1.0) and
    updates the EWMA; ``scale`` is the budget multiplier the engine writes
    into the plan before the *next* decode call.
    """

    def __init__(
        self,
        degrade_ratio: float = 1.6,
        recover_ratio: float = 1.25,
        alpha: float = 0.5,
        step: float = 0.2,
        min_scale: float = 0.4,
        corruption_ratio_gain: float = 20.0,
    ):
        if not (recover_ratio < degrade_ratio):
            raise ValueError(
                f"need recover_ratio < degrade_ratio for hysteresis, got "
                f"{recover_ratio} >= {degrade_ratio}"
            )
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if not (0.0 < step <= 1.0):
            raise ValueError(f"step must be in (0, 1], got {step}")
        if not (0.0 < min_scale <= 1.0):
            raise ValueError(f"min_scale must be in (0, 1], got {min_scale}")
        if corruption_ratio_gain < 0.0:
            raise ValueError(
                f"corruption_ratio_gain must be >= 0, got {corruption_ratio_gain}"
            )
        self.degrade_ratio = float(degrade_ratio)
        self.recover_ratio = float(recover_ratio)
        self.alpha = float(alpha)
        self.step = float(step)
        self.min_scale = float(min_scale)
        self.corruption_ratio_gain = float(corruption_ratio_gain)
        self.scale = 1.0
        self.ewma = 1.0
        # lifetime accounting (engine.fault_summary surfaces these)
        self.observations = 0
        self.tighten_steps = 0
        self.relax_steps = 0
        self.calls_degraded = 0

    @property
    def degraded(self) -> bool:
        return self.scale < 1.0

    def observe(self, ratios) -> float:
        """Fold one decode call's per-step measured/estimated ratios into
        the EWMA and move the budget scale one step if a threshold is
        crossed. Non-finite / non-positive entries (zero-I/O reuse steps)
        are ignored. Returns the new scale."""
        r = np.asarray(ratios, dtype=np.float64).reshape(-1)
        r = r[np.isfinite(r) & (r > 0.0)]
        if r.size == 0:
            return self.scale
        self.observations += int(r.size)
        # one EWMA update per observed step, in order — a long degraded
        # call converges within the call, not one alpha-step per call
        for v in r:
            self.ewma = (1.0 - self.alpha) * self.ewma + self.alpha * float(v)
        if self.ewma > self.degrade_ratio:
            new = max(self.min_scale, self.scale - self.step)
            if new < self.scale:
                self.tighten_steps += 1
            self.scale = new
        elif self.ewma < self.recover_ratio and self.scale < 1.0:
            self.scale = min(1.0, self.scale + self.step)
            self.relax_steps += 1
        if self.degraded:
            self.calls_degraded += 1
        return self.scale

    def observe_corruption(self, rate: float) -> float:
        """Fold one decode call's corruption rate (detected corrupt blocks
        per fetched block, see engine._observe_corruption) in as a SECOND
        degrade signal, mapped onto the latency-ratio axis: a clean call
        (rate 0) observes the healthy 1.0, a corrupting device observes
        ``1.0 + corruption_ratio_gain * rate`` — with the default gain of
        20.0, a sustained ~3% block-corruption rate crosses the default
        degrade threshold (1.6) and tightens the budget, which shrinks the
        fetch footprint and with it the exposure to further corruption.
        Non-finite or negative rates are ignored. Returns the new scale."""
        if not np.isfinite(rate) or rate < 0.0:
            return self.scale
        return self.observe([1.0 + self.corruption_ratio_gain * rate])

    def summary(self) -> Dict[str, float]:
        return {
            "scale": self.scale,
            "ewma_ratio": self.ewma,
            "observations": self.observations,
            "tighten_steps": self.tighten_steps,
            "relax_steps": self.relax_steps,
            "calls_degraded": self.calls_degraded,
        }
