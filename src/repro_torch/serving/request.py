"""Request lifecycle for the continuous-batching serve stack (the port's
copy of ``repro.serving.request``).

A Request is one independent generation stream: a prompt (token ids plus an
optional vision frontend), a decode budget, and timing marks filled in by
the Scheduler as the request moves WAITING → RUNNING → FINISHED on the
simulated clock. The PoissonArrivalDriver fabricates open-loop traffic —
exponential inter-arrival gaps at a configurable rate — which is the arrival
process the serving benchmarks replay.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One generation request. ``prompt`` is a model batch dict of tensors
    with leading batch dim 1 ({"tokens": (1, s), "frontend": (1, n, d)?})."""

    rid: int
    prompt: Dict[str, torch.Tensor]
    max_new_tokens: int
    arrival_s: float = 0.0
    # SLO deadline: the request should finish within deadline_s of arrival
    # (None = best-effort). The scheduler admits earliest-deadline-first
    # when deadlines are present, counts attainment in SchedulerStats, and
    # may preempt a deadline-blown request (evict-and-requeue) to free its
    # slot for one that can still make its deadline.
    deadline_s: Optional[float] = None

    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None
    tokens_out: List[int] = dataclasses.field(default_factory=list)

    # timing marks on the scheduler's simulated clock
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    # times this request was preempted (evicted mid-decode and requeued)
    preemptions: int = 0

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt["tokens"].shape[1])

    @property
    def done(self) -> bool:
        return len(self.tokens_out) >= self.max_new_tokens

    def latency_s(self) -> float:
        """End-to-end request latency (arrival → last token)."""
        if self.finished_s is None:
            raise ValueError(f"request {self.rid} not finished")
        return self.finished_s - self.arrival_s

    def ttft_s(self) -> float:
        """Time to first token (arrival → first decoded token)."""
        if self.first_token_s is None:
            raise ValueError(f"request {self.rid} has no first token yet")
        return self.first_token_s - self.arrival_s

    @property
    def deadline_abs_s(self) -> float:
        """Absolute deadline on the simulated clock (inf = best-effort)."""
        if self.deadline_s is None:
            return float("inf")
        return self.arrival_s + self.deadline_s

    def met_deadline(self) -> bool:
        """Whether the finished request met its SLO deadline. Best-effort
        requests (no deadline) trivially meet it."""
        if self.deadline_s is None:
            return True
        return self.latency_s() <= self.deadline_s


class PoissonArrivalDriver:
    """Open-loop arrival process: requests arrive with Exp(rate) gaps.

    ``make_request(rid)`` builds the prompt/budget for request ``rid`` (the
    driver only owns timing). ``generate(n)`` returns n WAITING requests
    with monotonically increasing ``arrival_s``.
    """

    def __init__(
        self,
        rate_rps: float,
        make_request: Callable[[int], Request],
        seed: int = 0,
    ):
        if rate_rps <= 0:
            raise ValueError("rate_rps must be positive")
        self.rate_rps = rate_rps
        self.make_request = make_request
        self.rng = np.random.default_rng(seed)
        self._next_rid = 0
        self._clock = 0.0

    def generate(self, n: int) -> List[Request]:
        out = []
        for _ in range(n):
            self._clock += float(self.rng.exponential(1.0 / self.rate_rps))
            req = self.make_request(self._next_rid)
            req.arrival_s = self._clock
            req.state = RequestState.WAITING
            self._next_rid += 1
            out.append(req)
        return out
