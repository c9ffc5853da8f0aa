"""Continuous-batching scheduler over the slot-mode ServeEngine (the port's
copy of ``repro.serving.scheduler``).

Iteration-level scheduling, adapted to the flash-offload simulator: the
engine's batch dimension is a fixed array of request slots; requests are
admitted into free slots earliest-deadline-first (plain FCFS when no
request carries a ``deadline_s``; prefill writes their KV into the shared
cache), every decode round runs the engine's fused decode loop across ALL
slots at once (one host transfer a round, whose tokens the scheduler
reads), and slots are recycled the moment their
request hits its token budget — no waiting for the rest of the batch.
Deadline-blown running requests can be preempted (evict-and-requeue) to
free their slot for a request that can still meet its SLO; see the
``Scheduler`` docstring for the exact policy.

Time is simulated: the clock advances by the engine's charged per-step
latency — the overlapped I/O–compute pipeline's critical path by default
(serial Σ io + Σ compute with ``overlap=False``; the quantities the paper's
policies change) plus an optional extra per-token compute constant — so
tokens/s and request-latency percentiles reflect the policy under test
rather than host-python speed. Wall time is tracked separately by the
engine's StepStats.

**Bubble-aware admission** (``admit_in_bubbles``, default on): the
overlapped pipeline's per-step ``StepStats.stall`` measures time the
compute engine spent idle waiting on an unfinished fetch, and
``StepStats.bubble_s`` time the fetch engine spent idle waiting for a free
buffer. Both are idle engine windows inside an already-charged round —
schedulable capacity: a waiting request's admission work (prefill compute
in the stall windows, its weight streaming in the fetch-idle bubbles; a
first-order model that does not distinguish which lane absorbs which part)
can ride inside them instead of extending the clock after the round. The
scheduler banks each decode round's measured stall + bubble seconds as
credit and discounts subsequent admissions' prefill charge against it, so
admission effectively happens *during* the round rather than serially at
the boundary. ``admitted_during_stall`` / ``stall_hidden_s`` count the
realized hiding (also surfaced via the engine's ``io_summary`` as
``bubble_utilization`` = hidden ÷ (stall + bubble)). Credit only accrues
when the engine actually charges the overlapped timeline (``overlap=True``
and a positive prefetch depth) — under the serial charge there is no
pipeline and no idle windows.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from .engine import ServeEngine
from .kv_pool import KVPoolExhausted
from .request import Request, RequestState


@dataclasses.dataclass
class SchedulerStats:
    """Aggregate serving metrics over one ``run``.

    With zero finished requests every percentile is NaN (not a fabricated
    0.0) so downstream asserts can never pass vacuously. The SLO lanes:
    ``deadlines`` counts finished requests that carried a ``deadline_s``,
    ``deadlines_met`` how many met it, ``slo_attainment`` their ratio (NaN
    when no finished request had a deadline), and ``preempted`` how many
    evict-and-requeue preemptions of deadline-blown requests occurred.
    """

    finished: int
    sim_time_s: float
    decode_tokens: int
    tokens_per_s: float
    latency_p50_s: float
    latency_p95_s: float
    ttft_p50_s: float
    # bubble-aware admission: requests admitted inside measured decode
    # stall windows, and the prefill seconds those windows absorbed
    admitted_during_stall: int = 0
    stall_hidden_s: float = 0.0
    # SLO / deadline accounting
    latency_p99_s: float = float("nan")
    deadlines: int = 0
    deadlines_met: int = 0
    slo_attainment: float = float("nan")
    preempted: int = 0

    def row(self) -> str:
        return (
            f"{self.finished:4d} req  {self.decode_tokens:5d} tok  "
            f"{self.tokens_per_s:8.1f} tok/s  "
            f"p50 {self.latency_p50_s*1e3:7.2f} ms  "
            f"p95 {self.latency_p95_s*1e3:7.2f} ms  "
            f"p99 {self.latency_p99_s*1e3:7.2f} ms  "
            f"slo {self.slo_attainment:5.3f}"
        )


class Scheduler:
    """Continuous batching over ``engine.batch_size`` slots.

    ``round_tokens`` is the fused-loop granularity: each round decodes that
    many tokens for every running slot in ONE decode call, then reconciles
    (finishes, evictions, admissions) on the host. Larger rounds amortize
    more host overhead but over-decode up to round_tokens-1 tokens for a
    request that finishes mid-round (the tokens are dropped; the slot is
    recycled at the round boundary).

    **Deadline-aware scheduling.** Admission is earliest-deadline-first
    over the arrived waiting requests: feasible deadline-carrying requests
    first (by absolute deadline), then best-effort requests (no deadline —
    their deadline is +inf, so the order among them is FCFS by arrival:
    a workload without deadlines schedules exactly as the original FCFS
    scheduler), then already-blown requests last (readmitting a blown
    request ahead of a feasible one would just spread the miss). At each
    round boundary a deadline-blown RUNNING request may be **preempted**:
    evicted from its slot and requeued WAITING, freeing the slot for an
    arrived request that can still make its deadline. Eviction is cheap
    here because chunk plans and residency state live in the decode carry
    per *slot*, not per request — the readmitted request simply prefills
    into whatever slot frees up. Preemption restarts the request's
    generation (greedy decode reproduces the same tokens deterministically)
    and is capped at once per request, so every request still drains. A
    preempted-and-requeued request keeps its original ``arrival_s`` (its
    latency accounts the full story) and counts in ``stats().preempted``.

    **KV-page-pressure preemption.** With paged KV, decode-time page
    growth can outrun the pool even though admission fit (admission only
    reserves the prompt's pages). ``decode_slots`` pre-checks the whole
    round's growth and raises ``KVPoolExhausted`` *before* allocating
    anything; the scheduler then preempts the least-urgent co-runner
    (latest deadline, then latest arrival — the EDF mirror) via the same
    evict-and-requeue path and retries the round. ``stats().preempted``
    counts both deadline and page-pressure preemptions.
    """

    def __init__(
        self,
        engine: ServeEngine,
        round_tokens: int = 4,
        compute_s_per_token: float = 0.0,
        admit_in_bubbles: bool = True,
    ):
        if round_tokens < 1:
            raise ValueError("round_tokens must be >= 1")
        self.engine = engine
        self.n_slots = engine.batch_size
        self.round_tokens = round_tokens
        self.compute_s_per_token = compute_s_per_token
        # bubble-aware admission only has windows to use when the engine
        # actually charges the overlapped timeline
        self.admit_in_bubbles = (
            admit_in_bubbles and engine.overlap and engine.prefetch_depth > 0
        )
        self.stall_credit_s = 0.0  # banked decode-stall seconds (see module doc)
        self.admitted_during_stall = 0
        self.stall_hidden_s = 0.0
        self.waiting: Deque[Request] = deque()
        self.running: List[Optional[Request]] = [None] * self.n_slots
        self.finished: List[Request] = []
        self.now_s = 0.0
        self.decode_tokens = 0
        self.preempted = 0
        # per-slot current input token fed to the next decode round, on the
        # card (admissions and evictions write single slots there)
        self._slot_tokens = torch.zeros((self.n_slots, 1), dtype=torch.int64,
                                        device=engine.torch_device)
        engine.enable_slots()

    # -- admission / eviction ------------------------------------------------
    def submit(self, requests) -> None:
        for r in requests if isinstance(requests, (list, tuple)) else [requests]:
            self.waiting.append(r)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.running) if r is None]

    def num_running(self) -> int:
        return self.n_slots - len(self.free_slots())

    def _admission_key(self, req: Request):
        """EDF admission order over arrived waiting requests: feasible
        deadline requests by absolute deadline, then best-effort (inf
        deadline ⇒ FCFS by arrival among them), then already-blown
        requests last. Deterministic tie-break by arrival then rid."""
        dl = req.deadline_abs_s
        blown = dl < self.now_s
        return (blown, dl, req.arrival_s, req.rid)

    def _pop_next_waiting(self) -> Optional[Request]:
        """The next arrived waiting request under the admission order, or
        None if nothing has arrived yet. With no deadlines anywhere this is
        exactly the FCFS head (all keys are (False, inf, arrival, rid))."""
        arrived = [r for r in self.waiting if r.arrival_s <= self.now_s]
        if not arrived:
            return None
        req = min(arrived, key=self._admission_key)
        self.waiting.remove(req)
        return req

    def _admit_ready(self) -> int:
        """Admit WAITING requests that have arrived into free slots
        (earliest-deadline-first; pure FCFS when no request carries a
        deadline). Prefill advances the clock by the request's simulated
        weight-stream time, minus whatever fits into banked decode-stall
        credit (the admission rode an earlier round's I/O bubbles — see
        module doc). Returns the number admitted."""
        admitted = 0
        for slot in self.free_slots():
            req = self._pop_next_waiting()
            if req is None:
                break
            if not self.engine.kv_can_admit(req.prompt):
                # paged KV: a free slot is not enough — the pool must cover
                # the prompt's unshared pages. Requeue and retry once a
                # running request finishes (releasing its pages); if nothing
                # is running, nothing will ever free and the prompt can
                # never fit this pool.
                self.waiting.appendleft(req)
                if self.num_running() == 0 and admitted == 0:
                    raise RuntimeError(
                        f"request {req.rid} can never be admitted: its "
                        "prompt needs more KV pages than the pool can free"
                    )
                break
            last, prefill_sim = self.engine.admit_slot(slot, req.prompt)
            prefill_sim = float(prefill_sim)
            if self.admit_in_bubbles and self.stall_credit_s > 0.0:
                hidden = min(self.stall_credit_s, prefill_sim)
                self.stall_credit_s -= hidden
                prefill_sim -= hidden
                self.admitted_during_stall += 1
                self.stall_hidden_s += hidden
                self.engine.note_stall_admission(hidden)
            self.now_s += prefill_sim
            req.state = RequestState.RUNNING
            req.slot = slot
            req.admitted_s = self.now_s
            self.running[slot] = req
            self._slot_tokens[slot] = torch.argmax(last, dim=-1)
            admitted += 1
        return admitted

    def _evict(self, req: Request) -> None:
        req.state = RequestState.FINISHED
        if req.finished_s is None:
            req.finished_s = self.now_s
        # release the slot's KV storage through the engine's single release
        # funnel (paged: page refs drop; dense: the slot length zeroes) so
        # freed-byte accounting can't drift from what the pool actually holds
        self.engine.release_slot(req.slot)
        # reset the freed slot's decode input: a free slot keeps riding the
        # fused loop, and its garbage activations feed the BATCHED chunk
        # selection — leaving the dead occupant's last token here would make
        # selection (and so every active slot's tokens) depend on KV-layout
        # garbage that differs between the dense and paged caches
        self._slot_tokens[req.slot] = 0
        self.running[req.slot] = None
        req.slot = None
        self.finished.append(req)

    def _requeue(self, req: Request) -> None:
        """Evict-and-requeue one RUNNING request (shared by deadline and
        KV-page-pressure preemption). Frees the slot's pages through the
        engine's single release funnel — a preempted request re-prefills
        from scratch on readmission, so holding its old pages would leak
        refs — and restarts generation: greedy decode is deterministic, so
        the regenerated tokens are identical. ``first_token_s`` keeps the
        original first-token mark (the stream already started once);
        latency runs to the final finish, accounting the preemption's full
        cost."""
        self.engine.release_slot(req.slot)
        self._slot_tokens[req.slot] = 0
        self.running[req.slot] = None
        req.slot = None
        req.state = RequestState.WAITING
        req.preemptions += 1
        req.tokens_out = []
        self.waiting.append(req)
        self.preempted += 1

    def _preempt_blown(self) -> int:
        """Preempt deadline-blown RUNNING requests: evict from the slot and
        requeue WAITING (the slot-local decode carry makes this a pure slot
        recycle — the readmission prefills fresh, and greedy decode
        regenerates the same tokens deterministically). Only fires when an
        arrived waiting request can still make its own deadline (otherwise
        the swap buys nothing), preempts at most that many slots, and never
        preempts the same request twice — so every request still drains.
        Returns the number preempted."""
        feasible = sum(
            1 for r in self.waiting
            if r.arrival_s <= self.now_s and self.now_s <= r.deadline_abs_s
        )
        n = 0
        for req in list(self.running):
            if n >= feasible:
                break
            if req is None or req.done:
                continue
            if req.deadline_abs_s < self.now_s and req.preemptions < 1:
                self._requeue(req)
                n += 1
        return n

    def _preempt_for_pages(self) -> bool:
        """Preempt ONE running request to free KV pages for a decode round
        that cannot grow (paged KV: ``decode_slots`` pre-checks the whole
        round's page growth and raises ``KVPoolExhausted`` before touching
        any state). Victim is the least-urgent runner — latest absolute
        deadline, ties broken by latest arrival then rid (the mirror of
        the EDF admission order) — and requeues through ``_requeue`` like
        a deadline preemption. Returns False when there is no co-runner to
        preempt (preempting the lone runner frees nothing it does not
        itself need): the pool genuinely cannot serve this decode."""
        runners = [r for r in self.running if r is not None and not r.done]
        if len(runners) < 2:
            return False
        victim = max(
            runners, key=lambda r: (r.deadline_abs_s, r.arrival_s, r.rid)
        )
        self._requeue(victim)
        return True

    # -- decode rounds -------------------------------------------------------
    def step(self) -> bool:
        """One scheduler iteration: admit, decode a round, reconcile.
        Returns False when there is nothing left to do."""
        # fast-forward an idle engine to the next arrival (requeued
        # preemptees can put the deque out of arrival order — scan it)
        if self.num_running() == 0:
            if not self.waiting:
                return False
            self.now_s = max(
                self.now_s, min(r.arrival_s for r in self.waiting)
            )
        self._admit_ready()
        if self.num_running() == 0:
            return bool(self.waiting)

        n_stats0 = len(self.engine.stats)
        while True:
            try:
                toks, step_lat = self.engine.decode_slots(
                    self._slot_tokens, self.round_tokens
                )
                break
            except KVPoolExhausted:
                # decode-time page growth cannot fit the pool: free pages by
                # preempting the least-urgent co-runner and retry the round
                # (the engine raised before allocating, so retry is safe)
                if not self._preempt_for_pages():
                    raise RuntimeError(
                        "KV page pool exhausted mid-decode with no "
                        "co-runner to preempt: the lone running request's "
                        "decode growth exceeds the pool — raise kv_pages "
                        "or lower max_new_tokens"
                    )
        if self.admit_in_bubbles:
            # bank this round's measured idle windows (compute stalls +
            # fetch-engine bubbles) as admission credit
            self.stall_credit_s += sum(
                s.stall_s + s.bubble_s
                for s in self.engine.stats[n_stats0:] if s.kind == "decode"
            )
        toks_np = toks.numpy()  # (slots, round_tokens), already on the host
        active = [r for r in self.running if r is not None]
        for i, sim in enumerate(step_lat):
            # the batch shares each model step; clock advances once per step
            self.now_s += float(sim) + self.compute_s_per_token
            for req in active:
                if req.done:
                    continue  # over-decoded filler for an already-done request
                req.tokens_out.append(int(toks_np[req.slot, i]))
                self.decode_tokens += 1
                if req.first_token_s is None:
                    req.first_token_s = self.now_s
                if req.done:
                    # latency marks the token's mid-round time; the slot is
                    # only recycled at the round boundary below
                    req.finished_s = self.now_s
        self._slot_tokens = toks[:, -1:].to(self.engine.torch_device)
        for req in list(active):
            if req.done:
                self._evict(req)
        self._preempt_blown()
        return bool(self.waiting) or self.num_running() > 0

    def run(self, max_rounds: int = 100_000) -> SchedulerStats:
        """Drive until every submitted request has finished."""
        rounds = 0
        while self.step():
            rounds += 1
            if rounds >= max_rounds:
                raise RuntimeError(f"scheduler did not drain in {max_rounds} rounds")
        return self.stats()

    def stats(self) -> SchedulerStats:
        if self.finished:
            lats = np.array([r.latency_s() for r in self.finished])
            ttfts = np.array([r.ttft_s() for r in self.finished])
            p50, p95, p99 = (
                float(np.percentile(lats, q)) for q in (50, 95, 99)
            )
            ttft_p50 = float(np.percentile(ttfts, 50))
        else:
            # no finished requests → NaN percentiles, never a fabricated
            # 0.0 a bench floor could pass vacuously
            p50 = p95 = p99 = ttft_p50 = float("nan")
        with_dl = [r for r in self.finished if r.deadline_s is not None]
        met = sum(1 for r in with_dl if r.met_deadline())
        return SchedulerStats(
            finished=len(self.finished),
            sim_time_s=self.now_s,
            decode_tokens=self.decode_tokens,
            tokens_per_s=self.decode_tokens / max(self.now_s, 1e-12),
            latency_p50_s=p50,
            latency_p95_s=p95,
            ttft_p50_s=ttft_p50,
            admitted_during_stall=self.admitted_during_stall,
            stall_hidden_s=self.stall_hidden_s,
            latency_p99_s=p99,
            deadlines=len(with_dl),
            deadlines_met=met,
            slo_attainment=(met / len(with_dl)) if with_dl else float("nan"),
            preempted=self.preempted,
        )
