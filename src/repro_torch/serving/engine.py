"""ServeEngine: one stream of lockstep requests with flash-offload
simulation (the port's copy of the classic single-stream mode of
``repro.serving.engine``).

``prefill(batch)`` runs the dense prompt forward (a VLM prompt's vision
tokens first); ``append_frame(frame)`` extends the cache by one video
frame's tokens, selecting every site's mask from the frame's activations;
``decode(tok, n)`` runs the fused decode loop: n greedy steps on the
device — the plan refresh is the host-known ``step % plan_refresh_interval
== 0``, the kernel tables have a static width, and the greedy selection
exits early on the device — then ONE host sync brings back every step's
per-layer I/O estimates and plan counters, which the simulator, the
prefetch pipeline and ``StepStats`` price exactly as the reference does
after its ``lax.scan``. ``decode_per_token`` runs the same step function
with one host sync per token (the reference's baseline loop); its tokens
are byte-identical to ``decode``'s. ``reprice_timeline(depth)`` re-runs
the prefetch timeline of the logged decode calls at another depth.

``cache_mb`` turns on the dynamic residency cache (paper §5,
``SparseExecution``): only cache-miss rows are charged, and
``io_summary``'s ``cache_hit_rate`` reads the plan's real hits.

``method``: "chunk" | "topk" | "dense" stream weights from the simulated
flash through ``SparseExecution`` ("dense" re-streams every matrix every
step); "dense_free" keeps the weights resident — dense compute, no
``SparseExecution``, zero I/O.

``fault_profile`` attaches a seeded ``FaultModel`` to the simulator's
measurement boundary (time only: tokens never change); ``degrade`` runs the
``DegradationController``, which reads each decode call's measured-vs-
estimated ratios (and the detected-corruption rate) and writes the next
call's budget scale into the plan's ``bscale`` lane; ``corruption_profile``
damages fetched blocks, which the refresh verifies against the ``_ck``
lanes packed at init and, with ``recover``, heals through the ladder
(``SparseExecution``). ``fault_summary`` and ``io_summary``'s ``fault_*``,
``corruptions_*`` and ``integrity_reread_s`` keys report them.

Not ported yet: slot mode / the scheduler (with its deadlines), paged KV
and sharded meshes.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.faults import CorruptionModel, FaultModel
from ..core.latency_model import MB
from ..core.offload import ComputeModel, FlashOffloadSimulator, pack_checksums
from ..core.pipeline import PipelineModel, PipelineTimeline, overlap_efficiency
from ..kernels.backend import validate_backend
from ..kernels.quantize import quantize_params
from ..models.model import Model
from ..models.transformer import SPARSE_WEIGHT_NAMES
from .degrade import DegradationController
from .sparse_exec import (
    INTEGRITY_COUNTER_KEYS,
    KERNEL_BLOCK_ROWS,
    WBITS_CHOICES,
    SparseExecution,
    plan_hit_miss,
    plan_integrity_counters,
    plan_transfer_bytes,
    reset_plan_counters,
    set_plan_budget_scale,
    validate_method,
)


@dataclasses.dataclass
class StepStats:
    kind: str  # prefill | frame | decode
    tokens: int
    io_est_s: float
    io_sim_s: float
    select_overhead_s: float
    wall_s: float
    hit_rows: float = 0.0
    miss_rows: float = 0.0
    nbytes: float = 0.0
    compute_s: float = 0.0
    serial_s: float = 0.0
    overlap_s: float = 0.0
    stall_s: float = 0.0
    bubble_s: float = 0.0


# the io_summary() keys of the port — the reference's IO_SUMMARY_KEYS minus
# the scheduler and paged-KV lanes
IO_SUMMARY_KEYS = (
    "io_est_s",
    "io_sim_s",
    "steps",
    "hit_rows",
    "miss_rows",
    "cache_hit_rate",
    "io_bytes",
    "select_overhead_s",
    "decode_compute_s",
    "decode_serial_s",
    "decode_overlap_s",
    "decode_stall_s",
    "decode_bubble_s",
    "overlap_efficiency",
    "fault_events",
    "fault_spikes",
    "fault_retries",
    "fault_backoff_s",
    "fault_extra_s",
    "min_throttle_scale",
    "corruptions_detected",
    "corruptions_recovered",
    "corruptions_substituted",
    "corruptions_dropped",
    "integrity_reread_s",
)


class ServeEngine:
    # retention bound of the per-layer I/O log behind reprice_timeline
    _LAYER_IO_LOG_MAX_STEPS = 4096

    def __init__(self, model: Model, params, max_seq: int, batch_size: int,
                 device: str = "nano", sparsity=0.4, method: str = "chunk",
                 reorderings: Optional[dict] = None, seed: int = 0,
                 plan_refresh_interval: int = 1, cache_mb: Optional[float] = None,
                 overlap: bool = True, prefetch_depth: int = 1,
                 backend: str = "reference", wbits: int = 16, torch_device=None,
                 fault_profile=None, fault_seed: int = 0, degrade: bool = False,
                 corruption_profile=None, corruption_seed: int = 0, max_reread: int = 2,
                 recover: bool = True):
        """``device``: the simulated flash profile ("nano" | "agx").
        ``torch_device``: where the model runs — ``cuda`` unless the caller
        passes another device (the weights must already live there).
        ``backend``: "reference" (the kernels' schedule twin) or "kernel"
        (K1/K2 off the decode plan's chunk tables); tokens are
        byte-identical across the two. ``wbits=8`` quantizes the offloaded
        matrices once (int8 payload + per-8-row scales); ``dense_free``
        streams nothing and ignores it. ``cache_mb``: the DRAM budget (MB)
        of the residency cache; None takes the flash profile's
        ``dram_cache_mb``, 0 turns it off. ``reorderings``: per-site
        ``Reordering``s (reference backend only). ``prefetch_depth``: any
        depth ≥ 0; it prices the pipeline, and the kernels' ring runs at
        most ``MAX_PREFETCH_DEPTH`` ahead — tokens are byte-identical at
        every depth.

        ``fault_profile`` / ``fault_seed``: a ``FAULT_PROFILES`` name (or a
        ``FaultProfile``) perturbing the simulator's measured events with
        its own seeded stream — time only. ``degrade``: the adaptive
        ``DegradationController`` (a selecting method only).
        ``corruption_profile`` / ``corruption_seed`` / ``max_reread`` /
        ``recover``: data-plane corruption and the integrity ladder; the
        ``_ck`` lanes are packed here (over the int8 payload at wbits 8,
        the bf16 leaves at 16). With ``recover`` tokens equal the clean
        run's wherever every corruption is recoverable; without it the
        damage reaches the gathers, identically on both backends. None /
        "none" (the defaults) are bit-identical to an engine without them."""
        validate_method(method, allow_dense_free=True)
        validate_backend(backend)
        if wbits not in WBITS_CHOICES:
            raise ValueError(f"wbits must be one of {WBITS_CHOICES}, got {wbits!r}")
        if plan_refresh_interval < 1:
            raise ValueError("plan_refresh_interval must be >= 1")
        if degrade and method not in ("chunk", "topk"):
            raise ValueError(f"degrade=True needs a selecting method ('chunk' | 'topk') whose "
                             f"budget the controller can tighten, got {method!r}")
        if (method == "dense_free" and corruption_profile is not None
                and CorruptionModel(corruption_profile, max_reread=max_reread).enabled):
            raise ValueError("corruption injection needs an offloaded data plane — "
                             "method='dense_free' streams nothing from flash")
        self.torch_device = resolve_device(torch_device)
        self.backend = backend
        self.model = model
        self.max_seq = max_seq
        self.batch_size = batch_size
        self.prefetch_depth = prefetch_depth
        self.faults = (FaultModel(fault_profile, seed=fault_seed)
                       if fault_profile is not None else None)
        self.simulator = FlashOffloadSimulator(
            device, seed=seed, pipeline=PipelineModel(prefetch_depth=prefetch_depth),
            faults=self.faults,
        )
        self.degrade_controller = DegradationController() if degrade else None
        self.method = method
        self.plan_refresh_interval = plan_refresh_interval
        self.overlap = overlap
        self.wbits = wbits
        # the profile's default when None; >= 0 is checked by the profile
        self.cache_mb = self.simulator.profile.cache_capacity_bytes(cache_mb) / MB
        self.sparse_ctx = None if method == "dense_free" else SparseExecution(
            model.cfg, device=device, sparsity=sparsity, method=method,
            reorderings=reorderings, cache_mb=self.cache_mb, backend=backend,
            kernel_prefetch_depth=prefetch_depth, wbits=wbits,
            torch_device=self.torch_device, degradable=degrade,
            corruption_profile=corruption_profile, corruption_seed=corruption_seed,
            max_reread=max_reread, corruption_recover=recover,
        )
        self.corruption = None if self.sparse_ctx is None else self.sparse_ctx.corruption
        # engine-lifetime integrity totals, ordered like INTEGRITY_COUNTER_KEYS
        self._integrity_totals = np.zeros(len(INTEGRITY_COUNTER_KEYS))
        self.params = params
        integrity = self.corruption is not None
        if self.sparse_ctx is not None and (wbits == 8 or integrity):
            # the int8 payload + scale leaves (and, with integrity, the
            # checksum lane over the bytes the kernels stream) join the
            # stacked layer params; prefill, frame append and the unplanned
            # paths keep the bf16 originals
            layers = dict(params["layers"])
            if wbits == 8:
                layers.update(quantize_params(layers, SPARSE_WEIGHT_NAMES, checksums=integrity))
            else:
                layers.update(pack_checksums(layers, SPARSE_WEIGHT_NAMES))
            self.params = {**params, "layers": layers}
        # the pipeline's compute lane: the selecting methods compute over
        # their kept rows, dense and dense_free over every row
        self.compute_layer_s = ComputeModel().decode_layer_seconds(
            model.cfg, sparsity=sparsity if method in ("chunk", "topk") else 0.0,
            tokens=batch_size
        )
        self.cache = model.init_cache(batch_size, max_seq, self.torch_device)
        self.stats: List[StepStats] = []
        self._plan: Optional[Dict] = None  # the chunk-plan carry, kept across decode calls
        self._select_s_per_refresh: Optional[float] = None
        # each decode call's (n_steps, n_layers) simulated I/O, kept (the
        # last _LAYER_IO_LOG_MAX_STEPS steps, whole calls) so the timeline
        # can be repriced at other prefetch depths
        self._layer_io_log: List[np.ndarray] = []

    # -- stages ----------------------------------------------------------------
    def prefill(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Dense prompt forward; returns the last position's logits (b, vocab).
        Prefill streams every matrix once, contiguously, and is charged so."""
        t0 = time.perf_counter()
        batch = {k: v.to(self.torch_device) for k, v in batch.items()}
        last, self.cache = self.model.prefill(self.params, batch, self.max_seq)
        wall = time.perf_counter() - t0
        n = int(batch["tokens"].shape[1])
        n_layers = self.model.cfg.n_layers
        est = self.sparse_ctx.dense_total_latency() * n_layers if self.sparse_ctx else 0.0
        nbytes = self.sparse_ctx.sparsifiable_bytes(n_layers) if self.sparse_ctx else 0.0
        sim = self.simulator.measure_from_estimate(est, name="prefill", nbytes=nbytes)
        self.stats.append(StepStats("prefill", n, est, sim, 0.0, wall, nbytes=float(nbytes)))
        self._plan = None  # new sequence → stale plan
        return last

    def append_frame(self, frame_embeds: torch.Tensor) -> torch.Tensor:
        """One video frame's patch embeddings (b, n, d_frontend) → an n-token
        cache extension; every site's mask comes from this frame's own
        activations (``SparseExecution.mask``). Returns the final-normed
        hidden states (b, n, d); the frame's estimated I/O is the one sync."""
        t0 = time.perf_counter()
        hidden, io = self.model.append_embeds(self.params, frame_embeds, self.cache,
                                              self.sparse_ctx, self.torch_device)
        io = float(io)
        wall = time.perf_counter() - t0
        sim = self.simulator.measure_from_estimate(io, name="frame")
        self.stats.append(StepStats("frame", int(frame_embeds.shape[1]), io, sim, 0.0, wall))
        return hidden

    def _device_loop(self, token: torch.Tensor, n_tokens: int):
        """The fused decode loop: n greedy steps with no host sync. Returns
        device tensors (tokens (b, n), io (n, L), cumulative hit/miss/bytes
        (n,) each, cumulative integrity counters (n, 6))."""
        k = self.plan_refresh_interval
        toks, ios, hits, misses, byts, cis = [], [], [], [], [], []
        for i in range(n_tokens):
            logits, io = self.model.decode_step_planned(
                self.params, token, self.cache, self.sparse_ctx, self._plan, i % k == 0
            )
            token = torch.argmax(logits, dim=-1)[:, None]
            h, m = plan_hit_miss(self._plan, token.device)
            toks.append(token[:, 0])
            ios.append(io)
            hits.append(h)
            misses.append(m)
            byts.append(plan_transfer_bytes(self._plan, token.device))
            if self.corruption is not None:
                cis.append(plan_integrity_counters(self._plan, token.device))
        cis = (torch.stack(cis) if cis else
               torch.zeros((n_tokens, len(INTEGRITY_COUNTER_KEYS)), device=token.device))
        return (torch.stack(toks, dim=1), torch.stack(ios), torch.stack(hits),
                torch.stack(misses), torch.stack(byts), cis)

    def _start_decode(self) -> None:
        """A decode call's start: the plan (made on first use, kept across
        calls) with its counters zeroed and, with ``degrade``, the
        controller's current budget scale written into it — the controller
        acts only at call boundaries, so both decode loops see one scale
        per call."""
        if self._plan is None:
            self._plan = ({} if self.sparse_ctx is None
                          else self.sparse_ctx.init_plan(self.model.cfg.n_layers))
        reset_plan_counters(self._plan)
        if self.degrade_controller is not None:
            set_plan_budget_scale(self._plan, self.degrade_controller.scale)

    def _dense_step_bytes(self) -> float:
        """A ``dense`` step's transfer: every offloaded matrix re-streams
        (the empty plan counts nothing)."""
        return self.sparse_ctx.sparsifiable_bytes(self.model.cfg.n_layers)

    def _run_decode(self, tokens: torch.Tensor, n_tokens: int) -> np.ndarray:
        self._start_decode()
        tokens = tokens.to(self.torch_device)
        t0 = time.perf_counter()
        dev = self._device_loop(tokens, n_tokens)
        # ONE host transfer for the whole loop (tokens, per-layer estimates,
        # plan counters)
        toks, ios, hits, misses, byts, cis = (t.cpu() for t in dev)
        wall = time.perf_counter() - t0
        ios = ios.numpy().astype(np.float64)
        # per-step deltas of the call's cumulative counters
        hits, misses, byts = (np.diff(x.numpy().astype(np.float64), prepend=0.0)
                              for x in (hits, misses, byts))
        civ = np.diff(cis.numpy().astype(np.float64), axis=0, prepend=0.0)
        self._integrity_totals += civ.sum(axis=0)
        if self.method == "dense":
            byts = np.full_like(byts, self._dense_step_bytes())
        io_steps = ios.sum(axis=1)
        rows = hits + misses
        hit_rates = np.where(rows > 0, hits / np.maximum(rows, 1.0), 0.0)
        sims = self.simulator.measure_from_estimate_batch(
            io_steps, name="decode", hit_rates=hit_rates, nbytes=byts, integrity_s=civ[:, 5]
        )
        # spread each step's lift + jitter over its layers so the pipeline
        # sees simulated time
        scale = np.where(io_steps > 0, sims / np.maximum(io_steps, 1e-30), 1.0)
        layer_io = ios * scale[:, None]
        self._log_layer_io(layer_io)
        tl = self.simulator.pipeline.timeline(layer_io, self.compute_layer_s)
        n_refresh = math.ceil(n_tokens / self.plan_refresh_interval)
        select_amortized = self._selection_seconds_per_refresh() * n_refresh / max(n_tokens, 1)
        per_step_wall = wall / max(n_tokens, 1)
        compute_step = float(np.asarray(self.compute_layer_s).sum())
        for i in range(n_tokens):
            self.stats.append(StepStats(
                "decode", 1, float(io_steps[i]), float(sims[i]), select_amortized,
                per_step_wall, hit_rows=float(hits[i]), miss_rows=float(misses[i]),
                nbytes=float(byts[i]), compute_s=compute_step,
                serial_s=float(tl.serial_s[i]), overlap_s=float(tl.overlap_s[i]),
                stall_s=float(tl.stall_s[i]), bubble_s=float(tl.bubble_s[i]),
            ))
        self._observe_degradation(io_steps, sims)
        self._observe_corruption(float(civ[:, 0].sum()), float(misses.sum()))
        return toks

    def _decode_lift(self) -> float:
        """The deterministic lift of a decode measurement (diversity 0.5):
        dividing it out centres a healthy device's ratio at 1.0."""
        return self.simulator.profile.interleave_lift * 1.05

    def _observe_degradation(self, io_est, io_sim) -> None:
        """One decode call's per-step (estimate, measurement) pairs → the
        degradation controller (no-op without ``degrade``)."""
        if self.degrade_controller is None:
            return
        est = np.asarray(io_est, np.float64).reshape(-1)
        sim = np.asarray(io_sim, np.float64).reshape(-1)
        pos = est > 0.0
        if np.any(pos):
            self.degrade_controller.observe(sim[pos] / (est[pos] * self._decode_lift()))

    def _observe_corruption(self, detected: float, miss_rows: float) -> None:
        """One decode call's corruption rate — detected corrupt blocks per
        fetched block (miss rows / 8) — as the controller's second signal
        (no-op without ``degrade`` or without corruption)."""
        if self.degrade_controller is None or self.corruption is None:
            return
        blocks = max(miss_rows / KERNEL_BLOCK_ROWS, 1.0)
        self.degrade_controller.observe_corruption(detected / blocks)

    def _selection_seconds_per_refresh(self) -> float:
        """Wall seconds one refresh spends on selection (the selection of
        every layer's sites in one batch, timed once per engine) — measured
        after the decode loop, never inside it; 0 where nothing is selected
        per step (``dense``, ``dense_free``)."""
        if self.sparse_ctx is None:
            return 0.0
        if self._select_s_per_refresh is None:
            self._select_s_per_refresh = self.sparse_ctx.time_selection()
        return self._select_s_per_refresh

    def decode(self, first_token: torch.Tensor, n_tokens: int, greedy: bool = True):
        """Greedy-decode n_tokens; returns (b, n_tokens + 1) including
        ``first_token`` (on the host)."""
        if not greedy:
            raise NotImplementedError("sampled decoding is not implemented: decode "
                                      "always takes the argmax")
        toks = self._run_decode(first_token, n_tokens)
        return torch.cat([first_token.cpu().to(toks.dtype), toks], dim=1)

    def decode_per_token(self, first_token: torch.Tensor, n_tokens: int,
                         greedy: bool = True):
        """The reference's baseline loop: the same step function as
        ``decode`` (plan reuse and the residency cache included), with one
        host sync per token that brings back the step's per-layer I/O and
        counter deltas. Its tokens are byte-identical to ``decode``'s; the
        prefetch-pipeline accounting is backfilled once the loop ends (the
        timeline needs every step's per-layer I/O). Returns (b, n_tokens +
        1) including ``first_token`` (on the host)."""
        if not greedy:
            raise NotImplementedError("sampled decoding is not implemented: "
                                      "decode_per_token always takes the argmax")
        self._start_decode()
        token = first_token.to(self.torch_device)
        out = [first_token.cpu().to(torch.int64)]
        start = len(self.stats)
        io_rows = []
        det_call = 0.0
        k = self.plan_refresh_interval
        n_ci = len(INTEGRITY_COUNTER_KEYS)
        for i in range(n_tokens):
            t0 = time.perf_counter()
            h0, m0 = plan_hit_miss(self._plan, token.device)
            b0 = plan_transfer_bytes(self._plan, token.device)
            c0 = (plan_integrity_counters(self._plan, token.device)
                  if self.corruption is not None else None)
            logits, io = self.model.decode_step_planned(
                self.params, token, self.cache, self.sparse_ctx, self._plan, i % k == 0)
            token = torch.argmax(logits, dim=-1)[:, None]
            h1, m1 = plan_hit_miss(self._plan, token.device)
            deltas = torch.stack([h1 - h0, m1 - m0,
                                  plan_transfer_bytes(self._plan, token.device) - b0])
            dci = (torch.zeros((n_ci,), device=token.device) if c0 is None
                   else plan_integrity_counters(self._plan, token.device) - c0)
            # the per-token host sync, one transfer: the tokens (exact in
            # float64), the layers' estimates and the step's counter deltas
            row = torch.cat([token[:, 0].to(torch.float64), io.to(torch.float64),
                             deltas.to(torch.float64), dci.to(torch.float64)]).cpu()
            wall = time.perf_counter() - t0
            b = token.shape[0]
            tok = row[:b].to(torch.int64)[:, None]
            io_vec = row[b:-3 - n_ci].numpy()
            hit, miss, nbytes = row[-3 - n_ci:-n_ci].tolist()
            dci = row[-n_ci:].numpy()
            self._integrity_totals += dci
            det_call += float(dci[0])
            if self.method == "dense":
                nbytes = self._dense_step_bytes()
            est = float(io_vec.sum())
            rate = hit / (hit + miss) if (hit + miss) > 0 else 0.0
            sim = self.simulator.measure_from_estimate(est, name="decode", hit_rate=rate,
                                                       nbytes=nbytes, integrity_s=float(dci[5]))
            io_rows.append(io_vec * (sim / est if est > 0 else 1.0))
            self.stats.append(StepStats("decode", 1, est, sim, 0.0, wall,
                                        hit_rows=float(hit), miss_rows=float(miss),
                                        nbytes=float(nbytes)))
            out.append(tok)
        if not io_rows:
            return torch.cat(out, dim=1)
        recent = self.stats[start:]
        self._observe_degradation([s.io_est_s for s in recent], [s.io_sim_s for s in recent])
        self._observe_corruption(det_call, float(sum(s.miss_rows for s in recent)))
        select_per_refresh = self._selection_seconds_per_refresh()
        layer_io = np.asarray(io_rows)
        self._log_layer_io(layer_io)
        tl = self.simulator.pipeline.timeline(layer_io, self.compute_layer_s)
        compute_step = float(np.asarray(self.compute_layer_s).sum())
        for j, st in enumerate(self.stats[start:]):
            st.select_overhead_s = select_per_refresh if j % k == 0 else 0.0
            st.compute_s = compute_step
            st.serial_s = float(tl.serial_s[j])
            st.overlap_s = float(tl.overlap_s[j])
            st.stall_s = float(tl.stall_s[j])
            st.bubble_s = float(tl.bubble_s[j])
        return torch.cat(out, dim=1)

    # -- the prefetch timeline at other depths ---------------------------------
    def _log_layer_io(self, layer_io: np.ndarray) -> None:
        """Keep one decode call's (n_steps, n_layers) simulated I/O, dropping
        the oldest whole calls past ``_LAYER_IO_LOG_MAX_STEPS`` steps."""
        self._layer_io_log.append(layer_io)
        total = sum(m.shape[0] for m in self._layer_io_log)
        while len(self._layer_io_log) > 1 and total > self._LAYER_IO_LOG_MAX_STEPS:
            total -= self._layer_io_log.pop(0).shape[0]

    def reprice_timeline(self, prefetch_depth: int) -> PipelineTimeline:
        """The prefetch timeline of the logged decode calls re-run at
        ``prefetch_depth``, each call as its own cold pipeline (as the
        engine charges a call): what an engine built with that depth would
        log for the same calls, without decoding again. Returns the calls'
        timelines concatenated."""
        if not self._layer_io_log:
            raise RuntimeError("no decode steps logged yet — nothing to reprice")
        model = self.simulator.pipeline.with_depth(prefetch_depth)
        tls = [model.timeline(ios, self.compute_layer_s) for ios in self._layer_io_log]
        if len(tls) == 1:
            return tls[0]
        return PipelineTimeline(**{
            f.name: np.concatenate([getattr(t, f.name) for t in tls])
            for f in dataclasses.fields(PipelineTimeline)})

    # -- accounting -------------------------------------------------------------
    def fault_summary(self) -> Dict[str, object]:
        """The fault-injection and degradation rollup beside ``io_summary``:
        the profile and seed, perturbed events, spikes, retries and their
        backoff, the extra charged seconds, the deepest throttle, the
        simulator's busy clock, and the controller's ``degrade_*`` state.
        Without a fault model or controller it reports the quiescent
        defaults (profile "none", scale 1.0)."""
        out: Dict[str, object] = {
            "fault_profile": "none",
            "fault_seed": 0,
            "fault_enabled": False,
            "device_time_s": self.simulator.device_time_s,
            "fault_events": 0,
            "fault_spikes": 0,
            "fault_retries": 0,
            "fault_backoff_s": 0.0,
            "fault_extra_s": 0.0,
            "min_throttle_scale": 1.0,
            "degrade_enabled": self.degrade_controller is not None,
            "degrade_scale": 1.0,
            "degrade_ewma_ratio": 1.0,
            "degrade_observations": 0,
            "degrade_tighten_steps": 0,
            "degrade_relax_steps": 0,
            "degrade_calls_degraded": 0,
        }
        if self.faults is not None:
            fs = self.faults.summary()
            out.update({
                "fault_profile": fs["profile"],
                "fault_seed": fs["seed"],
                "fault_enabled": self.faults.enabled,
                "fault_events": fs["events"],
                "fault_spikes": fs["spikes"],
                "fault_retries": fs["retries"],
                "fault_backoff_s": fs["backoff_s"],
                "fault_extra_s": fs["fault_extra_s"],
                "min_throttle_scale": fs["min_throttle_scale"],
            })
        if self.degrade_controller is not None:
            out.update({f"degrade_{k}": v for k, v in self.degrade_controller.summary().items()})
        return out

    def io_summary(self) -> Dict[str, float]:
        """Engine-lifetime I/O / pipeline rollup with exactly the keys of
        ``IO_SUMMARY_KEYS``, each meaning what it means in the reference's
        ``io_summary``: the fault lanes mirror ``fault_summary`` and the
        corruption lanes total the plan's integrity counters. Absent in the
        port (they come with the features that fill them):
        admitted_during_stall, stall_hidden_s, bubble_utilization
        (scheduler); kv_cache_mb, weight_cache_mb, kv_pages_in_use,
        kv_shared_pages (paged KV)."""
        dec = [s for s in self.stats if s.kind == "decode"]
        hit = sum(s.hit_rows for s in self.stats)
        miss = sum(s.miss_rows for s in self.stats)
        fs = self.fault_summary()
        it = self._integrity_totals
        return {
            "io_est_s": sum(s.io_est_s for s in self.stats),
            "io_sim_s": sum(s.io_sim_s for s in self.stats),
            "steps": len(self.stats),
            "hit_rows": hit,
            "miss_rows": miss,
            "cache_hit_rate": hit / (hit + miss) if (hit + miss) > 0 else 0.0,
            "io_bytes": sum(s.nbytes for s in self.stats),
            "select_overhead_s": sum(s.select_overhead_s for s in self.stats),
            "decode_compute_s": sum(s.compute_s for s in dec),
            "decode_serial_s": sum(s.serial_s for s in dec),
            "decode_overlap_s": sum(s.overlap_s for s in dec),
            "decode_stall_s": sum(s.stall_s for s in dec),
            "decode_bubble_s": sum(s.bubble_s for s in dec),
            "overlap_efficiency": overlap_efficiency(
                [s.serial_s for s in dec], [s.overlap_s for s in dec],
                [s.io_sim_s for s in dec], [s.compute_s for s in dec],
            ),
            "fault_events": fs["fault_events"],
            "fault_spikes": fs["fault_spikes"],
            "fault_retries": fs["fault_retries"],
            "fault_backoff_s": fs["fault_backoff_s"],
            "fault_extra_s": fs["fault_extra_s"],
            "min_throttle_scale": fs["min_throttle_scale"],
            "corruptions_detected": float(it[0]),
            "corruptions_recovered": float(it[1]),
            "corruptions_substituted": float(it[2]),
            "corruptions_dropped": float(it[3]),
            "integrity_reread_s": float(it[5]),
        }
