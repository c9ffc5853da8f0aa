"""ServeEngine: serving with flash-offload simulation (the port's copy of
``repro.serving.engine``), in two modes that share the decode loop:

  * single-stream mode: ``prefill`` / ``append_frame`` / ``decode`` drive
    one batch of lockstep requests through a cache whose length is a host
    int;
  * slot mode (``enable_slots`` + ``Scheduler``): each batch row is an
    independent request slot whose length lives in an int32 (b,) device
    tensor; ``admit_slot`` prefills one request into a free slot and
    ``decode_slots`` runs the fused loop over every slot at once
    (continuous batching). ``kv_page_tokens`` makes the KV cache paged: a
    pool of fixed-size pages with per-slot page tables and prefix sharing
    by chained content hashes (``serving/kv_pool.py``); its bytes are
    carved out of the ``cache_mb`` DRAM budget before the residency cache
    sees the rest.

``prefill(batch)`` runs the dense prompt forward (a VLM's or an
early-fusion MoE's prompt: its vision tokens first); ``append_frame(frame)`` extends the cache by one video
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

A MoE model serves as a dense one does, with only its attention sites
planned: its experts run unmasked on every path, streaming nothing the
simulator charges, as in the reference (``models/moe.py``); their
capacity is over each call's own tokens (in slot mode, free slots'
tokens too).

The hybrid (Zamba2), recurrent (xLSTM) and audio (Whisper) families serve
single-stream through ``Model.decode_step_planned``, as in the reference:
their decode reaches no sparsification site, so a decode step carries the
family's I/O figure (0) spread over the layers and the plan passes through
unchanged, while the prefill is charged the dense I/O and the offloaded
bytes of the config's site geometry like any other. Paged KV, slot mode,
frames, ``wbits=8`` and corruption injection are refused for them (the
reference fails on the last two: it quantizes and packs
``params["layers"]``, which these families do not have).

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

``mesh``: the (data, model) serve mesh (sharding/serve.py), one process
per rank. Each data rank holds batch / data rows of the tokens and the KV
cache and runs the model on them; the decode-streamed weights are
model-sharded at rest and gathered at the compute boundary; selection is
replicated, so the plan, the simulator and every counter are the same on
every rank, and ``prefill`` / ``append_frame`` / ``decode`` return the
whole batch, gathered in row order. Greedy tokens equal the 1×1 mesh's,
and so do the logits, each frame's hidden states and each rank's rows of
the cache, bitwise at full width (``tests/test_torch_sharded_full_width.
py``). A product rounds by how many rows it multiplies, so ``prefill``
runs the whole batch's prompt on every rank and keeps its rows, and the
calls on split rows run inside ``ServeMesh.split_rows``, where every
computation but the planned path's K1/K2 products and the decode
attention (whose rows are independent) runs at the whole batch's row
count (``whole_rows``): the LM head, a frame's projector and block, the
unplanned decode (``dense``, ``dense_free``) and the Zamba2, xLSTM and
Whisper decode steps gather their activations over ``data``, compute the
whole batch and keep this rank's rows, while what reads this rank's cache
(a recurrent state, a frame's or Whisper's cross-attention) runs on its
rows padded with zeros, so no cache is gathered. A MoE layer routes the
whole batch so (its capacity and drops span it, as in the reference).
The model-sharded sites log their bytes per shard (``IOEvent.
shard_bytes``, ``shard_summary``); on the unsharded path nothing changes.
A paged pool is split by page
over ``data`` (``kv_pages`` rounds up to a multiple of it, as in the
reference); the allocator stays the reference's, global and replicated on
every rank, and each pushed table carries its ``PageExchange``: per layer
and decode step, the pages the tables name are all-gathered over ``data``
and each rank's new K/V entries reach the rank holding their page.

Not ported yet: frame append in slot mode (the reference's
``append_frame`` takes a scalar length).
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
from ..sharding.serve import ServeMesh, validate_serve_mesh
from .kv_pool import KVPagePool, KVPoolExhausted, prompt_prefix_hashes
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


# the exact key set io_summary() returns, in the reference's order
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
    "admitted_during_stall",
    "stall_hidden_s",
    "bubble_utilization",
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
    "kv_cache_mb",
    "weight_cache_mb",
    "kv_pages_in_use",
    "kv_shared_pages",
)


class ServeEngine:
    # retention bound of the per-layer I/O log behind reprice_timeline
    _LAYER_IO_LOG_MAX_STEPS = 4096

    def __init__(self, model: Model, params, max_seq: int, batch_size: int,
                 device: str = "nano", sparsity=0.4, method: str = "chunk",
                 reorderings: Optional[dict] = None, seed: int = 0,
                 plan_refresh_interval: int = 1, cache_mb: Optional[float] = None,
                 overlap: bool = True, prefetch_depth: int = 1, compute_layer_scale=None,
                 backend: str = "reference", wbits: int = 16, torch_device=None,
                 fault_profile=None, fault_seed: int = 0, degrade: bool = False,
                 corruption_profile=None, corruption_seed: int = 0, max_reread: int = 2,
                 recover: bool = True, kv_page_tokens: Optional[int] = None,
                 kv_pages: Optional[int] = None, mesh: Optional[ServeMesh] = None):
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
        every depth. ``compute_layer_scale``: optional (n_layers,)
        multipliers of the pipeline's per-layer compute lane
        (``ComputeModel.decode_layer_seconds``; e.g. from
        ``calibrate_layer_scale``); None keeps it uniform.

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
        "none" (the defaults) are bit-identical to an engine without them.

        ``kv_page_tokens`` / ``kv_pages``: the paged KV cache. None keeps
        the dense cache. Set, the engine is in slot mode from birth: a pool
        of ``kv_pages`` pages of ``kv_page_tokens`` positions (page 0 the
        garbage page; default: the dense-equivalent ``batch · max_seq /
        kv_page_tokens + 1``), per-slot page tables and prefix sharing.
        The pool's bytes (``kv_cache_mb``) come out of ``cache_mb``; the
        residency cache gets the rest (``weight_cache_mb``). Greedy tokens
        equal the dense cache's on the same admissions.

        ``mesh``: the serve mesh (None: unsharded). Sharded, this process
        serves its data rank's batch / data rows and holds its model rank's
        slices of the decode-streamed weights (see the module doc); tokens
        equal the 1×1 mesh's."""
        validate_method(method, allow_dense_free=True)
        validate_backend(backend)
        if wbits not in WBITS_CHOICES:
            raise ValueError(f"wbits must be one of {WBITS_CHOICES}, got {wbits!r}")
        if plan_refresh_interval < 1:
            raise ValueError("plan_refresh_interval must be >= 1")
        if degrade and method not in ("chunk", "topk"):
            raise ValueError(f"degrade=True needs a selecting method ('chunk' | 'topk') whose "
                             f"budget the controller can tighten, got {method!r}")
        corrupting = (corruption_profile is not None
                      and CorruptionModel(corruption_profile, max_reread=max_reread).enabled)
        if method == "dense_free" and corrupting:
            raise ValueError("corruption injection needs an offloaded data plane — "
                             "method='dense_free' streams nothing from flash")
        if not model.is_decoder and method != "dense_free" and (wbits == 8 or corrupting):
            raise ValueError(f"wbits=8 and corruption injection quantize or checksum the "
                             f"decoder layers' offloaded matrices; the {model.family!r} "
                             f"family ({model.cfg.name}) has none")
        self.mesh = mesh if mesh is not None else ServeMesh.single()
        if self.mesh.is_sharded:
            cfg = model.cfg
            validate_serve_mesh(self.mesh.data, self.mesh.model, batch=batch_size,
                                d_ff=(cfg.d_ff if (self.mesh.model > 1 and cfg.d_ff
                                                   and not cfg.has_moe) else 0))
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
        # scheduler admissions hidden in decode stall windows (the Scheduler
        # reports them through note_stall_admission)
        self.admitted_during_stall = 0
        self.stall_hidden_s = 0.0
        # the paged pool's geometry, and its bytes carved out of the DRAM
        # budget before SparseExecution is built: the residency cache sees
        # only the weight share
        self.kv_page_tokens = kv_page_tokens
        if kv_page_tokens is not None:
            if not model.supports_paged_kv:
                raise ValueError(f"paged KV is only supported for decoder families "
                                 f"(dense/moe/vlm), not {model.family!r}")
            if kv_page_tokens < 1 or max_seq % kv_page_tokens != 0:
                raise ValueError(f"kv_page_tokens ({kv_page_tokens}) must be >= 1 and "
                                 f"divide max_seq ({max_seq})")
            if kv_pages is None:
                # the dense-equivalent capacity + the garbage page, rounded
                # up so the pool's page axis splits over 'data'
                kv_pages = batch_size * (max_seq // kv_page_tokens) + 1
                kv_pages += -kv_pages % self.mesh.data
            if kv_pages < 2:
                raise ValueError(f"kv_pages must be >= 2, got {kv_pages}")
            if kv_pages % self.mesh.data:
                raise ValueError(f"kv_pages ({kv_pages}) must divide over the mesh's "
                                 f"{self.mesh.data} data ranks, each of which holds a slice")
            cfg = model.cfg
            # bf16 K and V entries of one page, summed over layers
            self.kv_page_bytes = float(2 * 2 * cfg.n_layers * kv_page_tokens
                                       * cfg.n_cache_kv_heads * cfg.resolved_head_dim)
            self.kv_pages = kv_pages
            self.kv_cache_mb = kv_pages * self.kv_page_bytes / MB
        else:
            if kv_pages is not None:
                raise ValueError("kv_pages requires kv_page_tokens")
            self.kv_pages = 0
            self.kv_page_bytes = 0.0
            self.kv_cache_mb = 0.0
        self.weight_cache_mb = max(0.0, self.cache_mb - self.kv_cache_mb)
        self.sparse_ctx = None if method == "dense_free" else SparseExecution(
            model.cfg, device=device, sparsity=sparsity, method=method,
            reorderings=reorderings, cache_mb=self.weight_cache_mb, backend=backend,
            kernel_prefetch_depth=prefetch_depth, wbits=wbits,
            torch_device=self.torch_device, degradable=degrade,
            corruption_profile=corruption_profile, corruption_seed=corruption_seed,
            max_reread=max_reread, corruption_recover=recover, mesh=self.mesh,
        )
        self.corruption = None if self.sparse_ctx is None else self.sparse_ctx.corruption
        # the per-shard accounting's width (1 unsharded, where the shard lanes
        # stay out of the logs; 1 on a one-rank mesh, where they are kept)
        self.n_shards = (self.sparse_ctx.n_shards if self.sparse_ctx is not None
                         else self.mesh.model if self.mesh.is_sharded else 1)
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
        if self.sparse_ctx is not None and model.is_decoder:
            # the decode-streamed leaves shard over 'model' (the _q8/_sc
            # leaves at wbits 8, <name>_dec copies at 16); the rest stays
            # whole on every rank. The identity unsharded.
            self.params = self.mesh.place_params(self.params, wbits, SPARSE_WEIGHT_NAMES)
        else:
            self.params = self.mesh.put_replicated(self.params)
        # the pipeline's compute lane: the selecting methods compute over
        # their kept rows, dense and dense_free over every row
        self.compute_layer_s = ComputeModel().decode_layer_seconds(
            model.cfg, sparsity=sparsity if method in ("chunk", "topk") else 0.0,
            tokens=batch_size, layer_scale=compute_layer_scale,
        )
        self.kv_pool: Optional[KVPagePool] = None
        # slot mode's host mirror of the per-slot lengths (None in single-
        # stream mode): the paged growth pre-check reads it, never the card
        self._host_lengths: Optional[np.ndarray] = None
        if kv_page_tokens is not None:
            self._init_paged_state()
        else:
            self.cache = self._new_cache()
        self.stats: List[StepStats] = []
        self._plan: Optional[Dict] = None  # the chunk-plan carry, kept across decode calls
        self._select_s_per_refresh: Optional[float] = None
        # each decode call's (n_steps, n_layers) simulated I/O, kept (the
        # last _LAYER_IO_LOG_MAX_STEPS steps, whole calls) so the timeline
        # can be repriced at other prefetch depths
        self._layer_io_log: List[np.ndarray] = []

    # -- this rank's share of the batch ------------------------------------------
    def _new_cache(self) -> Dict:
        """A fresh single-stream cache: this data rank's rows of it."""
        cache = self.model.init_cache(self.batch_size, self.max_seq, self.torch_device)
        return self.mesh.place_cache(cache, self.model.cache_axes())

    @property
    def _local_rows(self) -> range:
        """The batch rows (slots) this data rank holds."""
        n = self.batch_size // self.mesh.data
        r = self.mesh.rank("data")
        return range(r * n, (r + 1) * n)

    # -- stages ----------------------------------------------------------------
    def _prefill_charge(self, n: int, name: str, wall: float) -> float:
        """Log a prefill: it streams every matrix once, contiguously, and is
        charged so (each model shard its slice). Returns the simulated
        seconds."""
        n_layers = self.model.cfg.n_layers
        est = self.sparse_ctx.dense_total_latency() * n_layers if self.sparse_ctx else 0.0
        nbytes = self.sparse_ctx.sparsifiable_bytes(n_layers) if self.sparse_ctx else 0.0
        sim = self.simulator.measure_from_estimate(est, name=name, nbytes=nbytes,
                                                   shard_bytes=self._even_shard_bytes(nbytes))
        self.stats.append(StepStats("prefill", n, est, sim, 0.0, wall, nbytes=float(nbytes)))
        return sim

    def prefill(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Dense prompt forward; returns the last position's logits (b, vocab).
        Leaves slot mode; a paged engine has no single-stream cache and
        refuses (its requests come in through ``admit_slot``)."""
        if self.kv_pool is not None:
            raise NotImplementedError("paged KV is slot-mode only: admit requests with "
                                      "admit_slot (a single-stream prefill would bypass "
                                      "the page allocator)")
        t0 = time.perf_counter()
        batch = {k: v.to(self.torch_device) for k, v in batch.items()}
        # on a sharded mesh every rank runs the whole batch's prompt (its
        # logits are every rank's answer) and keeps its data rank's rows of
        # the cache, as an admission does: a product's rounding on the CPU
        # and on cards depends on how many rows it multiplies, so a prefill
        # of a data rank's rows alone would not be the 1×1 mesh's
        last, cache = self.model.prefill(self.params, batch, self.max_seq)
        self.cache = self.mesh.place_cache(cache, self.model.cache_axes())
        self._host_lengths = None
        self._prefill_charge(int(batch["tokens"].shape[1]), "prefill", time.perf_counter() - t0)
        self._plan = None  # new sequence → stale plan
        return last

    def append_frame(self, frame_embeds: torch.Tensor) -> torch.Tensor:
        """One video frame's patch embeddings (b, n, d_frontend) → an n-token
        cache extension; every site's mask comes from this frame's own
        activations (``SparseExecution.mask``). Returns the final-normed
        hidden states (b, n, d); the frame's estimated I/O is the one sync.
        Single-stream mode only."""
        if self.kv_pool is not None:
            raise NotImplementedError("paged KV is slot-mode only: append_frame extends "
                                      "the single-stream linear cache, which paged "
                                      "engines do not keep")
        t0 = time.perf_counter()
        frame = self.mesh.put_batch(frame_embeds.to(self.torch_device))
        with self.mesh.split_rows():
            hidden, io = self.model.append_embeds(self.params, frame, self.cache,
                                                  self.sparse_ctx, self.torch_device)
        hidden = self.mesh.gather_batch(hidden)
        io = float(io)
        wall = time.perf_counter() - t0
        sim = self.simulator.measure_from_estimate(io, name="frame")
        self.stats.append(StepStats("frame", int(frame_embeds.shape[1]), io, sim, 0.0, wall))
        return hidden

    def _shard_bytes_total(self, device) -> Optional[torch.Tensor]:
        """The plan's cumulative per-model-shard bytes (n_shards,), or None
        unsharded."""
        if not self.mesh.is_sharded:
            return None
        if self.sparse_ctx is None:
            return torch.zeros((self.n_shards,), dtype=torch.float32, device=device)
        return self.sparse_ctx.plan_shard_bytes(self._plan)

    def _device_loop(self, token: torch.Tensor, n_tokens: int):
        """The fused decode loop: n greedy steps with no host sync. Returns
        device tensors (tokens (b, n) — this rank's rows, io (n, L),
        cumulative hit/miss/bytes (n,) each, cumulative integrity counters
        (n, 6), cumulative per-shard bytes (n, n_shards) or None)."""
        k = self.plan_refresh_interval
        toks, ios, hits, misses, byts, cis, sbs = [], [], [], [], [], [], []
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
            if self.mesh.is_sharded:
                sbs.append(self._shard_bytes_total(token.device))
        cis = (torch.stack(cis) if cis else
               torch.zeros((n_tokens, len(INTEGRITY_COUNTER_KEYS)), device=token.device))
        return (torch.stack(toks, dim=1), torch.stack(ios), torch.stack(hits),
                torch.stack(misses), torch.stack(byts), cis,
                torch.stack(sbs) if sbs else None)

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

    def _run_decode(self, tokens: torch.Tensor, n_tokens: int):
        """The fused loop and its accounting. Returns (tokens (b, n) on the
        host, each step's charged seconds (n,): the overlapped pipeline's
        critical path, or the serial charge with ``overlap=False``)."""
        self._start_decode()
        tokens = self.mesh.put_batch(tokens.to(self.torch_device))
        t0 = time.perf_counter()
        with self.mesh.split_rows():
            *dev, sbs = self._device_loop(tokens, n_tokens)
        dev[0] = self.mesh.gather_batch(dev[0])  # every data rank's rows, in order
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
        sbyts = (None if sbs is None else
                 np.diff(sbs.cpu().numpy().astype(np.float64), axis=0, prepend=0.0))
        if self.method == "dense":
            byts = np.full_like(byts, self._dense_step_bytes())
            if sbyts is not None:
                sbyts = np.full_like(sbyts, self._dense_step_bytes() / self.n_shards)
        io_steps = ios.sum(axis=1)
        rows = hits + misses
        hit_rates = np.where(rows > 0, hits / np.maximum(rows, 1.0), 0.0)
        sims = self.simulator.measure_from_estimate_batch(
            io_steps, name="decode", hit_rates=hit_rates, nbytes=byts, shard_bytes=sbyts,
            integrity_s=civ[:, 5]
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
        if self._host_lengths is not None:
            self._host_lengths += n_tokens
        return toks, (tl.overlap_s if self.overlap else tl.serial_s)

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
        toks, _ = self._run_decode(first_token, n_tokens)
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
        token = self.mesh.put_batch(first_token.to(self.torch_device))
        out = []
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
            s0 = self._shard_bytes_total(token.device)
            with self.mesh.split_rows():
                logits, io = self.model.decode_step_planned(
                    self.params, token, self.cache, self.sparse_ctx, self._plan, i % k == 0)
            token = torch.argmax(logits, dim=-1)[:, None]
            h1, m1 = plan_hit_miss(self._plan, token.device)
            deltas = torch.stack([h1 - h0, m1 - m0,
                                  plan_transfer_bytes(self._plan, token.device) - b0])
            dci = (torch.zeros((n_ci,), device=token.device) if c0 is None
                   else plan_integrity_counters(self._plan, token.device) - c0)
            dsb = (torch.zeros((0,), device=token.device) if s0 is None
                   else self._shard_bytes_total(token.device) - s0)
            n_sb = dsb.shape[0]
            # the per-token host sync, one transfer: the tokens (exact in
            # float64), the layers' estimates and the step's counter deltas
            row = torch.cat([token[:, 0].to(torch.float64), io.to(torch.float64),
                             deltas.to(torch.float64), dci.to(torch.float64),
                             dsb.to(torch.float64)]).cpu()
            wall = time.perf_counter() - t0
            tail = row[token.shape[0]:].numpy()
            if n_sb:
                tail, sb = tail[:-n_sb], tail[-n_sb:]
            io_vec = tail[:-3 - n_ci]
            hit, miss, nbytes = tail[-3 - n_ci:-n_ci].tolist()
            dci = tail[-n_ci:]
            self._integrity_totals += dci
            det_call += float(dci[0])
            if self.method == "dense":
                nbytes = self._dense_step_bytes()
                if n_sb:
                    sb = np.full(n_sb, nbytes / n_sb)
            est = float(io_vec.sum())
            rate = hit / (hit + miss) if (hit + miss) > 0 else 0.0
            sim = self.simulator.measure_from_estimate(est, name="decode", hit_rate=rate,
                                                       nbytes=nbytes,
                                                       shard_bytes=sb if n_sb else None,
                                                       integrity_s=float(dci[5]))
            io_rows.append(io_vec * (sim / est if est > 0 else 1.0))
            self.stats.append(StepStats("decode", 1, est, sim, 0.0, wall,
                                        hit_rows=float(hit), miss_rows=float(miss),
                                        nbytes=float(nbytes)))
            out.append(token)
        if self._host_lengths is not None:
            self._host_lengths += n_tokens
        first = first_token.cpu().to(torch.int64)
        if not io_rows:
            return first
        # every data rank's rows, in order (one gather for the call)
        out = torch.cat([first, self.mesh.gather_batch(torch.cat(out, dim=1)).cpu()], dim=1)
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
        return out

    # -- slot mode (continuous batching; driven by serving.scheduler) -----------
    def _init_paged_state(self) -> None:
        """(Re)build the page pool, the paged cache (this data rank's slice
        of the pages and its slots' rows) and the length mirror."""
        self.kv_pool = KVPagePool(self.batch_size, self.max_seq, self.kv_page_tokens,
                                  self.kv_pages, self.kv_page_bytes,
                                  n_data_shards=self.mesh.data)
        cache = self.model.init_paged_cache(self.batch_size, self.max_seq,
                                            self.kv_page_tokens, self.kv_pages,
                                            self.torch_device)
        self.cache = self.mesh.place_cache(cache, self.model.paged_cache_axes())
        self._host_lengths = np.zeros(self.batch_size, np.int64)
        self._push_table()

    @property
    def _local_pages(self) -> range:
        """The global page ids of the pool slice this data rank holds."""
        n = self.kv_pages // self.mesh.data
        r = self.mesh.rank("data")
        return range(r * n, (r + 1) * n)

    def _push_table(self) -> None:
        """Commit the pool's host page table to the card: this data rank's
        slots' rows and, on a sharded mesh, the table's ``PageExchange``."""
        table = self.kv_pool.table
        rows = self._local_rows
        self.cache["page_table"] = torch.from_numpy(
            table[rows.start:rows.stop].copy()).to(self.torch_device)
        if self.mesh.is_sharded:
            self.cache["page_exchange"] = self.mesh.page_exchange(table, self.kv_pages,
                                                                  self.torch_device)

    def _check_slot(self, slot: Optional[int] = None) -> None:
        """Refuse a call of slot mode in single-stream mode, and a slot out
        of range."""
        if slot is not None and not 0 <= slot < self.batch_size:
            raise ValueError(f"slot {slot} out of range [0, {self.batch_size})")
        if self._host_lengths is None:
            raise RuntimeError("the engine is in single-stream mode: call enable_slots first")

    def enable_slots(self) -> None:
        """Switch the cache to per-slot lengths: each batch row becomes an
        independent request slot (empty until ``admit_slot``); a paged
        engine rebuilds its pool. The decoder families only: the others'
        caches have no per-slot layout."""
        if not self.model.is_decoder:
            raise NotImplementedError(f"slot mode (continuous batching) serves the decoder "
                                      f"families (dense/moe/vlm), not {self.model.family!r}")
        if self.kv_pool is not None:
            self._init_paged_state()
        else:
            self.cache = self._new_cache()
            self.cache["length"] = torch.zeros((len(self._local_rows),), dtype=torch.int32,
                                               device=self.torch_device)
            self._host_lengths = np.zeros(self.batch_size, np.int64)
        self._plan = None

    def kv_can_admit(self, batch: Dict[str, torch.Tensor]) -> bool:
        """Whether the pool can cover this prompt's unshared pages right now
        (always True on the dense cache, where a free slot is enough)."""
        if self.kv_pool is None:
            return True
        return self.kv_pool.can_admit(*prompt_prefix_hashes(batch, self.kv_page_tokens))

    def release_slot(self, slot: int) -> None:
        """Free a slot's KV storage — the one funnel of every scheduler
        release (eviction, preemption). Paged: drop the slot's page
        references (shared prefix pages go cold, private ones free) and push
        the cleared table row. Both layouts zero the slot's length."""
        self._check_slot(slot)
        if self.kv_pool is not None and self.kv_pool.release(slot):
            self._push_table()
        if slot in self._local_rows:  # a device fill: no host value to copy
            self.cache["length"][slot - self._local_rows.start].fill_(0)
        self._host_lengths[slot] = 0

    def admit_slot(self, slot: int, batch: Dict[str, torch.Tensor]):
        """Prefill one request (leading batch dim 1) into ``slot``, over
        whatever a previous occupant left there. Returns (the request's
        last-position logits (1, vocab) on the card, the prefill's simulated
        seconds: every matrix streams once, contiguously).

        Dense cache: the slot's whole row is overwritten, all ``max_seq``
        positions. Paged: the prompt's full pages are content-addressed;
        pages already resident (live or cold) are shared and not rewritten,
        only fresh pages take the prefill's KV. Raises ``KVPoolExhausted``
        when the pool cannot cover the unshared pages (``kv_can_admit``
        checks first). On a sharded mesh every rank runs the prefill (its
        logits are every rank's answer) and the rank holding the slot keeps
        its KV."""
        self._check_slot(slot)
        dev_batch = {k: v.to(self.torch_device) for k, v in batch.items()}
        last, cache1 = self.model.prefill(self.params, dev_batch, self.max_seq)
        seq_len = cache1["length"]
        if self.kv_pool is not None:
            # the caller's prompt is hashed where it lies (a host prompt
            # costs no device read)
            n, hashes = prompt_prefix_hashes(batch, self.kv_page_tokens)
            entries = self.kv_pool.admit(slot, n, hashes)
            # fresh pages this data rank holds (every page, unsharded)
            local = self._local_pages
            fresh = [(j, page - local.start) for j, (page, is_fresh) in enumerate(entries)
                     if is_fresh and page in local]
            if fresh:
                pages = torch.tensor([page for _, page in fresh], device=self.torch_device)
                srcs = torch.tensor([j for j, _ in fresh], device=self.torch_device)
                pt = self.kv_page_tokens
                for key in ("k", "v"):
                    one = cache1[key][:, 0]
                    view = one.reshape(one.shape[0], self.max_seq // pt, pt, *one.shape[2:])
                    self.cache[key][:, pages] = view[:, srcs]
            self._push_table()
        elif slot in self._local_rows:
            for key in ("k", "v"):
                self.cache[key][:, slot - self._local_rows.start] = cache1[key][:, 0]
        if slot in self._local_rows:
            self.cache["length"][slot - self._local_rows.start].fill_(seq_len)
        self._host_lengths[slot] = seq_len
        # an admission is priced on the simulated clock only (wall 0, as in
        # the reference)
        sim = self._prefill_charge(int(batch["tokens"].shape[1]), f"admit[{slot}]", 0.0)
        return last, sim

    def decode_slots(self, tokens: torch.Tensor, n_tokens: int):
        """A fused decode round over every slot. ``tokens``: (batch, 1) each
        slot's current input (free slots decode garbage their callers drop,
        and their activations feed the batched selection, as in the
        reference). Returns (new tokens (batch, n) on the host, each step's
        charged seconds (n,)). With a paged cache the round's page growth is
        checked whole, on the host mirror of the lengths, before anything is
        allocated: ``KVPoolExhausted`` leaves the engine as it was, so the
        scheduler can preempt a slot and retry."""
        self._check_slot()
        if self.kv_pool is not None and n_tokens > 0:
            lengths = self._host_lengths
            occupied = [s for s in range(self.batch_size) if self.kv_pool.slot_pages(s)]
            need = {s: self.kv_pool.pages_needed(s, int(lengths[s]) + n_tokens - 1)
                    for s in occupied}
            total = sum(need.values())
            if total > self.kv_pool.reclaimable_pages:
                raise KVPoolExhausted(
                    f"decode round needs {total} new KV pages but only "
                    f"{self.kv_pool.reclaimable_pages} are free or cold-evictable — release "
                    "or preempt a slot first (no page was allocated; engine state is "
                    "unchanged)")
            grew = False
            for s in occupied:
                if need[s] and self.kv_pool.ensure(s, int(lengths[s]) + n_tokens - 1):
                    grew = True
            if grew:
                self._push_table()
        return self._run_decode(tokens, n_tokens)

    def slot_lengths(self) -> np.ndarray:
        """Each slot's cache length, read from the card (a host sync; the
        decode path reads the host mirror instead), every data rank's."""
        return self.mesh.gather_batch(self.cache["length"]).cpu().numpy().reshape(-1)

    def note_stall_admission(self, hidden_s: float) -> None:
        """Record one scheduler admission whose prefill was (partly) hidden
        inside measured decode stall windows, for ``io_summary``'s
        ``bubble_utilization``."""
        if hidden_s < 0:
            raise ValueError(f"hidden_s must be >= 0, got {hidden_s}")
        self.admitted_during_stall += 1
        self.stall_hidden_s += float(hidden_s)

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
    def _even_shard_bytes(self, nbytes: float):
        """An even split over the model shards of a transfer that streams
        every matrix whole (a prefill, an admission: each shard its slice);
        None unsharded, so one-device events are unchanged."""
        if not self.mesh.is_sharded:
            return None
        return (float(nbytes) / self.n_shards,) * self.n_shards

    def shard_summary(self) -> Dict[str, object]:
        """The per-shard rollup beside ``io_summary`` (whose key set is
        pinned): the mesh, the transfer bytes by source model shard (the
        row-sharded sites by each shard's own miss rows, the rest split
        evenly; they sum to ``io_summary()['io_bytes']``), the residency
        budget per shard, the slots per data shard and the paged pool's
        live pages by home shard. On the 1×1 mesh one shard holds it all."""
        per_shard = self.simulator.total_bytes_by_shard(self.n_shards)
        n_data = self.mesh.data
        return {
            "mesh_data": self.mesh.data,
            "mesh_model": self.mesh.model,
            "n_shards": self.n_shards,
            "io_bytes": float(sum(per_shard)),
            "io_bytes_per_shard": [float(b) for b in per_shard],
            "cache_mb_per_shard": self.cache_mb / self.n_shards,
            "slots_per_data_shard": self.batch_size // n_data,
            "kv_pages_in_use": self.kv_pool.pages_in_use if self.kv_pool is not None else 0,
            "kv_pages_per_shard": (self.kv_pool.pages_per_shard(n_data)
                                   if self.kv_pool is not None else [0] * n_data),
        }

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
        ``io_summary``: the scheduler lanes count admissions hidden in
        decode stall windows (``bubble_utilization`` = hidden ÷ (stall +
        bubble), at most 1), the fault lanes mirror ``fault_summary``, the
        corruption lanes total the plan's integrity counters, and the
        paged-KV lanes read the live pool (a dense engine reports
        ``kv_cache_mb`` 0, ``weight_cache_mb`` = ``cache_mb`` and zero
        pages)."""
        dec = [s for s in self.stats if s.kind == "decode"]
        hit = sum(s.hit_rows for s in self.stats)
        miss = sum(s.miss_rows for s in self.stats)
        stall = sum(s.stall_s for s in dec)
        bubble = sum(s.bubble_s for s in dec)
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
            "decode_stall_s": stall,
            "decode_bubble_s": bubble,
            "overlap_efficiency": overlap_efficiency(
                [s.serial_s for s in dec], [s.overlap_s for s in dec],
                [s.io_sim_s for s in dec], [s.compute_s for s in dec],
            ),
            "admitted_during_stall": self.admitted_during_stall,
            "stall_hidden_s": self.stall_hidden_s,
            "bubble_utilization": (min(self.stall_hidden_s / (stall + bubble), 1.0)
                                   if (stall + bubble) > 0 else 0.0),
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
            "kv_cache_mb": self.kv_cache_mb,
            "weight_cache_mb": self.weight_cache_mb,
            "kv_pages_in_use": self.kv_pool.pages_in_use if self.kv_pool is not None else 0,
            "kv_shared_pages": self.kv_pool.shared_pages if self.kv_pool is not None else 0,
        }
