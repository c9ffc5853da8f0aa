"""SparseExecution: the paper's runtime policy wired into the model blocks
(the port's copy of ``repro.serving.sparse_exec`` for the ``chunk``,
``topk`` and ``dense`` methods, with the residency cache, static ``cached``
masks and reorderings).

The planned decode path batches every site of every layer into ONE
selection per refresh step (``refresh_step`` → ``BatchedChunkSelector``:
torch scoring + one stable sort over the L·S lanes, then one launch of
kernel K5's greedy walk), consuming the importances each site recorded on
the previous step (``record_importance``; the first refresh bootstraps from
uniform importance). A refresh of layer l reads only layer l's pending
importances, which step t writes after that refresh, so every layer's
selection of step t is known when the step starts — the reference says so
too (layer l+1's chunks must be known while layer l computes). The new
masks become block-aligned chunk tables on the device
(``masks_to_block_tables``), which the kernels K1/K2 read directly.
Nothing here syncs with the host, so the engine's decode loop runs on the
device until its one sync.

The decode plan is a dict {site: {"mask": (L, N) f32, "pending": (L, N)
f32, "hit"/"miss"/"bytes": (L,) f32, "kstarts"/"ksizes": (L, K) int32[,
"score": (L, N) f32]}} updated in place: all layers at once by a refresh,
one layer's pending row at a time by ``record_importance``.

With ``cache_mb > 0`` the dynamic residency cache (paper §5) rides the
plan: each (layer, site) keeps a ``score``; its top ``cap`` rows (a stable
rank, so ties never overflow the cap) are DRAM-resident. A refresh derives
the resident set from the previous epoch's score, selects at marginal cost
(``chunk``: a window costs only its non-resident rows; ``topk`` ranks by
importance alone), charges only the miss rows (``mask_latency_miss``),
then decays the score and adds the step's selected importances. Static
``cached`` masks are pre-warmed and pinned at ``PIN_SCORE`` there; with
``cache_mb == 0`` they are the legacy static path (zero importance, always
computed). ``reorderings`` run the selection in the reordered row order;
the masks go back through ``inverse`` (reference backend only).

The unplanned path (``mask``: frame append, and every decode step of the
``dense`` method) selects one site's mask from the step's own activations:
the site's one-lane ``ChunkSelector.select`` (K5 on the card) or top-k,
priced on every latency table of the site; ``dense`` selects nothing and
charges the site's full contiguous load.

Not ported yet (later slices, ROADMAP.md): integrity/corruption lanes,
degradation budgets and sharded meshes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core.baselines import topk_mask
from ..core.chunking import BatchedChunkSelector, ChunkConfig, ChunkSelector
from ..core.importance import importance
from ..core.latency_model import MB, LatencyTable, get_profile, profile_table, row_stream_bytes
from ..core.offload import decode_site_shapes, normalize_site_sparsity
from ..core.reorder import Reordering
from ..kernels.backend import ExecutionBackend, pick_tile
from ..kernels.chunk_gather_dma import masks_to_block_tables

WBITS_CHOICES = (16, 8)
KERNEL_BLOCK_ROWS = 8
KERNEL_MAX_CHUNK_ROWS = 512
# the serving policies: SPARSE_METHODS run through SparseExecution
# (selection and I/O accounting); "dense_free" means weights resident in
# memory — dense compute with no flash tier, no SparseExecution, zero I/O
SPARSE_METHODS = ("chunk", "topk", "dense")
SERVE_METHODS = SPARSE_METHODS + ("dense_free",)
# the residency cache's policy, as in the reference: scores decay by
# RESIDENCY_DECAY each refresh (recency) and grow by a selected row's
# importance (frequency × magnitude); pinned (pre-warmed) rows hold
# PIN_SCORE, so rank eviction never removes them
RESIDENCY_DECAY = 0.9
PIN_SCORE = 1e30


def validate_method(method: str, allow_dense_free: bool = False) -> str:
    allowed = SERVE_METHODS if allow_dense_free else SPARSE_METHODS
    if method not in allowed:
        raise ValueError(f"unknown sparse method {method!r}; expected one of {allowed}")
    return method


def residency_from_score(score: torch.Tensor, cap) -> torch.Tensor:
    """The resident set of a residency score (..., N): its top ``cap`` rows
    by a stable rank (``topk_mask``: never more than ``cap`` rows, even on
    ties), less the rows never inserted (score <= 0). ``cap`` may be a
    tensor broadcasting against the leading axes (one cap per lane)."""
    return topk_mask(score, cap) & (score > 0.0)


def _plan_total(plan, key: str, device) -> torch.Tensor:
    """Σ over sites and layers of one counter, a 0-d f32 tensor; an empty
    plan (``dense``, ``dense_free``) counts 0, on ``device``."""
    if not plan:
        return torch.zeros((), dtype=torch.float32, device=device)
    return sum(state[key].sum() for state in plan.values())


def plan_hit_miss(plan, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Total (hit_rows, miss_rows) accumulated in a decode plan; without
    the residency tier ``hit`` is 0 and ``miss`` counts every selected row."""
    return _plan_total(plan, "hit", device), _plan_total(plan, "miss", device)


def plan_transfer_bytes(plan, device=None) -> torch.Tensor:
    """Total estimated flash→DRAM bytes accumulated in a decode plan."""
    return _plan_total(plan, "bytes", device)


def reset_plan_counters(plan) -> None:
    """Zero the hit/miss/bytes accumulators in place (once per decode call)."""
    for state in plan.values():
        for key in ("hit", "miss", "bytes"):
            state[key].zero_()


@dataclasses.dataclass(frozen=True, eq=False)
class _Site:
    """One sparsification site: selector + one latency table per matrix
    sharing the input (e.g. q/k/v)."""

    n: int
    selector: ChunkSelector
    tables: Tuple[LatencyTable, ...]
    sparsity: float
    dense_latency: float

    def budget(self) -> int:
        return round((1.0 - self.sparsity) * self.n)


def _site(n_rows: int, out_cols, device: str, sparsity: float, wbits: int,
          torch_device) -> _Site:
    primary_rb = row_stream_bytes(out_cols[0], wbits, KERNEL_BLOCK_ROWS)
    cfg = ChunkConfig.for_shape(n_rows, out_cols[0], device)
    selector = ChunkSelector.build(n_rows, primary_rb, device=device, cfg=cfg)
    tables = tuple(
        profile_table(device, row_stream_bytes(c, wbits, KERNEL_BLOCK_ROWS),
                      max_rows=selector.max_size, torch_device=torch_device)
        for c in out_cols
    )
    dense = float(sum(
        get_profile(device).latency_bytes(n_rows * row_stream_bytes(c, wbits, KERNEL_BLOCK_ROWS))
        for c in out_cols
    ))
    return _Site(n=n_rows, selector=selector, tables=tables, sparsity=sparsity,
                 dense_latency=dense)


class SparseExecution:
    """sparse_ctx passed into the model blocks on the planned decode path."""

    def __init__(self, cfg: ModelConfig, device: str = "nano", sparsity=0.4,
                 method: str = "chunk", reorderings: Optional[Dict[str, Reordering]] = None,
                 cached: Optional[Dict[str, torch.Tensor]] = None, cache_mb: float = 0.0,
                 backend: str | ExecutionBackend = "reference",
                 kernel_prefetch_depth: int = 1, wbits: int = 16, torch_device=None):
        """``device``: the flash profile ("nano" | "agx"); ``torch_device``:
        where the selection runs — ``cuda`` unless the caller passes another
        device (no card raises). ``backend``: "reference" (the kernels'
        schedule twin) or "kernel" (K1/K2 off the plan's chunk tables).

        ``cache_mb``: the DRAM budget of the dynamic residency cache (paper
        §5); > 0 adds the per-(layer, site) ``score`` state, marginal-cost
        selection and miss-only charging, with the row caps resolved by
        ``init_plan``. ``cached``: per-site bool masks (original row order)
        of memory-resident neurons — with ``cache_mb == 0`` they get zero
        importance and always compute; with ``cache_mb > 0`` they are
        pre-warmed and pinned in the score. ``reorderings``: per-site
        ``Reordering``s; selection runs in the reordered order (the
        reference backend only — the kernels gather by storage offset)."""
        validate_method(method)
        if cache_mb < 0:
            raise ValueError(f"cache_mb must be >= 0, got {cache_mb}")
        if wbits not in WBITS_CHOICES:
            raise ValueError(f"wbits must be one of {WBITS_CHOICES}, got {wbits!r}")
        self.cfg = cfg
        self.method = method
        self.wbits = int(wbits)
        self.torch_device = resolve_device(torch_device)
        self.reorderings = dict(reorderings or {})
        self.cache_mb = float(cache_mb)
        self.cache_caps: Optional[Dict[str, int]] = None  # set by init_plan
        sp = normalize_site_sparsity(sparsity)
        self.sites: Dict[str, _Site] = {
            kind: _site(n, cols, device, sp[kind], self.wbits, self.torch_device)
            for kind, n, cols in decode_site_shapes(cfg)
        }
        self.site_order: Tuple[str, ...] = tuple(self.sites)
        # each site's full contiguous load, as the f32 the reference charges
        self._dense_latency = {
            kind: torch.tensor(site.dense_latency, dtype=torch.float32,
                               device=self.torch_device)
            for kind, site in self.sites.items()}
        self.batched = BatchedChunkSelector.build(
            [self.sites[k].selector for k in self.site_order], device=self.torch_device
        )
        self._budgets = torch.tensor([self.sites[k].budget() for k in self.site_order],
                                     dtype=torch.int32, device=self.torch_device)
        # a refresh step's (L·S,) lanes, layer-major: their budgets and the
        # smallest candidate of each (K5's early exit)
        self.lane_budgets = self._budgets.repeat(cfg.n_layers)
        self.lane_min_sizes = self.batched.min_sizes.repeat(cfg.n_layers)
        self.kernel_k = -(-self.batched.n_max // KERNEL_BLOCK_ROWS)
        dev = self.torch_device
        self._perm = {kind: torch.as_tensor(r.perm, dtype=torch.int64, device=dev)
                      for kind, r in self.reorderings.items() if kind in self.sites}
        self._inverse = {kind: torch.as_tensor(r.inverse, dtype=torch.int64, device=dev)
                         for kind, r in self.reorderings.items() if kind in self.sites}
        # the static cached masks: original row order (OR'd into the compute
        # masks) and selection row order (zero importance, or pinned rows)
        self.cached = {kind: m.to(device=dev, dtype=torch.bool)
                       for kind, m in (cached or {}).items() if kind in self.sites}
        self.pinned_sel = {kind: self._to_selection(kind, m.to(torch.float32)) > 0.0
                           for kind, m in self.cached.items()}
        self._pin_pad = None
        if self.pinned_sel:
            self._pin_pad = torch.zeros((self.batched.n_sites, self.batched.n_max),
                                        dtype=torch.bool, device=dev)
            for i, kind in enumerate(self.site_order):
                if kind in self.pinned_sel:
                    self._pin_pad[i, : self.sites[kind].n] = self.pinned_sel[kind]
        self._lane_caps: Optional[torch.Tensor] = None  # (S,) caps, set by init_plan
        self.backend = backend if isinstance(backend, ExecutionBackend) else \
            ExecutionBackend.create(backend, prefetch_depth=kernel_prefetch_depth,
                                    block_rows=KERNEL_BLOCK_ROWS,
                                    max_chunk_rows=KERNEL_MAX_CHUNK_ROWS)
        if self.backend.is_kernel:
            if self.reorderings:
                raise ValueError(
                    "backend='kernel' does not support reorderings: the kernels gather "
                    "weight rows by storage offset, so chunk tables in the reordered "
                    "selection order would index the wrong rows (pre-reorder the stored "
                    "weights offline, or use backend='reference')")
            for kind, n, cols in decode_site_shapes(cfg):
                if n % KERNEL_BLOCK_ROWS:
                    raise ValueError(f"backend='kernel' needs site {kind!r} input dim {n} "
                                     f"divisible by block_rows={KERNEL_BLOCK_ROWS}")
                for c in cols:
                    pick_tile(c)

    # -- the unplanned path -------------------------------------------------------
    def mask(self, kind: str, acts: torch.Tensor):
        """One site's in-step selection from its activations ``acts`` (...,
        N): (mask (N,) f32, or None for ``dense``, estimated I/O seconds as a
        0-d f32 tensor)."""
        site = self.sites[kind]
        if self.method == "dense":
            return None, self._dense_latency[kind]
        v = self._to_selection(kind, importance(acts))
        pinned = self.pinned_sel.get(kind)
        if pinned is not None:
            v = torch.where(pinned, torch.zeros_like(v), v)  # resident: no I/O
        if self.method == "topk":
            m = topk_mask(v, site.budget())
        else:
            m = site.selector.select(v, site.budget())[0]
        lat = 0.0
        for t in site.tables:
            lat = lat + t.mask_latency(m)
        m = self._to_storage(kind, m)
        if kind in self.cached:
            m = m | self.cached[kind]  # cached neurons always compute, at zero I/O
        return m.to(torch.float32), lat

    def _to_selection(self, kind: str, v: torch.Tensor) -> torch.Tensor:
        """A site's (..., N) vector in selection (reordered) row order."""
        perm = self._perm.get(kind)
        return v if perm is None else v.index_select(-1, perm)

    def _to_storage(self, kind: str, m: torch.Tensor) -> torch.Tensor:
        """A site's (..., N) selection-order mask back in original row order."""
        inv = self._inverse.get(kind)
        return m if inv is None else m.index_select(-1, inv)

    # -- per-step plan maintenance --------------------------------------------
    def record_importance(self, kind: str, acts: torch.Tensor, plan, layer: int) -> None:
        """Stash this step's importance of site ``kind`` as the ``pending``
        vector the next refresh of ``layer`` consumes (in place)."""
        if kind in plan:
            plan[kind]["pending"][layer] = self._to_selection(kind, importance(acts))

    def _select_lanes(self, vs: torch.Tensor, resident: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """(L·S, N_max) padded importances → (L·S, N_max) bool masks; with
        ``resident`` (same shape) ``chunk`` selects at marginal cost, while
        ``topk`` ranks by importance alone (the baseline ignores the cache
        in its selection, as in the reference)."""
        b = self.batched
        if self.method == "topk":
            masks = topk_mask(vs, self.lane_budgets).reshape(-1, b.n_sites, b.n_max) \
                & b.row_valid
            return masks.reshape(vs.shape)
        return b.select(vs, self.lane_budgets, self.lane_min_sizes, resident=resident)[0]

    def refresh_step(self, plan, refresh: bool) -> torch.Tensor:
        """One batched refresh of every site of every layer (in place) — the
        port's form of the reference's per-layer ``refresh_layer`` inside
        its layer scan. On a refresh step the sites' pending importances of
        all L layers are padded into one (L·n_sites, N_max) problem,
        selected (one stable sort, one K5 launch), turned into kernel tables
        (one ``masks_to_block_tables``), and priced, vectorised over the
        layers; on a reuse step (``refresh`` False — host-known, the
        engine's ``step % k == 0``) the cached masks, tables and residency
        scores stay, cost zero I/O and launch nothing. With the residency
        cache the resident sets come from the previous epoch's scores
        (padding rows score 0, so they are never resident), then the
        selection, then the score update. Returns the per-layer estimated
        I/O seconds (L,) f32, each layer's sum taken in the per-layer order
        (sites, then their matrices)."""
        order = self.site_order
        if set(plan) != set(order):
            raise ValueError(f"refresh_step needs a plan entry per site {order}, "
                             f"got {tuple(plan)}")
        n_layers = plan[order[0]]["pending"].shape[0]
        if n_layers != self.cfg.n_layers:
            raise ValueError(f"refresh_step needs a plan of {self.cfg.n_layers} layers, "
                             f"got {n_layers}")
        lat = torch.zeros((n_layers,), dtype=torch.float32, device=self.torch_device)
        if not refresh:
            return lat
        cache = self.cache_enabled
        b = self.batched
        shape = (n_layers, b.n_sites, b.n_max)
        vs = torch.zeros(shape, dtype=torch.float32, device=self.torch_device)
        scores = torch.zeros(shape, dtype=torch.float32, device=self.torch_device) \
            if cache else None
        for i, kind in enumerate(order):
            vs[:, i, : self.sites[kind].n] = plan[kind]["pending"]
            if cache:
                scores[:, i, : self.sites[kind].n] = plan[kind]["score"]
        pin = self._pin_pad
        if pin is not None and not cache:
            # the legacy static path: memory-resident rows get zero
            # importance (never streamed) and join the compute mask below
            vs = torch.where(pin, torch.zeros_like(vs), vs)
        resident = None
        if cache:
            resident = residency_from_score(scores, self._caps())
        masks = self._select_lanes(vs.reshape(-1, b.n_max),
                                   None if resident is None else resident.reshape(-1, b.n_max))
        masks = masks.reshape(shape)
        tbl_masks = masks | pin if pin is not None and not cache else masks
        kstarts, ksizes = masks_to_block_tables(tbl_masks.reshape(-1, b.n_max),
                                                KERNEL_BLOCK_ROWS, KERNEL_MAX_CHUNK_ROWS)
        kstarts = kstarts.reshape(n_layers, b.n_sites, -1)
        ksizes = ksizes.reshape(n_layers, b.n_sites, -1)
        for i, kind in enumerate(order):
            site = self.sites[kind]
            entry = plan[kind]
            m = masks[:, i, : site.n]
            if cache:
                res = resident[:, i, : site.n]
                for t in site.tables:
                    lat = lat + t.mask_latency_miss(m, res)
                hit = (m & res).sum(dim=1).to(torch.float32)
                miss = (m & ~res).sum(dim=1).to(torch.float32)
                # decay every row, reinforce the selected ones
                score = RESIDENCY_DECAY * entry["score"] + torch.where(
                    m, entry["pending"], torch.zeros_like(entry["pending"]))
                if kind in self.pinned_sel:
                    score = torch.where(self.pinned_sel[kind], PIN_SCORE, score)
                entry["score"].copy_(score)
                entry["hit"] += hit
            else:
                for t in site.tables:
                    lat = lat + t.mask_latency(m)
                miss = m.sum(dim=1).to(torch.float32)
            m = self._to_storage(kind, m)
            if kind in self.cached and not cache:
                m = m | self.cached[kind]  # cached neurons always compute, free
            entry["mask"].copy_(m)
            entry["miss"] += miss
            entry["bytes"] += miss * self.site_row_bytes(kind)
            entry["kstarts"].copy_(kstarts[:, i])
            entry["ksizes"].copy_(ksizes[:, i])
        return lat

    # -- kernel chunk-table plumbing ------------------------------------------
    def kernel_tables(self, plan, kind: str, layer: int):
        """One site's (starts, sizes) chunk tables of ``layer``, each (K,)."""
        if kind not in plan:
            raise KeyError(f"no plan entry for site {kind!r}")
        return plan[kind]["kstarts"][layer], plan[kind]["ksizes"][layer]

    def mlp_kernel_plan(self, plan, layer: int):
        """K2's (2, K) plan lanes: lane 0 = hidden_mlp (gate/up), lane 1 = ffn."""
        hs, hz = self.kernel_tables(plan, "hidden_mlp", layer)
        fs, fz = self.kernel_tables(plan, "ffn", layer)
        return torch.stack([hs, fs]), torch.stack([hz, fz])

    # -- accounting ------------------------------------------------------------
    def site_row_bytes(self, kind: str) -> float:
        """Streamed bytes of one row across every matrix sharing the site."""
        return float(sum(t.row_bytes for t in self.sites[kind].tables))

    def sparsifiable_bytes(self, n_layers: int) -> float:
        return n_layers * sum(site.n * self.site_row_bytes(kind)
                              for kind, site in self.sites.items())

    # -- residency-tier capacity ------------------------------------------------
    @property
    def cache_enabled(self) -> bool:
        """The residency tier serves the selecting methods only: ``dense``
        streams every matrix every step whatever the budget."""
        return self.cache_mb > 0 and self.method in ("chunk", "topk")

    def _resolve_cache(self, n_layers: int) -> Dict[str, int]:
        """Split the byte budget into per-(layer, site) row caps: the same
        fraction of every matrix is cacheable, cap_rows = frac · N (host
        ints, worked out once per plan)."""
        total = self.sparsifiable_bytes(n_layers)
        frac = min(1.0, self.cache_mb * MB / max(total, 1))
        self.cache_caps = {kind: int(frac * site.n) for kind, site in self.sites.items()}
        self._lane_caps = torch.tensor([self.cache_caps[k] for k in self.site_order],
                                       dtype=torch.int64, device=self.torch_device)
        return self.cache_caps

    def _caps(self) -> torch.Tensor:
        """The sites' row caps as an (S,) tensor in site order."""
        if self._lane_caps is None:
            raise RuntimeError("residency capacity unresolved — call init_plan(n_layers) "
                               "before refresh_step with the residency cache enabled")
        return self._lane_caps

    def dense_total_latency(self) -> float:
        """Full-load I/O latency per layer (all sites dense)."""
        return float(sum(s.dense_latency for s in self.sites.values()))

    def init_plan(self, n_layers: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """A fresh decode plan: empty masks and tables, uniform pending
        importance (the first refresh's bootstrap), zero counters; with the
        residency cache a zero ``score`` (L, N) per site, its pinned
        ``cached`` rows pre-warmed at ``PIN_SCORE`` (the caps are resolved
        here). ``dense`` plans nothing: its decode takes the unplanned
        path."""
        if self.method == "dense":
            return {}
        if self.cache_enabled:
            self._resolve_cache(n_layers)
        dev = self.torch_device
        plan = {}
        for kind, site in self.sites.items():
            plan[kind] = {
                "mask": torch.zeros((n_layers, site.n), dtype=torch.float32, device=dev),
                "pending": torch.ones((n_layers, site.n), dtype=torch.float32, device=dev),
                "hit": torch.zeros((n_layers,), dtype=torch.float32, device=dev),
                "miss": torch.zeros((n_layers,), dtype=torch.float32, device=dev),
                "bytes": torch.zeros((n_layers,), dtype=torch.float32, device=dev),
                "kstarts": torch.zeros((n_layers, self.kernel_k), dtype=torch.int32, device=dev),
                "ksizes": torch.zeros((n_layers, self.kernel_k), dtype=torch.int32, device=dev),
            }
            if self.cache_enabled:
                score = torch.zeros((n_layers, site.n), dtype=torch.float32, device=dev)
                if kind in self.pinned_sel:
                    score = torch.where(self.pinned_sel[kind], PIN_SCORE, score)
                plan[kind]["score"] = score
        return plan

    def time_selection(self, repeats: int = 5) -> float:
        """Median wall seconds of ONE refresh step's selection — every site
        of every layer of ``cfg``, one K5 launch — on the serving device
        (synchronized), amortized by the engine into
        ``StepStats.select_overhead_s``; 0 for ``dense``, which selects
        nothing."""
        if self.method == "dense":
            return 0.0
        b = self.batched
        n_layers = self.cfg.n_layers
        lanes = n_layers * b.n_sites
        n = torch.arange(lanes * b.n_max, dtype=torch.float32, device=self.torch_device)
        vs = torch.sin(n).abs().reshape(lanes, b.n_max)

        def run():
            self._select_lanes(vs)
            if self.torch_device.type == "cuda":
                torch.cuda.synchronize(self.torch_device)

        run()  # warm (builds the kernel on first use)
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        return float(sorted(walls)[len(walls) // 2])
