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
Without corruption injection nothing here syncs with the host, so the
engine's decode loop runs on the device until its one sync.

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

``degradable`` adds a per-layer ``bscale`` lane, the degradation
controller's lever: a refresh's budgets are ``clip(floor(b · scale),
min(b, 1), b)``, so scale 1.0 is bit-exact the static budgets.

With a corruption profile (core/faults.py) every refresh runs the
integrity ladder between the selection and the table build, vectorised
over the layers: per (site, matrix) it draws which FETCHED blocks
(selected, not resident) arrive corrupt, verifies exactly those blocks
against the pack-time checksum lane, and — recovery on — re-reads them
(re-read + backoff seconds in the ``crr_s`` lane, never in the estimate),
serves the resident DRAM copy where every fetched row of the block was in
the previous epoch's mask (rung 1), substitutes the next-best unselected
rows by pending importance for a block still unreadable (rung 2, the row
count never grows) and drops what the candidates cannot cover (rung 3).
I/O is charged on the fetch mask (the selection plus substitutes); the
post-ladder mask is the compute mask. With recovery off the damage flows
into compute: the refresh keeps the damaged rows (``cpatch``), which the
decode step writes into the streamed payloads around its gathers and then
restores (``apply_corruption``). The verify needs the count of blocks
drawn corrupt, so a refresh with integrity on syncs with the host once.

On a sharded serve ``mesh`` (sharding/serve.py) selection stays
replicated: every site's activations are gathered over the data ranks
before their importance is reduced (``ServeMesh.replicate``), so every rank
selects the same chunks; the backend gathers the model-sharded weights at
the compute boundary. The sites whose streamed rows shard over the model
axis (``attn_out``: wo's rows, ``ffn``: w_down's / w_proj's) count their
hit and miss rows per model shard (``hit_shard`` / ``miss_shard`` lanes,
(L, n_shards)), which ``plan_shard_bytes`` prices; the other sites' bytes
split evenly. Reorderings and corruption injection are refused there.
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
from ..core.faults import (
    STREAM_BIT,
    STREAM_BLOCKS,
    STREAM_ELEM,
    STREAM_REREADS,
    CorruptionModel,
    CorruptionProfile,
)
from ..core.importance import importance
from ..core.latency_model import MB, LatencyTable, get_profile, profile_table, row_stream_bytes
from ..core.offload import decode_site_shapes, normalize_site_sparsity
from ..core.reorder import Reordering
from ..kernels.backend import ExecutionBackend, pick_tile
from ..kernels.chunk_gather_dma import masks_to_block_tables
from ..kernels.quantize import QUANT_SUFFIX_PAYLOAD, checksum_words
from ..sharding.serve import ServeMesh

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
# the integrity ladder's per-(layer, site) counter lanes: detected corrupt
# block events, events recovered (clean re-read or rung 1's DRAM copy), rows
# substituted (rung 2), rows dropped (rung 3), re-reads charged, and the
# re-read + backoff seconds the engine routes into IOEvent.integrity_s
INTEGRITY_COUNTER_KEYS = ("cdet", "crec", "csub", "cdrop", "crr", "crr_s")


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


def plan_integrity_counters(plan, device=None) -> torch.Tensor:
    """The integrity counters accumulated in a decode plan, one (6,) f32
    vector ordered like ``INTEGRITY_COUNTER_KEYS``; zero without them."""
    out = torch.zeros((len(INTEGRITY_COUNTER_KEYS),), dtype=torch.float32, device=device)
    for state in (plan or {}).values():
        if "cdet" in state:
            out = out + torch.stack([state[k].sum() for k in INTEGRITY_COUNTER_KEYS])
    return out


def reset_plan_counters(plan) -> None:
    """Zero the hit/miss/bytes (and integrity) accumulators in place, once
    per decode call."""
    for state in plan.values():
        for key in ("hit", "miss", "bytes", "hit_shard", "miss_shard") + INTEGRITY_COUNTER_KEYS:
            if key in state:
                state[key].zero_()


def set_plan_budget_scale(plan, scale: float) -> None:
    """Write the degradation controller's budget scale into every layer and
    site of a degradable plan (its ``bscale`` lane, in place); a plan
    without the lane is left as it is."""
    s = float(scale)
    if not (0.0 < s <= 1.0):
        raise ValueError(f"budget scale must be in (0, 1], got {scale}")
    for state in (plan or {}).values():
        if "bscale" in state:
            state["bscale"].fill_(s)


def plan_budget_scale(plan) -> Optional[float]:
    """The (uniform) budget scale a degradable plan carries, or None."""
    for state in (plan or {}).values():
        if "bscale" in state:
            return float(state["bscale"].reshape(-1)[0])
    return None


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
                 kernel_prefetch_depth: int = 1, wbits: int = 16, torch_device=None,
                 degradable: bool = False,
                 corruption_profile: Optional[str | CorruptionProfile] = None,
                 corruption_seed: int = 0, max_reread: int = 2,
                 corruption_recover: bool = True, mesh: Optional[ServeMesh] = None):
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
        reference backend only — the kernels gather by storage offset).

        ``degradable``: the plan carries the per-layer ``bscale`` lane the
        degradation controller writes (``set_plan_budget_scale``).
        ``corruption_profile`` / ``corruption_seed`` / ``max_reread`` /
        ``corruption_recover``: data-plane corruption and the integrity
        ladder (see the module doc); a profile that corrupts needs a
        selecting method, no reorderings, the unsharded mesh and sites of
        whole 8-row blocks. None or "none" is bit-identical to running
        without them.

        ``mesh``: the serve mesh (default: the unsharded 1×1 one). On a
        sharded mesh selection stays replicated and the row-sharded sites
        count their rows per model shard (see the module doc)."""
        validate_method(method)
        if cache_mb < 0:
            raise ValueError(f"cache_mb must be >= 0, got {cache_mb}")
        if wbits not in WBITS_CHOICES:
            raise ValueError(f"wbits must be one of {WBITS_CHOICES}, got {wbits!r}")
        self.cfg = cfg
        self.method = method
        self.wbits = int(wbits)
        self.torch_device = resolve_device(torch_device)
        self.mesh = mesh if mesh is not None else ServeMesh.single()
        if self.mesh.is_sharded and reorderings:
            raise ValueError("sharded serving does not support reorderings: per-shard block "
                             "tables and byte counters assume selection row order equals "
                             "storage row order (pre-reorder the stored weights offline, or "
                             "serve on the 1x1 mesh)")
        self.reorderings = dict(reorderings or {})
        self.degradable = bool(degradable)
        self.corruption: Optional[CorruptionModel] = None
        if corruption_profile is not None:
            cm = CorruptionModel(corruption_profile, seed=corruption_seed,
                                 max_reread=max_reread, recover=corruption_recover)
            if cm.enabled:
                if method not in ("chunk", "topk"):
                    raise ValueError("corruption injection needs a selecting method "
                                     "('chunk' | 'topk') whose recovery ladder can edit the "
                                     f"chunk plan, got {method!r}")
                if self.mesh.is_sharded:
                    raise ValueError("corruption injection does not support sharded serving: "
                                     "the recovery ladder edits per-shard block tables it "
                                     "cannot see (serve on the 1x1 mesh)")
                if self.reorderings:
                    raise ValueError("corruption injection does not support reorderings: "
                                     "the rung-1 resident-copy check assumes selection row "
                                     "order equals storage row order")
                self.corruption = cm
        self.cache_mb = float(cache_mb)
        self.cache_caps: Optional[Dict[str, int]] = None  # set by init_plan
        sp = normalize_site_sparsity(sparsity)
        self.sites: Dict[str, _Site] = {
            kind: _site(n, cols, device, sp[kind], self.wbits, self.torch_device)
            for kind, n, cols in decode_site_shapes(cfg)
        }
        if self.corruption is not None:
            for kind, site in self.sites.items():
                if site.n % KERNEL_BLOCK_ROWS:
                    raise ValueError(f"corruption injection needs site {kind!r} input dim "
                                     f"{site.n} divisible by block_rows={KERNEL_BLOCK_ROWS}")
        self.site_order: Tuple[str, ...] = tuple(self.sites)
        # the per-shard I/O geometry: the sites whose streamed rows shard over
        # the model axis count their rows per shard (shard s owns the
        # contiguous rows [s·n/S, (s+1)·n/S)); the others split evenly
        self.n_shards = self.mesh.model if self.mesh.is_sharded else 1
        self.row_shards: Dict[str, int] = {
            kind: (self.mesh.row_shard_count(site.n) if kind in ("attn_out", "ffn") else 1)
            for kind, site in self.sites.items()}
        # the sites that count their rows per shard: the row-sharded ones on a
        # sharded mesh (lanes of width 1 on a one-rank mesh)
        self.shard_lanes: Dict[str, bool] = {
            kind: (self.mesh.is_sharded and kind in ("attn_out", "ffn")
                   and self.row_shards[kind] == self.n_shards)
            for kind in self.sites}
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
        self._meta: Optional[dict] = None  # the integrity ladder's constants
        if isinstance(backend, ExecutionBackend):
            if self.mesh.is_sharded and backend.mesh is None:
                # the operand gather keeps sharded decode bitwise: a backend
                # built without the mesh must not skip it
                backend = dataclasses.replace(backend, mesh=self.mesh.mesh)
            self.backend = backend
        else:
            self.backend = ExecutionBackend.create(backend, prefetch_depth=kernel_prefetch_depth,
                                                   block_rows=KERNEL_BLOCK_ROWS,
                                                   max_chunk_rows=KERNEL_MAX_CHUNK_ROWS,
                                                   mesh=self.mesh.mesh)
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

    # -- chunk integrity ------------------------------------------------------------
    @property
    def integrity_enabled(self) -> bool:
        """Corruption injection is on: refreshes draw, verify and (with
        recovery) climb the ladder, and the plan carries the lanes."""
        return self.corruption is not None

    @property
    def integrity_corrupting(self) -> bool:
        """Recovery off: the drawn damage flows into the gathers."""
        return self.corruption is not None and not self.corruption.recover

    def site_matrix_count(self, kind: str) -> int:
        """How many stored matrices stream through a site (the width of its
        integrity lanes): q/k/v, gate/up, else one — the gelu family's
        hidden_mlp streams w_fc alone, though ``decode_site_shapes`` prices
        it as two lanes of d_ff columns, as the reference does."""
        if kind == "hidden_mlp" and self.cfg.mlp == "gelu":
            return 1
        return {"hidden_attn": 3, "hidden_mlp": 2}.get(kind, 1)

    def apply_corruption(self, plan, layers, names) -> list:
        """Recovery off: write the last refresh's damaged rows into the
        streamed payload leaves of the stacked ``layers`` (in place), for
        the gathers of one decode step; ``names``: {site: its matrices'
        names, in site matrix order}. Returns what ``restore_payloads``
        needs to put the clean rows back (an empty list when nothing is
        damaged). Both backends gather the same damaged rows."""
        undo = []
        if not self.integrity_corrupting:
            return undo
        suffix = QUANT_SUFFIX_PAYLOAD if self.wbits == 8 else ""
        for kind, mats in names.items():
            for name, patch in zip(mats, plan[kind]["cpatch"]):
                if patch is None:
                    continue
                leaf = layers[name + suffix]
                rows = leaf.view(-1, leaf.shape[-1])  # (L·N, D), in place
                idx, vals = patch
                undo.append((rows, idx, rows.index_select(0, idx)))
                rows.index_copy_(0, idx, vals)
        return undo

    @staticmethod
    def restore_payloads(undo) -> None:
        """Put back the clean rows ``apply_corruption`` replaced."""
        for rows, idx, clean in reversed(undo):
            rows.index_copy_(0, idx, clean)

    # -- the unplanned path -------------------------------------------------------
    def mask(self, kind: str, acts: torch.Tensor):
        """One site's in-step selection from its activations ``acts`` (...,
        N): (mask (N,) f32, or None for ``dense``, estimated I/O seconds as a
        0-d f32 tensor)."""
        site = self.sites[kind]
        if self.method == "dense":
            return None, self._dense_latency[kind]
        # every data rank reduces the whole batch, in the 1×1 order
        v = self._to_selection(kind, importance(self.mesh.replicate(acts)))
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
        vector the next refresh of ``layer`` consumes (in place); on a
        sharded mesh over the whole batch, gathered from every data rank."""
        if kind in plan:
            acts = self.mesh.replicate(acts)
            plan[kind]["pending"][layer] = self._to_selection(kind, importance(acts))

    def _select_lanes(self, vs: torch.Tensor, resident: Optional[torch.Tensor] = None,
                      budgets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(L·S, N_max) padded importances → (L·S, N_max) bool masks; with
        ``resident`` (same shape) ``chunk`` selects at marginal cost, while
        ``topk`` ranks by importance alone (the baseline ignores the cache
        in its selection, as in the reference). ``budgets``: (L·S,) lane
        budgets, the static ones by default."""
        b = self.batched
        budgets = self.lane_budgets if budgets is None else budgets
        if self.method == "topk":
            masks = topk_mask(vs, budgets).reshape(-1, b.n_sites, b.n_max) & b.row_valid
            return masks.reshape(vs.shape)
        return b.select(vs, budgets, self.lane_min_sizes, resident=resident)[0]

    def _lane_budgets(self, plan) -> torch.Tensor:
        """The refresh's (L·S,) lane budgets: the static ones, or on a
        degradable plan ``clip(floor(b · bscale), min(b, 1), b)`` per layer
        in f32 (floor(b · 1.0) == b, so scale 1.0 is bit-exact)."""
        bscale = plan[self.site_order[0]].get("bscale")
        if bscale is None:
            return self.lane_budgets
        b = self._budgets[None, :]
        scaled = torch.floor(b.to(torch.float32) * bscale[:, None]).to(torch.int32)
        return torch.minimum(torch.maximum(scaled, torch.clamp(b, max=1)), b).reshape(-1)

    def refresh_step(self, plan, refresh: bool, weights=None) -> torch.Tensor:
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
        (sites, then their matrices).

        ``weights`` (integrity on): {site: ((payload (L, N, D), checksums
        (L, N/8) int32), ...)} in the site's matrix order — the stored
        leaves the decode streams, with their pack-time lanes. The ladder
        runs between the selection and the table build (see the module
        doc); the tables and the compute masks are the post-ladder ones."""
        order = self.site_order
        if set(plan) != set(order):
            raise ValueError(f"refresh_step needs a plan entry per site {order}, "
                             f"got {tuple(plan)}")
        if self.integrity_enabled:
            if weights is None:
                raise ValueError("corruption injection is on but refresh_step got no "
                                 "weights: the planned decode must pass each site's "
                                 "(payload, checksums) matrices")
            for kind in order:
                want, got = self.site_matrix_count(kind), len(weights.get(kind, ()))
                if got != want:
                    raise ValueError(f"site {kind!r} streams {want} matrices, integrity "
                                     f"weights carry {got}")
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
                                   None if resident is None else resident.reshape(-1, b.n_max),
                                   self._lane_budgets(plan))
        masks = masks.reshape(shape)
        fetch = {}
        if self.integrity_enabled:
            fetch = self._integrity_ladder(plan, masks, resident, weights)
        tbl_masks = masks | pin if pin is not None and not cache else masks
        kstarts, ksizes = masks_to_block_tables(tbl_masks.reshape(-1, b.n_max),
                                                KERNEL_BLOCK_ROWS, KERNEL_MAX_CHUNK_ROWS)
        kstarts = kstarts.reshape(n_layers, b.n_sites, -1)
        ksizes = ksizes.reshape(n_layers, b.n_sites, -1)
        for i, kind in enumerate(order):
            site = self.sites[kind]
            entry = plan[kind]
            m = masks[:, i, : site.n]
            # the rows that streamed (with the ladder: the selection and its
            # substitutes, dropped rows' wasted reads included); ``m`` is the
            # compute mask
            mf = fetch.get(kind, m)
            if cache:
                res = resident[:, i, : site.n]
                for t in site.tables:
                    lat = lat + t.mask_latency_miss(mf, res)
                hit_rows = m & res
                miss_rows = mf & ~res
                hit = hit_rows.sum(dim=1).to(torch.float32)
                miss = miss_rows.sum(dim=1).to(torch.float32)
                # decay every row, reinforce the selected ones
                score = RESIDENCY_DECAY * entry["score"] + torch.where(
                    m, entry["pending"], torch.zeros_like(entry["pending"]))
                if kind in self.pinned_sel:
                    score = torch.where(self.pinned_sel[kind], PIN_SCORE, score)
                entry["score"].copy_(score)
                entry["hit"] += hit
            else:
                for t in site.tables:
                    lat = lat + t.mask_latency(mf)
                hit_rows, miss_rows = None, mf
                miss = mf.sum(dim=1).to(torch.float32)
            ns = self.row_shards[kind]
            if self.shard_lanes[kind]:
                # which model shard each row streams from, counted in
                # selection (= storage: no reorderings on a mesh) row order
                per = (n_layers, ns, site.n // ns)
                if hit_rows is not None:
                    entry["hit_shard"] += hit_rows.reshape(per).sum(dim=2).to(torch.float32)
                entry["miss_shard"] += miss_rows.reshape(per).sum(dim=2).to(torch.float32)
            m = self._to_storage(kind, m)
            if kind in self.cached and not cache:
                m = m | self.cached[kind]  # cached neurons always compute, free
            entry["mask"].copy_(m)
            entry["miss"] += miss
            entry["bytes"] += miss * self.site_row_bytes(kind)
            entry["kstarts"].copy_(kstarts[:, i])
            entry["ksizes"].copy_(ksizes[:, i])
        return lat

    def _integrity_ladder(self, plan, masks: torch.Tensor, resident: Optional[torch.Tensor],
                          weights) -> Dict[str, torch.Tensor]:
        """Draw → verify → re-read → rung 1 → rung 2 → rung 3 for every
        site of every layer of a refresh (the reference's per-layer ladder,
        vectorised over the layers; the draws of every (site, matrix) come
        from one hash per stream over an (M, L, nb_max) grid). Edits
        ``masks`` (L, S, N_max) in place to the compute masks, accumulates
        the counters and advances the epoch in ``plan``, and returns each
        site's (L, N) fetch mask."""
        cm = self.corruption
        order = self.site_order
        n_layers = masks.shape[0]
        dev = masks.device
        lid = plan[order[0]]["lid"].to(torch.int64)
        epoch = plan[order[0]]["epoch"].to(torch.int64) + 1
        meta = self._ladder_meta(weights)
        pairs, nbs = meta["pairs"], meta["nbs"]
        bidx = torch.arange(max(nbs), device=dev)
        grid = (lid[None, :, None], epoch[None, :, None], meta["site"][:, None, None],
                meta["matrix"][:, None, None], bidx[None, None, :])
        # 1. which fetched blocks of every (site, matrix) arrive corrupt
        geo = []
        fetched_blk = torch.zeros((len(pairs), n_layers, max(nbs)), dtype=torch.bool,
                                  device=dev)
        for i, kind in enumerate(order):
            n = self.sites[kind].n
            nb = n // KERNEL_BLOCK_ROWS
            m = masks[:, i, :n].clone()
            fetched = m if resident is None else m & ~resident[:, i, :n]
            fb = fetched.reshape(n_layers, nb, KERNEL_BLOCK_ROWS).any(dim=2)
            # rung 1's eligibility: every fetched row of the block was in the
            # previous epoch's mask, so the DRAM working copy still holds it
            prev = plan[kind]["mask"] > 0.0
            prev_cover = (~fetched | prev).reshape(n_layers, nb, KERNEL_BLOCK_ROWS).all(dim=2)
            geo.append((m, fetched, prev_cover))
            for j in meta["of_site"][i]:
                fetched_blk[j, :, :nb] = fb
        corrupt = cm.draw_blocks(fetched_blk, cm.uniforms(STREAM_BLOCKS, *grid))
        # 2. verify exactly the blocks drawn corrupt, gathered from the
        # damaged payload (undamaged blocks check equal by construction)
        det, patches = self._verify(corrupt, meta, weights, lid, epoch)
        if cm.recover:
            u = (cm.uniforms(STREAM_REREADS, *grid) if cm.profile.p_stuck > 0.0 else None)
            rereads, recovered = cm.draw_rereads(det, u)
            backoff = cm.backoff_seconds(rereads)
        fetch = {}
        for i, kind in enumerate(order):
            m, fetched, prev_cover = geo[i]
            entry = plan[kind]
            nb = prev_cover.shape[1]
            zero = torch.zeros((n_layers,), dtype=torch.float32, device=dev)
            cdet = crec = crr = crr_s = csub = cdrop = zero
            unrec_bad = torch.zeros_like(prev_cover)
            for j in meta["of_site"][i]:
                d = det[j, :, :nb]
                cdet = cdet + d.sum(dim=1).to(torch.float32)
                if not cm.recover:
                    continue
                # 3. re-reads, then rung 1 (the resident DRAM copy)
                rr, rec = rereads[j, :, :nb], recovered[j, :, :nb]
                n_rr = rr.sum(dim=1).to(torch.float32)
                crr = crr + n_rr
                crr_s = crr_s + (n_rr * meta["reread_s"][j] + backoff[j, :, :nb].sum(dim=1))
                crec = crec + rec.sum(dim=1).to(torch.float32)
                unrec = d & ~rec
                crec = crec + (unrec & prev_cover).sum(dim=1).to(torch.float32)
                unrec_bad = unrec_bad | (unrec & ~prev_cover)
            mf = m
            if cm.recover:
                # rungs 2/3: a block unreadable in any matrix takes the site's
                # fetched rows of it away; the next-best unselected rows by
                # pending importance (outside the unreadable blocks) stand
                # in, and what they cannot cover is dropped
                n = m.shape[1]
                bad_rows = unrec_bad.repeat_interleave(KERNEL_BLOCK_ROWS, dim=1)
                removed = fetched & bad_rows
                k = removed.sum(dim=1)
                cand = ~m & ~bad_rows
                pending = entry["pending"]
                key = torch.where(cand, -pending, torch.full_like(pending, float("inf")))
                ranked = torch.argsort(key, dim=1, stable=True)
                rank = torch.empty_like(ranked).scatter_(
                    1, ranked, torch.arange(n, device=dev).expand(n_layers, n).contiguous())
                sub = cand & (rank < k[:, None])
                csub = sub.sum(dim=1).to(torch.float32)
                cdrop = k.to(torch.float32) - csub
                masks[:, i, :n] = (m & ~removed) | sub
                mf = m | sub
            else:
                mats = meta["of_site"][i]
                entry["cblk"].copy_(corrupt[mats][:, :, :nb].transpose(0, 1))
                entry["cpatch"] = [patches[j] for j in mats]
            fetch[kind] = mf
            for key, v in zip(INTEGRITY_COUNTER_KEYS, (cdet, crec, csub, cdrop, crr, crr_s)):
                entry[key] += v
            entry["epoch"].copy_(epoch)
        return fetch

    def _ladder_meta(self, weights) -> dict:
        """The ladder's constants, made on the device once per engine: the
        (site, matrix) pairs in site then matrix order and each site's pair
        indices, their block counts, site and matrix indices, payload
        elements a block and bits a word, and the read seconds of one 8-row
        block from each matrix's latency table (built on first use: a
        host-to-device copy waits for the card)."""
        if self._meta is None:
            dev, order = self.torch_device, self.site_order
            pairs = [(i, mi) for i, kind in enumerate(order)
                     for mi in range(self.site_matrix_count(kind))]
            ws = [weights[order[i]][mi][0] for i, mi in pairs]
            block = torch.tensor(KERNEL_BLOCK_ROWS, device=dev)
            tables = [self.sites[order[i]].tables for i, _ in pairs]
            self._meta = {
                "pairs": pairs,
                "of_site": [[j for j, (si, _) in enumerate(pairs) if si == i]
                            for i in range(len(order))],
                "nbs": [self.sites[order[i]].n // KERNEL_BLOCK_ROWS for i, _ in pairs],
                "site": torch.tensor([i for i, _ in pairs], device=dev),
                "matrix": torch.tensor([mi for _, mi in pairs], device=dev),
                "elems": torch.tensor([KERNEL_BLOCK_ROWS * w.shape[-1] for w in ws], device=dev),
                "bits": torch.tensor([8 * w.element_size() for w in ws], device=dev),
                "reread_s": [t[min(mi, len(t) - 1)].lookup(block).to(torch.float32)
                             for t, (_, mi) in zip(tables, pairs)],
            }
        return self._meta

    def _verify(self, corrupt: torch.Tensor, meta: dict, weights, lid: torch.Tensor,
                epoch: torch.Tensor):
        """The (M, L, nb_max) detected blocks of every (site, matrix): the
        blocks drawn corrupt, damaged as the profile says, checksummed and
        compared with the stored lane; and per (site, matrix) the damaged
        rows (None where nothing was drawn). The count of corrupt blocks per
        matrix is the refresh's one host sync."""
        cm = self.corruption
        order, pairs = self.site_order, meta["pairs"]
        hit = corrupt.nonzero()  # (C, 3): matrix, layer, block, sorted by matrix
        counts = torch.bincount(hit[:, 0], minlength=len(pairs)).tolist()  # the host sync
        det = torch.zeros_like(corrupt)
        patches = [None] * len(pairs)
        mi_, li, bi = hit[:, 0], hit[:, 1], hit[:, 2]
        if cm.profile.mode == "flip":
            # every hit's element and bit, in one draw per stream
            draw = (lid[li], epoch[li], meta["site"][mi_], meta["matrix"][mi_], bi)
            elem = cm.integers(STREAM_ELEM, *draw, meta["elems"][mi_])
            bit = cm.integers(STREAM_BIT, *draw, meta["bits"][mi_])
        bounds = [0]
        for c in counts:
            bounds.append(bounds[-1] + c)
        for j, (i, m) in enumerate(pairs):  # the hits come sorted by matrix
            lo, hi = bounds[j], bounds[j + 1]
            if hi == lo:
                continue
            w, ck = weights[order[i]][m]
            flip = None if cm.profile.mode != "flip" else (elem[lo:hi], bit[lo:hi])
            bad, patches[j] = self._damaged_blocks(w, ck, li[lo:hi], bi[lo:hi], flip)
            det[j, li[lo:hi], bi[lo:hi]] = bad
        return det, patches

    def _damaged_blocks(self, w: torch.Tensor, ck: torch.Tensor, li: torch.Tensor,
                        bi: torch.Tensor, flip):
        """The C corrupt blocks (layer ``li``, block ``bi``) of one stacked
        payload ``w`` (L, N, D), damaged by ``CorruptionModel.
        corrupt_payload`` (``flip`` = each block's (element, bit) draws, or
        None for zeroed blocks), checksummed and compared with the stored
        words ``ck`` (L, N/8). Returns (detected (C,) bool, the damaged rows
        (row indices into the stack's (L·N, D) view, values) — the flip's
        one row a block, or the zeroed block's eight)."""
        n_rows, d = w.shape[-2], w.shape[-1]
        rows = (li * n_rows + bi * KERNEL_BLOCK_ROWS)[:, None] + torch.arange(
            KERNEL_BLOCK_ROWS, device=w.device)
        blocks = w.reshape(-1, d).index_select(0, rows.reshape(-1))  # (C·8, D)
        every = torch.ones(bi.shape, dtype=torch.bool, device=w.device)
        damaged = self.corruption.corrupt_payload(blocks, every, *(flip or (None, None)),
                                                  KERNEL_BLOCK_ROWS)
        if flip is None:
            patch = (rows.reshape(-1), damaged)
        else:
            at = torch.arange(bi.shape[0], device=w.device) * KERNEL_BLOCK_ROWS + flip[0] // d
            patch = (rows.reshape(-1)[at], damaged[at])
        stored = ck.reshape(-1)[li * ck.shape[-1] + bi].to(torch.int64) & 0xFFFFFFFF
        damaged = damaged.reshape(-1, KERNEL_BLOCK_ROWS, d)
        return checksum_words(damaged) != stored, patch

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

    def plan_shard_bytes(self, plan) -> torch.Tensor:
        """Per-model-shard transfer bytes accumulated in a decode plan,
        (n_shards,) f32: the row-sharded sites' ``miss_shard`` rows × their
        row bytes, the other sites' bytes split evenly. Sums to
        ``plan_transfer_bytes`` up to f32 round-off."""
        dev = self.torch_device
        out = torch.zeros((self.n_shards,), dtype=torch.float32, device=dev)
        if not plan:
            return out
        if not self.mesh.is_sharded:
            return out + plan_transfer_bytes(plan, dev)
        for kind, state in plan.items():
            if "miss_shard" in state:
                rb = torch.tensor(self.site_row_bytes(kind), dtype=torch.float32, device=dev)
                out = out + state["miss_shard"].reshape(-1, self.n_shards).sum(dim=0) * rb
            else:
                out = out + state["bytes"].sum() / self.n_shards
        return out

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
        path. A degradable plan adds ``bscale`` (L,) = 1; integrity adds
        ``lid``/``epoch`` (L,) (the draws' layer and refresh epoch) and the
        ``INTEGRITY_COUNTER_KEYS`` (L,) accumulators, and with recovery off
        the drawn corrupt blocks ``cblk`` (L, matrices, N/8) and their
        damaged rows ``cpatch`` (one entry per matrix)."""
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
            ns = self.row_shards[kind]
            if self.shard_lanes[kind]:
                # per-model-shard hit/miss row counters: summed over the
                # shards they equal the hit/miss lanes
                plan[kind]["hit_shard"] = torch.zeros((n_layers, ns), dtype=torch.float32,
                                                      device=dev)
                plan[kind]["miss_shard"] = torch.zeros((n_layers, ns), dtype=torch.float32,
                                                       device=dev)
            if self.cache_enabled:
                score = torch.zeros((n_layers, site.n), dtype=torch.float32, device=dev)
                if kind in self.pinned_sel:
                    score = torch.where(self.pinned_sel[kind], PIN_SCORE, score)
                plan[kind]["score"] = score
            if self.degradable:
                plan[kind]["bscale"] = torch.ones((n_layers,), dtype=torch.float32, device=dev)
            if self.integrity_enabled:
                plan[kind]["lid"] = torch.arange(n_layers, dtype=torch.int32, device=dev)
                plan[kind]["epoch"] = torch.zeros((n_layers,), dtype=torch.int32, device=dev)
                for key in INTEGRITY_COUNTER_KEYS:
                    plan[kind][key] = torch.zeros((n_layers,), dtype=torch.float32, device=dev)
            if self.integrity_corrupting:
                n_mat = self.site_matrix_count(kind)
                plan[kind]["cblk"] = torch.zeros((n_layers, n_mat, site.n // KERNEL_BLOCK_ROWS),
                                                 dtype=torch.bool, device=dev)
                plan[kind]["cpatch"] = [None] * n_mat
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
