"""Utility-guided chunk selection — the paper's Algorithm 1 (§3.2, App. E).

Given importances V ∈ R^N, a row budget R, a chunk-size schedule and a
latency table T[·], select a mask maximizing Σ V_i M_i / Latency(M):
candidate windows of each size at stride min(r, jump_cap), utility =
window benefit / T[r], then a greedy pass over candidates by descending
utility taking non-overlapping windows that fit the remaining budget.

  * ``select_chunks_np`` — the literal numpy transcription (test oracle),
    identical to the reference's.
  * ``ChunkSelector.select`` — one site, as a one-lane batched problem.
  * ``BatchedChunkSelector`` — a layer's sites as one padded problem, or
    every layer's at once (one lane per layer and site). Scoring and the
    stable sort are torch; the sequential greedy walk is kernel K5
    (``greedy_select``), because as a loop of torch ops it would sync with
    the host once per candidate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .contiguity import resident_rows_in_windows, runs_to_padded_table_np
from .latency_model import KB, DeviceProfile, LatencyTable, profile_table


@dataclasses.dataclass(frozen=True)
class ChunkConfig:
    """Hyperparameters of Algorithm 1, in KB like the paper (App. H)."""

    min_chunk_kb: float = 8.0
    max_chunk_kb: float = 236.0
    step_kb: float = 8.0
    jump_cap_kb: float = 8.0

    def row_sizes(self, row_bytes: float) -> List[int]:
        row_kb = row_bytes / KB
        r_min = max(1, int(self.min_chunk_kb / row_kb))
        r_max = max(1, int(self.max_chunk_kb / row_kb))
        dr = max(1, int(self.step_kb / row_kb))
        sizes = list(range(r_min, r_max + 1, dr))
        return sizes if sizes else [r_min]

    def jump_cap_rows(self, row_bytes: float) -> int:
        return max(1, int(self.jump_cap_kb / (row_bytes / KB)))

    @staticmethod
    def for_shape(rows: int, cols: int, device: str = "nano") -> "ChunkConfig":
        """The reference's Table-2 heuristic: bigger matrices → coarser start
        size / jump cap; the max size is the device's saturation point
        (AGX 348 KB, Nano 236 KB)."""
        max_kb = 348.0 if device in ("agx", "jetson_agx_990pro") else 236.0
        if rows >= 16384:
            start = 32.0
        elif rows >= 8192:
            start = 16.0
        elif rows >= 3584:
            start = 20.0 if cols >= 3584 else 8.0
        else:
            start = 8.0
        return ChunkConfig(
            min_chunk_kb=start, max_chunk_kb=max_kb, step_kb=start, jump_cap_kb=start
        )


def _candidate_schedule(n: int, row_bytes: float, cfg: ChunkConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Static candidate (start, size) arrays for a length-n neuron axis."""
    starts: List[int] = []
    sizes: List[int] = []
    cap = cfg.jump_cap_rows(row_bytes)
    for r in cfg.row_sizes(row_bytes):
        if r > n:
            continue
        stride = min(r, cap)
        for i in range(0, n - r + 1, stride):
            starts.append(i)
            sizes.append(r)
    if not starts:
        starts, sizes = [0], [min(n, max(1, cfg.row_sizes(row_bytes)[0]))]
    return np.asarray(starts, np.int32), np.asarray(sizes, np.int32)


def select_chunks_np(v: np.ndarray, budget: int, row_bytes: float,
                     table: LatencyTable, cfg: ChunkConfig,
                     resident: Optional[np.ndarray] = None) -> np.ndarray:
    """Literal Algorithm 1 (numpy, float32 like the reference's oracle).
    Returns a bool mask of shape (N,). ``resident`` (bool (N,)): rows
    already in the DRAM residency tier; a window then costs only its
    non-resident rows (the marginal I/O cost)."""
    v = np.asarray(v, np.float32)
    n = v.shape[0]
    cumsum = np.concatenate([[0.0], np.cumsum(v, dtype=np.float32)])
    starts, sizes = _candidate_schedule(n, row_bytes, cfg)
    benefit = cumsum[starts + sizes] - cumsum[starts]
    cost_rows = sizes.astype(np.int64)
    if resident is not None:
        rcum = np.concatenate([[0], np.cumsum(np.asarray(resident, bool), dtype=np.int64)])
        cost_rows = cost_rows - (rcum[starts + sizes] - rcum[starts])
    cost = table.lookup(torch.from_numpy(cost_rows)).cpu().numpy()
    score = benefit / np.maximum(cost, 1e-30)
    order = np.argsort(-score, kind="stable")

    mask = np.zeros(n, bool)
    selected = 0
    for k in order:
        i, r = int(starts[k]), int(sizes[k])
        if r > budget - selected or mask[i: i + r].any():
            continue
        mask[i: i + r] = True
        selected += r
        if selected >= budget:
            break
    return mask


@dataclasses.dataclass(frozen=True, eq=False)
class ChunkSelector:
    """One site's static selection problem: candidate schedule + latency
    table for a fixed (N, device, chunk-config) triple. ``select(v,
    budget)`` runs it as a one-lane ``BatchedChunkSelector``, so the greedy
    walk is K5 on the card and its plain version on the CPU."""

    n: int
    row_bytes: float
    table: LatencyTable
    cfg: ChunkConfig
    starts: np.ndarray  # (K,) int32
    sizes: np.ndarray  # (K,) int32
    max_size: int
    min_size: int
    # torch device → (one-lane BatchedChunkSelector, LatencyTable) there
    _lanes: Dict[str, tuple] = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def build(n: int, row_bytes: float, device: str | DeviceProfile = "nano",
              cfg: ChunkConfig | None = None,
              table: LatencyTable | None = None) -> "ChunkSelector":
        name = device if isinstance(device, str) else device.name
        cfg = cfg or ChunkConfig.for_shape(n, 1, name)
        starts, sizes = _candidate_schedule(n, row_bytes, cfg)
        if table is None:
            # the host-side table (the oracle's and the batched cost rows');
            # ``lane`` copies it to the device a selection runs on
            table = profile_table(device, row_bytes, max_rows=int(sizes.max()),
                                  torch_device="cpu")
        return ChunkSelector(n=n, row_bytes=row_bytes, table=table, cfg=cfg,
                             starts=starts, sizes=sizes,
                             max_size=int(sizes.max()), min_size=int(sizes.min()))

    @property
    def num_candidates(self) -> int:
        return int(self.starts.shape[0])

    def lane(self, device) -> Tuple["BatchedChunkSelector", LatencyTable]:
        """This selector as a one-lane ``BatchedChunkSelector``, and its
        latency table, on ``device`` (built once per device)."""
        key = str(torch.device(device))
        if key not in self._lanes:
            table = LatencyTable(self.table.device, self.table.row_bytes,
                                 self.table.table.to(device))
            self._lanes[key] = (BatchedChunkSelector.build([self], device=device), table)
        return self._lanes[key]

    def select(self, v: torch.Tensor, budget, resident=None):
        """Returns (mask bool (N,), n_selected int32, est_latency_s f32) on
        ``v``'s device: Algorithm 1 at a row budget, as the reference's
        ``ChunkSelector.select``. ``resident`` (bool (N,)): rows in the DRAM
        residency tier — the selection is then marginal-cost aware and the
        estimate charges only the final mask's miss rows."""
        batched, table = self.lane(v.device)
        budgets = torch.as_tensor(budget).to(device=v.device, dtype=torch.int32).reshape(1)
        res = None if resident is None else resident.to(v.device).reshape(1, self.n)
        masks, selected = batched.select(v.reshape(1, self.n), budgets, resident=res)
        if resident is None:
            return masks[0], selected[0], table.mask_latency(masks[0])
        return masks[0], selected[0], table.mask_latency_miss(masks[0], res[0])

    def select_for_sparsity(self, v: torch.Tensor, sparsity: float):
        """``select`` at budget = round((1 - sparsity) * N) rows."""
        return self.select(v, round((1.0 - float(sparsity)) * self.n))


# ---------------------------------------------------------------------------
# K5: the greedy walk (replaces BatchedChunkSelector._greedy_lane,
# repro/core/chunking.py:362 — a lax.while_loop, vmapped over sites)
# ---------------------------------------------------------------------------
#
# Kernel: kernels/csrc/greedy_select.cu (not a TPU kernel — the reference's
# walk is a while_loop, but on this path it is the one sequential step).
# Bound on the H100: neither bytes nor FLOPs — a dependent chain of overlap
# tests, and one warp per lane issues one instruction a cycle at best, so
# the work per candidate walked. Design: one launch per refresh step over
# every lane of every layer (one warp each, side by side on the SMs); the
# selection as "the first selected row at or after row i" in shared memory,
# so testing a window is one load and one compare; candidates staged by
# cp.async and taken 32 at a time, each lane testing its own against the
# selection, and the rare survivors of that test taken one by one in
# candidate order. The walk exits
# as soon as the remaining budget cannot fit the lane's smallest candidate.
# A single walk to K with that exit selects exactly what the reference's two
# segments (top-C, then the rest) select.

LAUNCHES = {"greedy_select": 0}


def greedy_select_plain(starts_s: torch.Tensor, sizes_s: torch.Tensor,
                        budgets: torch.Tensor, min_sizes: torch.Tensor,
                        n_max: int, walked: Optional[List[int]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: the reference's ``_greedy_lane`` walk, one lane
    at a time on the host. Returns (masks (S, n_max) bool, selected (S,)
    int32) on the inputs' device; ``walked``, when given, receives each
    lane's number of candidates visited before the early exit."""
    st = starts_s.cpu().tolist()
    sz = sizes_s.cpu().tolist()
    bud = budgets.cpu().tolist()
    mins = min_sizes.cpu().tolist()
    masks = torch.zeros((len(st), n_max), dtype=torch.bool)
    selected = torch.zeros((len(st),), dtype=torch.int32)
    for lane, (starts, sizes, budget, min_size) in enumerate(zip(st, sz, bud, mins)):
        m = bytearray(n_max)
        sel = 0
        visited = 0
        for start, size in zip(starts, sizes):
            if sel + min_size > budget:
                break
            visited += 1
            if size <= 0 or size > budget - sel or start < 0 or start + size > n_max:
                continue
            if 1 in m[start: start + size]:
                continue
            m[start: start + size] = b"\x01" * size
            sel += size
        masks[lane] = torch.frombuffer(m, dtype=torch.uint8).to(torch.bool)
        selected[lane] = sel
        if walked is not None:
            walked.append(visited)
    return masks.to(starts_s.device), selected.to(starts_s.device)


def greedy_select(starts_s: torch.Tensor, sizes_s: torch.Tensor,
                  budgets: torch.Tensor, min_sizes: torch.Tensor,
                  n_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 wrapper. ``starts_s``/``sizes_s``: (S, K) int32 candidates in
    descending-utility order (size 0 = padding); ``budgets``/``min_sizes``:
    (S,) int32. Returns (masks (S, n_max) bool, selected (S,) int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if starts_s.device.type == "cpu":
        return greedy_select_plain(starts_s, sizes_s, budgets, min_sizes, n_max)
    if starts_s.device.type != "cuda":
        raise ValueError(f"greedy_select: unsupported device {starts_s.device}")
    from ..kernels.build import check, library, stream_ptr

    s, k = starts_s.shape
    args = [t.contiguous() for t in (starts_s, sizes_s, budgets, min_sizes)]
    for t in args:
        if t.dtype != torch.int32 or t.device != starts_s.device:
            raise ValueError("greedy_select: int32 tensors on one device expected")
    if sizes_s.shape != (s, k) or budgets.shape != (s,) or min_sizes.shape != (s,):
        raise ValueError("greedy_select: shapes (S, K), (S, K), (S,), (S,) expected")
    masks = torch.empty((s, n_max), dtype=torch.bool, device=starts_s.device)
    selected = torch.empty((s,), dtype=torch.int32, device=starts_s.device)
    rc = library("greedy_select.cu").k5_greedy_select(
        *(t.data_ptr() for t in args), k, n_max, masks.data_ptr(),
        selected.data_ptr(), s, stream_ptr(starts_s.device),
    )
    check(rc, "k5_greedy_select")
    LAUNCHES["greedy_select"] += 1
    return masks, selected


@dataclasses.dataclass(frozen=True, eq=False)
class BatchedChunkSelector:
    """All of a layer's sparsification sites as ONE padded selection
    problem: per site identical to ``select_chunks_np`` (same utility, same
    stable tie-breaking, same budget rule). ``select`` also takes every
    layer's sites at once — (L·S) lanes, the (S, K) candidate arrays
    broadcast over the layers — for one scoring pass, one stable sort and
    one K5 launch per refresh step."""

    n_sites: int
    n_max: int
    starts: torch.Tensor  # (S, K) int64, zero-padded
    sizes: torch.Tensor  # (S, K) int64, zero-padded
    valid: torch.Tensor  # (S, K) bool
    row_valid: torch.Tensor  # (S, n_max) bool
    tables: torch.Tensor  # (S, T+1) float32 per-lane latency tables
    min_sizes: torch.Tensor  # (S,) int32
    site_ns: Tuple[int, ...]

    @staticmethod
    def build(selectors: Sequence[ChunkSelector], device=None) -> "BatchedChunkSelector":
        """The selectors as one padded problem on ``device`` (default
        ``cuda``; no card raises)."""
        device = resolve_device(device)
        sels = list(selectors)
        if not sels:
            raise ValueError("need at least one ChunkSelector to batch")
        n_sites = len(sels)
        n_max = max(s.n for s in sels)
        # K padded to a multiple of 4: K5 stages four candidates a copy
        k_max = -(-max(s.num_candidates for s in sels) // 4) * 4
        t_max = max(max(s.table.max_rows, s.max_size) for s in sels)
        starts = np.zeros((n_sites, k_max), np.int64)
        sizes = np.zeros((n_sites, k_max), np.int64)
        valid = np.zeros((n_sites, k_max), bool)
        row_valid = np.zeros((n_sites, n_max), bool)
        tables = np.zeros((n_sites, t_max + 1), np.float32)
        for i, s in enumerate(sels):
            k = s.num_candidates
            starts[i, :k] = s.starts
            sizes[i, :k] = s.sizes
            valid[i, :k] = True
            row_valid[i, : s.n] = True
            tables[i] = s.table.padded_table(t_max)
        min_sizes = np.array([int(s.sizes.min()) for s in sels], np.int32)

        def dev(a):
            return torch.from_numpy(a).to(device)

        return BatchedChunkSelector(
            n_sites=n_sites, n_max=n_max, starts=dev(starts), sizes=dev(sizes),
            valid=dev(valid), row_valid=dev(row_valid), tables=dev(tables),
            min_sizes=dev(min_sizes), site_ns=tuple(s.n for s in sels),
        )

    def select(self, v: torch.Tensor, budgets: torch.Tensor,
               min_sizes: Optional[torch.Tensor] = None,
               resident: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """v: (L·n_sites, n_max) padded importances, layer-major (L = 1 for
        one layer); budgets: (L·n_sites,) int32; min_sizes: the lanes'
        smallest candidates, (L·n_sites,) int32 (``min_sizes`` repeated L
        times if not given); resident: optional (L·n_sites, n_max) bool
        DRAM-resident rows (marginal-cost selection, as in
        ``ChunkSelector.select``). Returns (masks (L·n_sites, n_max) bool,
        selected (L·n_sites,) int32) from one K5 launch."""
        lanes = v.shape[0]
        if v.ndim != 2 or lanes % self.n_sites or v.shape[1] != self.n_max:
            raise ValueError(f"v must be (L * {self.n_sites}, {self.n_max}), "
                             f"got {tuple(v.shape)}")
        n_layers = lanes // self.n_sites
        if min_sizes is None:
            min_sizes = self.min_sizes.repeat(n_layers)
        shape = (n_layers, self.n_sites, self.n_max)
        starts_s, sizes_s = self.sorted_candidates(
            v.reshape(shape), None if resident is None else resident.reshape(shape))
        masks, selected = greedy_select(starts_s.reshape(lanes, -1), sizes_s.reshape(lanes, -1),
                                        budgets.to(torch.int32), min_sizes, self.n_max)
        masks = (masks.reshape(n_layers, self.n_sites, self.n_max) & self.row_valid)
        return masks.reshape(lanes, self.n_max), selected

    def sorted_candidates(self, v: torch.Tensor, resident: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every lane's candidates in descending-utility order, ties by
        candidate index: v (..., n_sites, n_max) → (starts, sizes), each
        (..., n_sites, K) int32, size 0 = padding — K5's input. The (S, K)
        candidate arrays broadcast over the leading axes (views, no copies).
        ``resident`` (bool, v's shape): each window then costs its
        non-resident rows only, ``cost_rows = sizes - in_win``, before the
        stable sort — K5 walks the resident-aware order unchanged.

        The window benefits come from a prefix sum accumulated in float64
        and rounded once to float32, so the CPU and the card agree whenever
        the float64 sums are exact (always for the dyadic importances the
        parity tests use)."""
        v = v.to(torch.float32) * self.row_valid
        csum = torch.cumsum(v, dim=-1, dtype=torch.float64).to(torch.float32)
        cumsum = torch.nn.functional.pad(csum, (1, 0))
        shape = cumsum.shape[:-1] + self.starts.shape[-1:]
        starts = self.starts.expand(shape)
        benefit = cumsum.gather(-1, (self.starts + self.sizes).expand(shape)) \
            - cumsum.gather(-1, starts)
        cost_rows = self.sizes
        if resident is not None:
            in_win = resident_rows_in_windows(self.starts, self.sizes,
                                              resident.to(torch.bool) & self.row_valid)
            cost_rows = cost_rows - in_win
        cost_rows = cost_rows.clamp(0, self.tables.shape[1] - 1)
        tables = self.tables.expand(cost_rows.shape[:-1] + self.tables.shape[-1:])
        cost = tables.gather(-1, cost_rows).clamp_min(1e-30)
        score = torch.where(self.valid, benefit / cost, torch.full_like(benefit, -float("inf")))
        order = torch.argsort(-score, dim=-1, stable=True)
        starts_s = starts.gather(-1, order).to(torch.int32)
        sizes_s = torch.where(self.valid.expand(shape).gather(-1, order),
                              self.sizes.expand(shape).gather(-1, order),
                              torch.zeros_like(order)).to(torch.int32)
        return starts_s, sizes_s


def chunk_table_from_mask(mask, max_chunks: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Selection mask → (starts, sizes, n) padded chunk table of its runs."""
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return runs_to_padded_table_np(np.asarray(mask), max_chunks)
