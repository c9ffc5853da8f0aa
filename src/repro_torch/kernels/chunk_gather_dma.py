"""Chunk-gather kernels K1 and K2 for the H100, their plain PyTorch versions,
and the mask → block-table bridge.

Both consume block-aligned chunk tables: (starts, sizes) in rows, multiples
of ``block_rows`` = 8, size 0 = padding, at most ``max_chunk_rows`` rows
of a chunk visited. A table step is one (chunk, 8-row block); padded
entries and blocks past a chunk's size issue no load, and a block outside
[0, N) is skipped the same way.

Exact arithmetic, shared by every kernel and every plain version here and
by the reference backend's twin (``backend.blocked_masked_matmul``): per
visited 8-row block, ``part`` is the sequential sum over the block's rows of
``x·w`` with each product rounded on its own; ``acc += part`` in table
order. With int8 weights each element is ``q.float() * scale`` before the
product. The CUDA sources spell these steps out with ``__fmul_rn`` /
``__fadd_rn`` and build with ``-fmad=false``, so kernel and plain version
agree bitwise on the same device.

K1 — ``chunk_gather_matmul_dma`` (csrc/chunk_gather.cuh, ``k1_kernel``)
  Replaces ``repro/kernels/chunk_gather_dma.py::chunk_gather_matmul_dma``
  (body ``_matmul_dma_kernel``, schedule ``_pipelined_steps``). Bound on the
  H100: bytes — a decode GEMV at batch ≤ 8 does 2·B flops per weight
  element loaded, far below the ~295 flops/byte ridge. What bounded its
  first form was a serial chain inside each CTA: a table walk, the
  copy issue and an 8-deep partial sum per 8-row block, on 4 warps and as
  few as 4 CTAs. Design now (``k1_body``): each CTA turns the table into a
  flat block list once (per-entry counts, a block-wide scan;
  ``k1_block_list`` is its mirror); the grid runs over tiles of one 32-byte
  sector of each weight row (16 bf16 columns; 16 bytes where that would fill
  under half the SMs) × slabs of 8 batch rows (``k1_geometry``), so even
  k/v's 256 columns spread over 32 SMs and every copy fills a sector; the
  CTA's x rows are held whole in shared memory; most of 16 warps form a
  stage's exact block partials at once (two columns a lane) while the next
  ``prefetch_depth`` stages of 16-byte ``cp.async`` copies land; the last
  warps own the outputs, one thread each, and add the partials in table
  order, the only serial chain left. Only selected rows are read.
  The contraction stays on the CUDA cores in fp32: a tensor-core
  (``wgmma``) path would reassociate the sums, and at this batch the FLOPs
  are not the bound.

K2 — ``chunk_gather_mlp_dma`` (csrc/chunk_gather.cuh, ``k2_gate_up_kernel``
  then ``k1_kernel``) Replaces
  ``repro/kernels/chunk_gather_dma.py::chunk_gather_mlp_dma`` (body
  ``_mlp_dma_kernel``). Bound: bytes, as K1. On the TPU it is one program
  because phase 2 needs all of h. Here it is two launches behind one
  wrapper, both on K1's body: phase 1 runs it over two weight streams that
  share the hidden lane's table (each ring stage carries a block's W_gate
  tile and its W_up tile; the forming warps write both streams' exact
  partials; the owners keep two accumulators) and writes
  h = (g · 1/(1+e^−g)) · u with ``expf`` and an IEEE reciprocal (geometry
  ``k1_geometry(..., nmat=2)``: F = 5632 in bf16 gives 352 CTAs of 16
  columns); phase 2 is K1 over the ffn lane with h multiplied by the exact
  ``ffn_mask`` at the gather. The decode path asks for h anyway
  (``return_h``), so h leaving the chip adds no traffic there.

The checksum lanes (K1's ``checksums``, K2's (cg, cu, cd)): one 32-bit word
per 8-row block of each stream, int32 holding the reference's uint32 bits.
With a lane the body is built with its ``CK`` flag, into a library of its
own (csrc/chunk_gather_ck.cu): every ring stage also fetches its blocks'
words (one 4-byte ``cp.async`` per block and stream), beside the scales,
and waits on them with the stage, as the reference's kernels fetch and wait
on theirs; neither verifies them (the refresh does,
``serving/sparse_exec.py``), so the output is bit-identical with and
without the lane. K2's phase 1 carries cg and cu, its phase 2 cd. The plain
versions take the lanes and ignore them.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

BLOCK_ROWS = 8
# the CUDA ring is compiled for 1..4 stages; deeper requests run at 3
MAX_PREFETCH_DEPTH = 3
# a block's opt-in shared-memory limit on Hopper (232,448 bytes), less 64
# for the kernels' static shared words (scan sums, stage mbarriers)
SMEM_LIMIT_BYTES = 232448 - 64
# batch rows per CTA (kBatchSlab in csrc/chunk_gather.cuh)
_BATCH_SLAB = 8
# the body of K1-K4: 16 warps a CTA, a window of the flat block list of up
# to K1_WINDOW_BLOCKS entries, the CTA's x rows held whole up to
# K1_SLAB_BYTES (kK1Threads, kK1WindowBlocks, kK1SlabBytes); column tiles of
# one 32-byte sector of a weight row, or half of one; ring stages of up to
# K1_STAGE_BYTES per weight stream, the ring and the partial buffers within
# what K1_SMEM_BYTES leaves beside the x slab, the window and a full-width
# table
K1_WARPS, K1_WINDOW_BLOCKS, K1_SLAB_BYTES, K1_SECTOR_BYTES = 16, 1024, 80 * 1024, 32
K1_STAGE_BYTES, K1_SMEM_BYTES = 32 * 1024, 190 * 1024

LAUNCHES = {"chunk_gather_matmul_dma": 0, "chunk_gather_mlp_dma": 0}
# the launches of LAUNCHES that carried their checksum lanes
LANE_LAUNCHES = {"chunk_gather_matmul_dma": 0, "chunk_gather_mlp_dma": 0}

_WTYPE = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


# ---------------------------------------------------------------------------
# mask → block-aligned chunk table (no host sync)
# ---------------------------------------------------------------------------


def masks_to_block_tables(masks: torch.Tensor, block_rows: int = 8,
                          max_chunk_rows: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, N) bool selection masks → padded kernel chunk tables.

    Each mask is rounded outward to the ``block_rows`` grid (a selected row
    claims its whole block), then maximal block runs are split at
    ``max_chunk_rows``. Returns (starts, sizes), each (S, K) int32 with
    K = ceil(N / block_rows), in rows, size 0 = padding — the reference's
    ``masks_to_block_tables`` in torch (cummax, cumsum, scatter)."""
    if masks.ndim != 2:
        raise ValueError(f"masks must be (n_sites, N), got {tuple(masks.shape)}")
    if max_chunk_rows % block_rows:
        raise ValueError("max_chunk_rows must be a multiple of block_rows")
    s, n = masks.shape
    nb = -(-n // block_rows)
    m = torch.nn.functional.pad(masks.to(torch.bool), (0, nb * block_rows - n))
    bm = m.reshape(s, nb, block_rows).any(dim=2)
    idx = torch.arange(nb, device=masks.device).repeat(s, 1)
    prev = torch.nn.functional.pad(bm[:, :-1], (1, 0))
    run_start = bm & ~prev
    start_idx = torch.cummax(torch.where(run_start, idx, torch.full_like(idx, -1)), dim=1).values
    chunk_start = bm & ((idx - start_idx) % (max_chunk_rows // block_rows) == 0)
    cid = torch.cumsum(chunk_start.to(torch.int64), dim=1) - 1
    dump = torch.where(bm, cid, torch.full_like(cid, nb))
    sizes_b = torch.zeros((s, nb + 1), dtype=torch.int64, device=masks.device)
    sizes_b.scatter_add_(1, dump, bm.to(torch.int64))
    starts_b = torch.zeros((s, nb + 1), dtype=torch.int64, device=masks.device)
    starts_b.scatter_reduce_(1, torch.where(chunk_start, cid, torch.full_like(cid, nb)),
                             idx, reduce="amax")
    return ((starts_b[:, :nb] * block_rows).to(torch.int32),
            (sizes_b[:, :nb] * block_rows).to(torch.int32))


# ---------------------------------------------------------------------------
# the exact arithmetic, in plain PyTorch
# ---------------------------------------------------------------------------


def block_parts(xb: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Per-block partial products: xb (nb, B, 8) f32, wb (nb, 8, D) f32 →
    (nb, B, D), each the sequential sum over the block's 8 rows of x·w with
    every product rounded on its own (separate mul and add ops — no FMA)."""
    part = xb[:, :, 0, None] * wb[:, 0, None, :]
    for r in range(1, xb.shape[2]):
        part = part + xb[:, :, r, None] * wb[:, r, None, :]
    return part


def swiglu_h(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h = (g · 1/(1+e^−g)) · u — the literal sigmoid of the reference
    kernel (its numerically-stable library form rounds differently)."""
    return g * torch.reciprocal(1.0 + torch.exp(-g)) * u


def _table_blocks(starts: torch.Tensor, sizes: torch.Tensor, n_rows: int,
                  max_chunk_rows: int) -> List[int]:
    """Row offsets of a table's active (chunk, block) steps, in table order
    (host list: the plain versions' walk)."""
    bpc = max_chunk_rows // BLOCK_ROWS
    offs = []
    for start, size in zip(starts.tolist(), sizes.tolist()):
        for bk in range(min(-(-size // BLOCK_ROWS), bpc) if size > 0 else 0):
            off = start + bk * BLOCK_ROWS
            if 0 <= off and off + BLOCK_ROWS <= n_rows:
                offs.append(off)
    return offs


def _gather_contract(w: torch.Tensor, x: torch.Tensor, offs: List[int],
                     scales: Optional[torch.Tensor]) -> torch.Tensor:
    """y (B, D) f32 = Σ over the listed 8-row blocks, in order, of the
    block's exact partial product."""
    y = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    if not offs:
        return y
    rows = torch.tensor(offs, device=x.device)[:, None] + torch.arange(BLOCK_ROWS, device=x.device)
    wb = w[rows].to(torch.float32)
    if scales is not None:
        wb = wb * scales.to(torch.float32)[rows[:, 0] // BLOCK_ROWS][:, None, None]
    parts = block_parts(x[:, rows].permute(1, 0, 2), wb)
    for k in range(parts.shape[0]):
        y = y + parts[k]
    return y


def chunk_gather_matmul_plain(w, x, starts, sizes, scales=None, x_mask=None,
                              max_chunk_rows: int = 512, checksums=None) -> torch.Tensor:
    """Plain version of K1 (of K2's phase 2 with ``x_mask``, and of K3 with
    neither ``scales`` nor ``x_mask``); the checksum lane carries no
    arithmetic and is ignored."""
    x = x.to(torch.float32)
    if x_mask is not None:
        x = x * x_mask.to(torch.float32)[None, :]
    return _gather_contract(w, x, _table_blocks(starts, sizes, w.shape[0], max_chunk_rows),
                            scales)


def chunk_gather_swiglu_plain(w_gate, w_up, x, starts, sizes, scales=None,
                              max_chunk_rows: int = 512) -> torch.Tensor:
    """Plain version of K4 (and of K2's phase 1, with ``scales`` = (sg, su)):
    h (B, F) f32 = ``swiglu_h`` of two exact gathers off one table."""
    sg, su = scales if scales is not None else (None, None)
    x = x.to(torch.float32)
    offs = _table_blocks(starts, sizes, w_gate.shape[0], max_chunk_rows)
    return swiglu_h(_gather_contract(w_gate, x, offs, sg), _gather_contract(w_up, x, offs, su))


def chunk_gather_mlp_plain(w_gate, w_up, w_down, x, starts, sizes, ffn_mask=None,
                           scales=None, max_chunk_rows: int = 512, checksums=None):
    """Plain version of K2: returns (y (B, D) f32, unmasked h (B, F) f32);
    the checksum lanes are ignored."""
    sd = scales[2] if scales is not None else None
    h = chunk_gather_swiglu_plain(w_gate, w_up, x, starts[0], sizes[0],
                                  None if scales is None else scales[:2], max_chunk_rows)
    y = chunk_gather_matmul_plain(w_down, h, starts[1], sizes[1], sd, ffn_mask, max_chunk_rows)
    return y, h


# ---------------------------------------------------------------------------
# wrappers: CPU tensors → plain version; CUDA tensors → the kernel or raise
# ---------------------------------------------------------------------------


def _check_common(block_rows: int, max_chunk_rows: int, prefetch_depth: int) -> None:
    if block_rows != BLOCK_ROWS:
        raise ValueError(f"block_rows must be {BLOCK_ROWS}, got {block_rows}")
    if max_chunk_rows % BLOCK_ROWS or max_chunk_rows <= 0:
        raise ValueError("max_chunk_rows must be a positive multiple of block_rows")
    if prefetch_depth < 0:
        raise ValueError(f"prefetch_depth must be >= 0, got {prefetch_depth}")


def ring_depth(prefetch_depth: int) -> int:
    """The depth the CUDA ring runs at for a requested ``prefetch_depth``:
    ``min(depth, MAX_PREFETCH_DEPTH)``. A CTA also never has more stages in
    flight than it has stages, so the ring runs at ``min(depth,
    MAX_PREFETCH_DEPTH, steps)``; the sums do not depend on the depth."""
    return min(prefetch_depth, MAX_PREFETCH_DEPTH)


def _same_device(device: torch.device, *tensors) -> None:
    for t in tensors:
        if t is not None and t.device != device:
            raise ValueError(f"all operands must be on {device}, got one on {t.device}")


def _check_dtype(w: torch.Tensor, scales, name: str) -> None:
    if w.dtype not in _WTYPE:
        raise ValueError(f"{name}: dtype {w.dtype} not supported (bf16, f32, int8)")
    if (w.dtype == torch.int8) != (scales is not None):
        raise ValueError(f"{name}: int8 payloads take per-block scales, other dtypes none")


def _check_checksums(ck: torch.Tensor, rows: int, name: str) -> None:
    """A checksum lane: one int32 word per 8-row block of ``rows`` rows."""
    if ck.shape != (rows // BLOCK_ROWS,):
        raise ValueError(f"{name} checksums must be ({rows // BLOCK_ROWS},), "
                         f"got {tuple(ck.shape)}")
    if ck.dtype != torch.int32:
        raise ValueError(f"{name} checksums must be int32 words, got {ck.dtype}")


def _check_layout(w: torch.Tensor, name: str) -> None:
    if not w.is_contiguous() or w.data_ptr() % 16 or (w.shape[1] * w.element_size()) % 16:
        raise ValueError(f"{name}: the kernel streams 16-byte row segments; needs a "
                         "contiguous, 16-byte aligned matrix whose rows are a "
                         "multiple of 16 bytes")


def _k1_xrec(batch: int, masked: bool, n: int) -> int:
    """f32 values of a block's input record: 0 when the CTA holds its x rows
    (and the mask) whole, else 8 per row (``K1Layout::xrec``)."""
    xrows = min(batch, _BATCH_SLAB) + int(masked)
    return 0 if xrows * n * 4 <= K1_SLAB_BYTES else xrows * BLOCK_ROWS


def k1_geometry(d: int, batch: int, elem_bytes: int, n_sm: int, prefetch_depth: int = 1,
                n: int = 0, masked: bool = False, nmat: int = 1, ck: bool = False) -> dict:
    """The K1 body's launch geometry for ``nmat`` weight streams W (n, d)
    sharing one table (1: K1, K3; 2: gate and up, K2's phase 1 and K4):
    ``tile`` output columns per CTA and ``blocks`` table blocks per ring
    stage; the grid is ``grid`` = (ceil(D / tile), ceil(B / 8)).

    A CTA's tile is one 32-byte sector of each weight row (16 bf16, 8 f32
    or 32 int8 columns): copies then fill whole sectors, and the CTAs of
    neighbouring tiles share the lines in L2. Where that leaves the grid
    under half the SMs (k/v's 256 columns), the tile halves to one 16-byte
    copy a row, for twice the CTAs. A stage (every stream's tiles of its
    blocks) holds the blocks that fit in ``K1_STAGE_BYTES`` per stream,
    and the ``prefetch_depth + 1`` stages with the two
    partial halves in what ``K1_SMEM_BYTES`` leaves beside the x slab, in
    whole rounds of the CTA's lane groups (16 warps x 32 / tile) where it
    holds one: few stages, so few serial stage latencies. Where not even
    one block per warp would fit (two streams of wide int8 tiles for 8
    rows), the tile halves too. ``ck``: the stages also carry each stream's
    checksum word per block (4 bytes a block and stream); without it the
    geometry is the one the body had before the lane."""
    slabs = -(-batch // _BATCH_SLAB)
    tile = K1_SECTOR_BYTES // elem_bytes
    if -(-d // tile) * slabs * 2 <= n_sm:
        tile //= 2
    xrec = _k1_xrec(batch, masked, n)
    slab = 0 if xrec else (min(batch, _BATCH_SLAB) + int(masked)) * n * 4

    def stage_blocks(tile):
        per_block = (nmat * (BLOCK_ROWS + 1) * tile * elem_bytes + xrec * 4
                     + 4 * (nmat + 1 + (nmat if ck else 0)))
        per_part = 2 * nmat * min(batch, _BATCH_SLAB) * tile * 4  # a block's partials
        room = K1_SMEM_BYTES - slab - 36 * per_part  # the partial rows' padding (_k1_pstride)
        return min(nmat * K1_STAGE_BYTES // per_block,
                   room // ((prefetch_depth + 1) * per_block + per_part))

    while stage_blocks(tile) < K1_WARPS and tile * elem_bytes > 16:
        tile //= 2
    lanes = K1_WARPS * (32 // tile)  # lane groups of a CTA: one block each
    blocks = max(K1_WARPS, stage_blocks(tile))
    if blocks >= lanes:
        blocks -= blocks % lanes
    return {"tile": tile, "blocks": blocks, "grid": (-(-d // tile), slabs)}


def k1_block_list(starts: torch.Tensor, sizes: torch.Tensor, n_rows: int,
                  max_chunk_rows: int) -> List[int]:
    """The K1 body's flat block list, as ``k1_scan_table`` builds it: per
    entry the blocks bk in [lo, hi) of its chunk that lie inside [0, N),
    their first offset, an exclusive prefix of the counts, then the scatter.
    Equal to the plain versions' walk (``_table_blocks``)."""
    bpc = max_chunk_rows // BLOCK_ROWS
    s = starts.to(torch.int64).cpu()
    z = sizes.to(torch.int64).cpu()
    nblk = torch.where(z > 0, torch.clamp((z + BLOCK_ROWS - 1) // BLOCK_ROWS, max=bpc), 0)
    lo = torch.where(s < 0, (-s + BLOCK_ROWS - 1) // BLOCK_ROWS, 0)
    room = n_rows - BLOCK_ROWS - s
    hi = torch.where(room < 0, 0, torch.minimum(nblk, room // BLOCK_ROWS + 1))
    count = torch.clamp(hi - lo, min=0)
    base = s + lo * BLOCK_ROWS
    pre = torch.cumsum(count, 0) - count
    out = [0] * int(count.sum())
    for e in range(s.shape[0]):
        for j in range(int(count[e])):
            out[int(pre[e]) + j] = int(base[e]) + j * BLOCK_ROWS
    return out


def _k1_pstride(blocks: int) -> int:
    """Floats per output row of the partial buffer (``K1Layout::pstride``):
    the blocks rounded up to 32, plus 4 (16-byte rows, 4 banks apart)."""
    return -(-blocks // 32) * 32 + 4


def k1_smem_bytes(k: int, elem_bytes: int, tile: int, blocks: int, batch: int,
                  prefetch_depth: int, n: int = 0, masked: bool = False, nmat: int = 1,
                  ck: bool = False) -> int:
    """Dynamic shared memory of one CTA of the body of K1-K4 for ``nmat``
    weight streams W (n, D) (``K1Layout`` in csrc/chunk_gather.cuh):
    ``prefetch_depth + 1`` ring stages of ``blocks`` blocks, each block per
    stream a weight tile padded by one row and a scale, an input record
    unless x is held whole, and a row offset (and per stream a checksum
    word, with ``ck``); then the partial buffer's two
    halves (per stream rows x tile outputs x ``_k1_pstride`` blocks), the x
    slab (the CTA's rows of x and the mask, when they fit in
    ``K1_SLAB_BYTES``), the block-list window, and 8 bytes a table entry
    plus 4 (first offsets and the exclusive prefix)."""
    rows = min(batch, _BATCH_SLAB)
    xrec = _k1_xrec(batch, masked, n)
    pad16 = -(-blocks * 4 // 16) * 16
    stage = (blocks * (nmat * (BLOCK_ROWS + 1) * tile * elem_bytes + xrec * 4)
             + (nmat + 1 + (nmat if ck else 0)) * pad16)
    slab = 0 if xrec else (rows + int(masked)) * n * 4
    window = blocks * max(1, K1_WINDOW_BLOCKS // blocks)
    return ((prefetch_depth + 1) * stage + 2 * nmat * rows * tile * _k1_pstride(blocks) * 4
            + slab + 4 * window + 8 * k + 4)


def check_table_fits(k: int, w: torch.Tensor, n_mat: int, prefetch_depth: int,
                     name: str, geometry: dict, batch: int, masked: bool,
                     ck: bool = False) -> None:
    """The kernels hold the whole chunk table in shared memory: a table too
    long for the card at ``geometry`` (``k1_smem_bytes`` over ``n_mat``
    weight streams shaped like ``w``) raises here, before any launch."""
    need = k1_smem_bytes(k, w.element_size(), geometry["tile"], geometry["blocks"], batch,
                         prefetch_depth, w.shape[0], masked, n_mat, ck)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"{name}: a chunk table of K={k} entries needs {need} bytes of "
                         f"shared memory with its ring, over the {SMEM_LIMIT_BYTES}-byte "
                         "limit; pass a shorter table (fewer, longer chunks)")


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Contiguous f32 with a 16-byte aligned start: the kernels stage input
    rows with 16-byte ``cp.async`` copies."""
    if t is None:
        return None
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def k1_launch_geometry(w: torch.Tensor, x: torch.Tensor, k: int, prefetch_depth: int,
                       masked: bool, name: str, nmat: int = 1, ck: bool = False) -> dict:
    """The K1 body's geometry for a call on the card over ``nmat`` weight
    streams shaped like ``w``, after the layout and shared-memory checks (a
    table too long raises here)."""
    from .build import sm_count

    _check_layout(w, name)
    g = k1_geometry(w.shape[1], x.shape[0], w.element_size(), sm_count(x.device),
                    prefetch_depth, w.shape[0], masked, nmat, ck)
    check_table_fits(k, w, nmat, prefetch_depth, name, g, x.shape[0], masked, ck)
    return g


def _launch_k1(w, x, starts, sizes, scales, x_mask, max_chunk_rows, prefetch_depth,
               checksums=None):
    from .build import check, library, stream_ptr

    prefetch_depth = ring_depth(prefetch_depth)
    g = k1_launch_geometry(w, x, starts.shape[0], prefetch_depth, x_mask is not None,
                           "chunk_gather_matmul_dma", ck=checksums is not None)
    b, n = x.shape
    d = w.shape[1]
    x, scales, x_mask = _f32(x), _f32(scales), _f32(x_mask)
    starts, sizes = _i32(starts), _i32(sizes)
    checksums = None if checksums is None else _i32(checksums)
    y = torch.empty((b, d), dtype=torch.float32, device=x.device)
    lib, name = (("chunk_gather.cu", "k1_chunk_gather_matmul") if checksums is None
                 else ("chunk_gather_ck.cu", "k1_chunk_gather_matmul_ck"))
    rc = getattr(library(lib), name)(
        w.data_ptr(), _WTYPE[w.dtype], x.data_ptr(), _ptr(x_mask), starts.data_ptr(),
        sizes.data_ptr(), _ptr(scales), _ptr(checksums), y.data_ptr(), b, n, d, starts.shape[0],
        max_chunk_rows // BLOCK_ROWS, prefetch_depth, g["tile"], g["blocks"],
        stream_ptr(x.device),
    )
    check(rc, name)
    return y


def _launch_k2_gate_up(w_gate, w_up, x, starts, sizes, sg, su, max_chunk_rows,
                       prefetch_depth, cg=None, cu=None):
    """K2's phase 1 on the card: h (B, F) f32 off one (K,) table; ``cg``/
    ``cu``: gate's and up's checksum lanes, both or neither."""
    from .build import check, library, stream_ptr

    prefetch_depth = ring_depth(prefetch_depth)
    _check_layout(w_up, "chunk_gather_mlp_dma (w_up)")
    g = k1_launch_geometry(w_gate, x, starts.shape[0], prefetch_depth, False,
                           "chunk_gather_mlp_dma (w_gate)", nmat=2, ck=cg is not None)
    b, n = x.shape
    f = w_gate.shape[1]
    xf, sg, su = _f32(x), _f32(sg), _f32(su)
    st, sz = _i32(starts), _i32(sizes)
    cg, cu = (None, None) if cg is None else (_i32(cg), _i32(cu))
    h = torch.empty((b, f), dtype=torch.float32, device=x.device)
    lib, name = (("chunk_gather.cu", "k2_gate_up") if cg is None
                 else ("chunk_gather_ck.cu", "k2_gate_up_ck"))
    rc = getattr(library(lib), name)(
        w_gate.data_ptr(), w_up.data_ptr(), _WTYPE[w_gate.dtype], xf.data_ptr(),
        st.data_ptr(), sz.data_ptr(), _ptr(sg), _ptr(su), _ptr(cg), _ptr(cu), h.data_ptr(),
        b, n, f, st.shape[0], max_chunk_rows // BLOCK_ROWS, prefetch_depth, g["tile"],
        g["blocks"], stream_ptr(x.device),
    )
    check(rc, name)
    return h


def chunk_gather_matmul_dma(
    w: torch.Tensor,  # (N, D) bf16/f32, or the int8 payload when scales is given
    x: torch.Tensor,  # (B, N)
    starts: torch.Tensor,  # (K,) int32, multiples of block_rows
    sizes: torch.Tensor,  # (K,) int32, multiples of block_rows (0 = padded)
    scales: Optional[torch.Tensor] = None,  # (N // block_rows,) f32
    checksums: Optional[torch.Tensor] = None,  # (N // block_rows,) int32 words
    *,
    block_rows: int = 8,
    max_chunk_rows: int = 512,
    prefetch_depth: int = 1,
) -> torch.Tensor:
    """K1: y (B, D) f32 = Σ over the chunk table's blocks of x_blk @ W_blk
    (dequantized per block when ``scales`` is given). Numerically identical
    at every ``prefetch_depth`` ≥ 0; on the card the ring runs at
    ``min(prefetch_depth, MAX_PREFETCH_DEPTH, steps)`` stages ahead
    (``ring_depth``). ``checksums``: the block's integrity words, fetched
    through the ring beside the payload and never read (bit-identical
    output either way)."""
    _check_common(block_rows, max_chunk_rows, prefetch_depth)
    n, d = w.shape
    if x.ndim != 2 or x.shape[1] != n:
        raise ValueError(f"x must be (B, {n}), got {tuple(x.shape)}")
    if n % BLOCK_ROWS:
        raise ValueError(f"N={n} must be a multiple of block_rows={BLOCK_ROWS}")
    if scales is not None and scales.shape != (n // BLOCK_ROWS,):
        raise ValueError(f"scales must be ({n // BLOCK_ROWS},), got {tuple(scales.shape)}")
    if checksums is not None:
        _check_checksums(checksums, n, "chunk_gather_matmul_dma")
    _same_device(x.device, w, starts, sizes, scales, checksums)
    _check_dtype(w, scales, "chunk_gather_matmul_dma")
    if x.device.type == "cpu":
        return chunk_gather_matmul_plain(w, x, starts, sizes, scales, None, max_chunk_rows,
                                         checksums)
    if x.device.type != "cuda":
        raise ValueError(f"chunk_gather_matmul_dma: unsupported device {x.device}")
    y = _launch_k1(w, x, starts, sizes, scales, None, max_chunk_rows, prefetch_depth, checksums)
    LAUNCHES["chunk_gather_matmul_dma"] += 1
    LANE_LAUNCHES["chunk_gather_matmul_dma"] += checksums is not None
    return y


def chunk_gather_mlp_dma(
    w_gate: torch.Tensor,  # (N, F)
    w_up: torch.Tensor,  # (N, F)
    w_down: torch.Tensor,  # (F, D)
    x: torch.Tensor,  # (B, N)
    starts: torch.Tensor,  # (2, K): lane 0 = hidden_mlp, lane 1 = ffn
    sizes: torch.Tensor,  # (2, K)
    ffn_mask: Optional[torch.Tensor] = None,  # (F,) exact down-input row mask
    scales: Optional[tuple] = None,  # (sg, su, sd) f32 per-block lanes
    checksums: Optional[tuple] = None,  # (cg, cu, cd) int32 per-block words
    *,
    block_rows: int = 8,
    max_chunk_rows: int = 512,
    prefetch_depth: int = 1,
    return_h: bool = False,
):
    """K2: fused sparse SwiGLU. y (B, D) f32 = down-projection of
    h = swish(x@W_gate)·(x@W_up), gate/up gathered off ``starts[0]``, down
    off ``starts[1]`` with h multiplied by the exact ``ffn_mask`` at the
    gather. ``return_h=True`` also returns the unmasked h (B, F) f32. Any
    ``prefetch_depth`` ≥ 0, run on the card as K1's (``ring_depth``).
    ``checksums``: the three streams' integrity lanes, fetched (phase 1:
    cg, cu; phase 2: cd) and never read."""
    _check_common(block_rows, max_chunk_rows, prefetch_depth)
    n, f = w_gate.shape
    fd, d = w_down.shape
    if w_up.shape != (n, f) or w_up.dtype != w_gate.dtype or w_down.dtype != w_gate.dtype:
        raise ValueError("w_gate/w_up/w_down shape or dtype mismatch")
    if fd != f:
        raise ValueError(f"w_down rows {fd} must equal d_ff {f}")
    if n % BLOCK_ROWS or f % BLOCK_ROWS:
        raise ValueError(f"N={n} and F={f} must be multiples of block_rows={BLOCK_ROWS}")
    if starts.ndim != 2 or starts.shape[0] != 2 or starts.shape != sizes.shape:
        raise ValueError(f"starts/sizes must be (2, K) plan lanes, got "
                         f"{tuple(starts.shape)}/{tuple(sizes.shape)}")
    if x.ndim != 2 or x.shape[1] != n:
        raise ValueError(f"x must be (B, {n}), got {tuple(x.shape)}")
    if ffn_mask is not None and ffn_mask.shape != (f,):
        raise ValueError(f"ffn_mask must be ({f},), got {tuple(ffn_mask.shape)}")
    sg = su = sd = None
    if scales is not None:
        sg, su, sd = scales
        if sg.shape != (n // BLOCK_ROWS,) or su.shape != (n // BLOCK_ROWS,) \
                or sd.shape != (f // BLOCK_ROWS,):
            raise ValueError("scales must be ((N/8,), (N/8,), (F/8,))")
    cg = cu = cd = None
    if checksums is not None:
        cg, cu, cd = checksums
        _check_checksums(cg, n, "chunk_gather_mlp_dma gate")
        _check_checksums(cu, n, "chunk_gather_mlp_dma up")
        _check_checksums(cd, f, "chunk_gather_mlp_dma down")
    _same_device(x.device, w_gate, w_up, w_down, starts, sizes, ffn_mask, sg, su, sd, cg, cu, cd)
    for w, sc, name in ((w_gate, sg, "w_gate"), (w_up, su, "w_up"), (w_down, sd, "w_down")):
        _check_dtype(w, sc, f"chunk_gather_mlp_dma ({name})")
    if x.device.type == "cpu":
        y, h = chunk_gather_mlp_plain(w_gate, w_up, w_down, x, starts, sizes, ffn_mask,
                                      scales, max_chunk_rows, checksums)
        return (y, h) if return_h else y
    if x.device.type != "cuda":
        raise ValueError(f"chunk_gather_mlp_dma: unsupported device {x.device}")
    h = _launch_k2_gate_up(w_gate, w_up, x, starts[0], sizes[0], sg, su, max_chunk_rows,
                           prefetch_depth, cg, cu)
    y = _launch_k1(w_down, h, starts[1], sizes[1], sd, ffn_mask, max_chunk_rows, prefetch_depth,
                   cd)
    LAUNCHES["chunk_gather_mlp_dma"] += 1
    LANE_LAUNCHES["chunk_gather_mlp_dma"] += checksums is not None
    return (y, h) if return_h else y
