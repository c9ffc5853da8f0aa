"""K3 — the chunk-gathered sparse matmul of the per-matrix library path,
and the host helper that aligns a chunk table.

K3 — ``chunk_gather_matmul`` (csrc/chunk_gather.cuh, ``k3_kernel``)
  Replaces ``repro/kernels/chunk_gather_matmul.py::chunk_gather_matmul``
  (body ``_kernel``): y (B, D) f32 = Σ over the table's chunks of
  x_chunk · W_chunk, W bf16 or f32. On the TPU it is the BlockSpec form of
  K1: grid (D/tile_d, K, max_chunk_rows/8), a predicated accumulate.
  Its function is K1's without an input mask, so its plain version is
  K1's (``chunk_gather_matmul_plain`` with no scales and no mask), and on
  the card it is K1's device body (``k1_body``) in a kernel of its own,
  with the ring at depth 1 (the BlockSpec pipeline double-buffers). Bound
  on the H100: bytes, as K1; what bounded it, the serial per-block chain of
  each CTA, and the redesign that removes it (a flat block list, sector-wide
  column tiles over all SMs, x held whole, 16 warps forming partials while
  one thread per output adds them in order) are K1's
  (``chunk_gather_dma.py``), as is the exact arithmetic, so K3 agrees
  bitwise with its plain version and with K1 at depth 1. No tensor cores:
  ``wgmma`` would reassociate the sums. ``tile_d`` is validated as the
  reference does; the CUDA kernel picks its own column tile
  (``k1_geometry``) and handles a ragged edge itself.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.contiguity import mask_to_chunks_np
from .chunk_gather_dma import (
    _WTYPE,
    BLOCK_ROWS,
    _f32,
    _i32,
    _same_device,
    chunk_gather_matmul_plain,
    k1_launch_geometry,
)

LAUNCHES = {"chunk_gather_matmul": 0}

def check_fp_weights(name: str, w: torch.Tensor) -> None:
    """K3 and K4 take bf16 or f32 weights, no int8 payload."""
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {w.dtype} not supported (bf16, f32)")


def chunk_gather_matmul(
    w: torch.Tensor,  # (N, D) weights (rows = neurons), bf16 or f32
    x: torch.Tensor,  # (B, N) activations
    starts: torch.Tensor,  # (K,) int32, multiples of block_rows
    sizes: torch.Tensor,  # (K,) int32, multiples of block_rows (0 = padded)
    *,
    block_rows: int = 8,
    tile_d: int = 128,
    max_chunk_rows: int = 512,
) -> torch.Tensor:
    """K3: y (B, D) f32 = Σ_chunks x_chunk @ W_chunk. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    n, d = w.shape
    if d % tile_d:
        raise ValueError(f"D={d} must be a multiple of tile_d={tile_d}")
    if n % block_rows:
        raise ValueError(f"N={n} must be a multiple of block_rows={block_rows}")
    if max_chunk_rows % block_rows:
        raise ValueError("max_chunk_rows must be a multiple of block_rows")
    if block_rows != BLOCK_ROWS:
        raise ValueError(f"block_rows must be {BLOCK_ROWS}, got {block_rows}")
    if x.ndim != 2 or x.shape[1] != n:
        raise ValueError(f"x must be (B, {n}), got {tuple(x.shape)}")
    _same_device(x.device, w, starts, sizes)
    check_fp_weights("chunk_gather_matmul", w)
    if x.device.type == "cpu":
        return chunk_gather_matmul_plain(w, x, starts, sizes, None, None, max_chunk_rows)
    if x.device.type != "cuda":
        raise ValueError(f"chunk_gather_matmul: unsupported device {x.device}")
    from .build import check, library, stream_ptr

    g = k1_launch_geometry(w, x, starts.shape[0], 1, False, "chunk_gather_matmul")
    b = x.shape[0]
    xf, st, sz = _f32(x), _i32(starts), _i32(sizes)
    y = torch.empty((b, d), dtype=torch.float32, device=x.device)
    rc = library("chunk_gather.cu").k3_chunk_gather_matmul(
        w.data_ptr(), _WTYPE[w.dtype], xf.data_ptr(), st.data_ptr(), sz.data_ptr(),
        y.data_ptr(), b, n, d, st.shape[0], max_chunk_rows // BLOCK_ROWS, g["tile"],
        g["blocks"], stream_ptr(x.device),
    )
    check(rc, "k3_chunk_gather_matmul")
    LAUNCHES["chunk_gather_matmul"] += 1
    return y


def align_chunk_table(
    starts: np.ndarray,
    sizes: np.ndarray,
    block_rows: int,
    n: int,
    max_chunk_rows: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Round an arbitrary chunk table outward to block_rows alignment
    (start down, end up), clamped to [0, n). Overlapping or adjacent
    coverage is merged, then runs longer than ``max_chunk_rows`` are split
    so every entry fits the kernel's walk."""
    def _as_rows(name, arr):
        # row counts must be integral: a float table is cast once, here
        arr = np.asarray(arr)
        if arr.ndim != 1:
            raise ValueError(f"{name} must be 1-D, got shape {arr.shape}")
        cast = arr.astype(np.int64)
        if not np.issubdtype(arr.dtype, np.integer) and not np.array_equal(cast, arr):
            raise TypeError(
                f"{name} must hold integral row values, got dtype {arr.dtype} "
                "with non-integer entries"
            )
        return cast

    starts = _as_rows("starts", starts)
    sizes = _as_rows("sizes", sizes)
    if starts.shape != sizes.shape:
        raise ValueError(f"starts/sizes length mismatch: {starts.shape} vs {sizes.shape}")
    mask = np.zeros(n, bool)
    for s, z in zip(starts, sizes):
        if z <= 0:
            continue
        lo = (s // block_rows) * block_rows
        hi = min(n, ((s + z + block_rows - 1) // block_rows) * block_rows)
        mask[lo:hi] = True

    out_s, out_z = [], []
    for c in mask_to_chunks_np(mask):
        s, z = c.start, c.size
        if max_chunk_rows:
            while z > max_chunk_rows:
                out_s.append(s)
                out_z.append(max_chunk_rows)
                s += max_chunk_rows
                z -= max_chunk_rows
        out_s.append(s)
        out_z.append(z)
    return np.asarray(out_s, np.int32), np.asarray(out_z, np.int32)
