"""K4 — the fused chunk-gathered SwiGLU gate/up of the per-matrix library
path. Its plain version is ``chunk_gather_dma.chunk_gather_swiglu_plain``,
which K2's plain version shares.

K4 — ``chunk_gather_swiglu`` (csrc/chunk_gather.cuh, ``k4_kernel``)
  Replaces ``repro/kernels/chunk_gather_swiglu.py::chunk_gather_swiglu``
  (body ``_kernel``): h (B, F) f32 = g · (1 / (1 + e^−g)) · u, where
  g = Σ x·W_gate and u = Σ x·W_up over one shared chunk table, W bf16 or
  f32. Its function is K2's phase 1, so on the card it is the same device
  body (``k1_body`` over the two weight streams) in a kernel of its own,
  with the ring at depth 1: each ring stage carries a table block's W_gate
  tile and its W_up tile, and the CTA's x rows are held whole. Bound on the
  H100: bytes (two weight tiles per block, 2·B flops per element). It
  agrees bitwise with its plain version and with K2's returned h.
  ``tile_f`` is validated as the reference does; the CUDA kernel tiles F by
  one 32-byte sector of each row (``k1_geometry(..., nmat=2)``).
"""
from __future__ import annotations

import torch

from .chunk_gather_dma import (
    _WTYPE,
    BLOCK_ROWS,
    _check_layout,
    _f32,
    _i32,
    _same_device,
    chunk_gather_swiglu_plain,
    k1_launch_geometry,
)
from .chunk_gather_matmul import check_fp_weights

LAUNCHES = {"chunk_gather_swiglu": 0}


def chunk_gather_swiglu(
    w_gate: torch.Tensor,  # (N, F)
    w_up: torch.Tensor,  # (N, F)
    x: torch.Tensor,  # (B, N)
    starts: torch.Tensor,  # (K,) int32
    sizes: torch.Tensor,  # (K,) int32
    *,
    block_rows: int = 8,
    tile_f: int = 128,
    max_chunk_rows: int = 512,
) -> torch.Tensor:
    """K4: h (B, F) f32. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    n, f = w_gate.shape
    if w_up.shape != (n, f):
        raise ValueError("w_gate/w_up shape mismatch")
    if f % tile_f or n % block_rows or max_chunk_rows % block_rows:
        raise ValueError("alignment violation")
    if block_rows != BLOCK_ROWS:
        raise ValueError(f"block_rows must be {BLOCK_ROWS}, got {block_rows}")
    if w_up.dtype != w_gate.dtype:
        raise ValueError("w_gate/w_up dtype mismatch")
    if x.ndim != 2 or x.shape[1] != n:
        raise ValueError(f"x must be (B, {n}), got {tuple(x.shape)}")
    _same_device(x.device, w_gate, w_up, starts, sizes)
    check_fp_weights("chunk_gather_swiglu", w_gate)
    if x.device.type == "cpu":
        return chunk_gather_swiglu_plain(w_gate, w_up, x, starts, sizes, None, max_chunk_rows)
    if x.device.type != "cuda":
        raise ValueError(f"chunk_gather_swiglu: unsupported device {x.device}")
    from .build import check, library, stream_ptr

    _check_layout(w_up, "chunk_gather_swiglu (w_up)")
    g = k1_launch_geometry(w_gate, x, starts.shape[0], 1, False, "chunk_gather_swiglu (w_gate)",
                           nmat=2)
    b = x.shape[0]
    xf, st, sz = _f32(x), _i32(starts), _i32(sizes)
    h = torch.empty((b, f), dtype=torch.float32, device=x.device)
    rc = library("chunk_gather.cu").k4_chunk_gather_swiglu(
        w_gate.data_ptr(), w_up.data_ptr(), _WTYPE[w_gate.dtype], xf.data_ptr(),
        st.data_ptr(), sz.data_ptr(), h.data_ptr(), b, n, f, st.shape[0],
        max_chunk_rows // BLOCK_ROWS, g["tile"], g["blocks"], stream_ptr(x.device),
    )
    check(rc, "k4_chunk_gather_swiglu")
    LAUNCHES["chunk_gather_swiglu"] += 1
    return h
