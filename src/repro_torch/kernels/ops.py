"""Public wrappers of the chunk-gather kernels, as ``repro.kernels.ops``
names them, and the selection mask → kernel table bridge.

There is no ``interpret`` switch: CPU tensors take each kernel's plain
version and CUDA tensors launch the kernel or raise. The ``tile_*``
arguments are validated as the reference validates them; the CUDA kernels
tile their output columns by 64.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.contiguity import mask_to_chunks_np
from .chunk_gather_dma import chunk_gather_matmul_dma, chunk_gather_mlp_dma
from .chunk_gather_matmul import align_chunk_table, chunk_gather_matmul
from .chunk_gather_swiglu import chunk_gather_swiglu


def sparse_matmul(w: torch.Tensor, x: torch.Tensor, starts: torch.Tensor, sizes: torch.Tensor,
                  *, block_rows: int = 8, tile_d: int = 128,
                  max_chunk_rows: int = 512) -> torch.Tensor:
    """y (B, D) f32 through K3: rows outside the chunk plan are never read."""
    return chunk_gather_matmul(w, x, starts, sizes, block_rows=block_rows, tile_d=tile_d,
                               max_chunk_rows=max_chunk_rows)


def sparse_swiglu(w_gate: torch.Tensor, w_up: torch.Tensor, x: torch.Tensor,
                  starts: torch.Tensor, sizes: torch.Tensor, *, block_rows: int = 8,
                  tile_f: int = 128, max_chunk_rows: int = 512) -> torch.Tensor:
    """h (B, F) f32 through K4: gate and up off one chunk plan, SiLU·mul."""
    return chunk_gather_swiglu(w_gate, w_up, x, starts, sizes, block_rows=block_rows,
                               tile_f=tile_f, max_chunk_rows=max_chunk_rows)


def sparse_matmul_dma(w: torch.Tensor, x: torch.Tensor, starts: torch.Tensor,
                      sizes: torch.Tensor, *, block_rows: int = 8, tile_d: int = 128,
                      max_chunk_rows: int = 512, prefetch_depth: int = 1) -> torch.Tensor:
    """``sparse_matmul`` through K1's ``prefetch_depth + 1``-stage ring;
    numerically identical at every depth."""
    if w.shape[1] % tile_d:
        raise ValueError(f"D={w.shape[1]} must be a multiple of tile_d={tile_d}")
    return chunk_gather_matmul_dma(w, x, starts, sizes, block_rows=block_rows,
                                   max_chunk_rows=max_chunk_rows,
                                   prefetch_depth=prefetch_depth)


def sparse_mlp_fused(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                     x: torch.Tensor, starts: torch.Tensor, sizes: torch.Tensor,
                     ffn_mask: Optional[torch.Tensor] = None, *, block_rows: int = 8,
                     tile_f: int = 128, tile_d: int = 128, max_chunk_rows: int = 512,
                     prefetch_depth: int = 1, return_h: bool = False):
    """The fused multi-site MLP through K2: gate/up off the hidden_mlp lane
    of a (2, K) plan, down off the ffn lane; ``ffn_mask``/``return_h`` as in
    ``chunk_gather_mlp_dma``."""
    if w_gate.shape[1] % tile_f or w_down.shape[1] % tile_d:
        raise ValueError("alignment violation")
    return chunk_gather_mlp_dma(w_gate, w_up, w_down, x, starts, sizes, ffn_mask,
                                block_rows=block_rows, max_chunk_rows=max_chunk_rows,
                                prefetch_depth=prefetch_depth, return_h=return_h)


def plan_to_kernel_table(mask, block_rows: int = 8, max_chunks: Optional[int] = None,
                         max_chunk_rows: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """Selection mask → block-aligned padded chunk table (host numpy, int32)
    for the kernels. A tensor mask is read back to the host."""
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    mask = np.asarray(mask)
    chunks = mask_to_chunks_np(mask)
    starts = np.asarray([c.start for c in chunks], np.int32)
    sizes = np.asarray([c.size for c in chunks], np.int32)
    starts, sizes = align_chunk_table(starts, sizes, block_rows, len(mask),
                                      max_chunk_rows=max_chunk_rows)
    k = max_chunks or max(len(starts), 1)
    out_s = np.zeros(k, np.int32)
    out_z = np.zeros(k, np.int32)
    out_s[: len(starts)] = starts[:k]
    out_z[: len(sizes)] = sizes[:k]
    return out_s, out_z
