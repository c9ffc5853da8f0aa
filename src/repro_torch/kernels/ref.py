"""Plain-torch oracles of the chunk-gather kernels (allclose targets): the
masked dense products the kernels' chunk tables stand for, as in
``repro.kernels.ref``."""
from __future__ import annotations

import torch


def chunk_table_to_mask(starts, sizes, n: int) -> torch.Tensor:
    """(starts, sizes) padded chunk table → bool mask of length n."""
    starts = torch.as_tensor(starts)
    sizes = torch.as_tensor(sizes, device=starts.device)
    idx = torch.arange(n, device=starts.device)
    in_chunk = (idx[None, :] >= starts[:, None]) & (idx[None, :] < (starts + sizes)[:, None])
    return in_chunk.any(dim=0)


def chunk_gather_matmul_ref(w: torch.Tensor, x: torch.Tensor, starts, sizes) -> torch.Tensor:
    """y = Σ_{i in selected chunks} x[:, i] · w[i, :] in f32: the masked
    matmul of paper App. B.2."""
    mask = chunk_table_to_mask(starts, sizes, w.shape[0]).to(x.device)
    xm = x.to(torch.float32) * mask.to(torch.float32)[None, :]
    return xm @ w.to(torch.float32)


def chunk_gather_swiglu_ref(w_gate, w_up, x, starts, sizes) -> torch.Tensor:
    """Sparse gate/up off one chunk table, then SiLU·mul."""
    g = chunk_gather_matmul_ref(w_gate, x, starts, sizes)
    u = chunk_gather_matmul_ref(w_up, x, starts, sizes)
    return (g * (1.0 / (1.0 + torch.exp(-g)))) * u


def chunk_gather_mlp_ref(w_gate, w_up, w_down, x, starts, sizes) -> torch.Tensor:
    """The fused MLP: gate/up off lane 0 of a (2, K) plan, down off lane 1."""
    h = chunk_gather_swiglu_ref(w_gate, w_up, x, starts[0], sizes[0])
    mask_f = chunk_table_to_mask(starts[1], sizes[1], w_down.shape[0]).to(x.device)
    return (h * mask_f.to(torch.float32)[None, :]) @ w_down.to(torch.float32)
