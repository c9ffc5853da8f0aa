"""GQA attention with RoPE and a linear KV cache (the port's copy of the
parts of ``repro.models.attention`` the prefill, decode and frame-append
paths use).

Prefill dispatches as the reference does: up to ``BLOCKWISE_THRESHOLD``
positions the direct (materialized-scores) attention, above it the
blockwise online-softmax attention, whose score memory is one (block_q,
block_kv) tile per head. The sequence-sharded path and rotating windows
come with later slices. The cache is updated in place (PyTorch idiom; the
reference returns new arrays).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .common import apply_rope

NEG_INF = -1e30
# prompts longer than this take the blockwise attention (the reference's
# ``blockwise_threshold`` default)
BLOCKWISE_THRESHOLD = 2048


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, s, kv, hd) -> (b, s, kv * n_rep, hd) by head repetition."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def _direct_attention(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    if mask is not None:
        m = mask if mask.ndim == 3 else mask[None]
        scores = torch.where(m[:, None, :, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def _blockwise_attention(q, k, v, q_offset: int, causal: bool, window: Optional[int] = None,
                         block_q: int = 512, block_kv: int = 1024) -> torch.Tensor:
    """Online-softmax attention over (block_q, block_kv) tiles, in the
    reference's order (``repro.models.attention._blockwise_attention``):
    the q blocks one after another, and for each the kv blocks in order,
    carrying the running max, normaliser and f32 accumulator. q: (b, sq,
    h, hd); k/v: (b, sk, h, hd); query i sits at position i + q_offset, key
    j at j. A kv block that lies wholly after a causal q block's last
    position is skipped: in the reference its scores are all NEG_INF, so
    it adds exact zeros and multiplies by exp(0) = 1 — skipping it leaves
    every bit as it was."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5
    nq, nk = -(-sq // block_q), -(-sk // block_kv)
    # (b, h, s, hd) f32, zero-padded to whole blocks
    qp = torch.nn.functional.pad(q.to(torch.float32), (0, 0, 0, 0, 0, nq * block_q - sq))
    kp = torch.nn.functional.pad(k.to(torch.float32), (0, 0, 0, 0, 0, nk * block_kv - sk))
    vp = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, 0, 0, nk * block_kv - sk))
    qp, kp, vp = (t.permute(0, 2, 1, 3) for t in (qp, kp, vp))
    out = torch.empty((b, h, nq * block_q, hd), dtype=torch.float32, device=q.device)
    iq = torch.arange(block_q, device=q.device)
    ik = torch.arange(block_kv, device=q.device)
    for qi in range(nq):
        qb = qp[:, :, qi * block_q: (qi + 1) * block_q] * scale
        q_pos = qi * block_q + iq + q_offset
        m = torch.full((b, h, block_q), NEG_INF, dtype=torch.float32, device=q.device)
        den = torch.zeros((b, h, block_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, block_q, hd), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            if causal and ki * block_kv > qi * block_q + block_q - 1 + q_offset:
                break
            k_pos = ki * block_kv + ik
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kp[:, :, ki * block_kv: (ki + 1) * block_kv])
            keep = (k_pos < sk)[None, :].expand(block_q, block_kv)
            if causal:
                keep = keep & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                keep = keep & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            den = den * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vp[:, :, ki * block_kv: (ki + 1) * block_kv])
            m = m_new
        out[:, :, qi * block_q: (qi + 1) * block_q] = acc / den.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3)[:, :sq].to(q.dtype)


def multi_head_attention(x: torch.Tensor, params: Dict[str, torch.Tensor], n_heads: int,
                         n_kv_heads: int, head_dim: int,
                         positions: Optional[torch.Tensor] = None,
                         rope_theta: Optional[float] = 10000.0,
                         blockwise_threshold: Optional[int] = None) -> torch.Tensor:
    """Causal self-attention sublayer (projections + attention): (b, s, d)
    → (b, s, d). Above ``blockwise_threshold`` positions (None: the module's
    ``BLOCKWISE_THRESHOLD``, read at call time) the blockwise online-softmax
    attention, else the direct one, as in the reference."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(b, s, n_kv_heads, head_dim)
    if rope_theta is not None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    n_rep = n_heads // n_kv_heads
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    sk = k.shape[1]
    if blockwise_threshold is None:
        blockwise_threshold = BLOCKWISE_THRESHOLD
    if max(s, sk) > blockwise_threshold:
        out = _blockwise_attention(q, k, v, sk - s, True)
    else:
        qi = torch.arange(s, device=x.device)[:, None] + (sk - s)
        kj = torch.arange(sk, device=x.device)[None, :]
        out = _direct_attention(q, k, v, kj <= qi)
    return out.reshape(b, s, n_heads * head_dim) @ params["wo"]


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static geometry of one layer's KV cache (linear: no window)."""

    batch: int
    max_seq: int
    n_kv_heads: int
    head_dim: int

    @property
    def physical_len(self) -> int:
        return self.max_seq


def init_kv_cache(spec: CacheSpec, n_layers: int, dtype, device=None) -> Dict:
    shape = (n_layers, spec.batch, spec.physical_len, spec.n_kv_heads, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": 0,  # tokens written so far (host int: never data-dependent)
    }


def cache_layer_update(layer_k: torch.Tensor, layer_v: torch.Tensor, new_k: torch.Tensor,
                       new_v: torch.Tensor, length: int) -> None:
    """Write one decode step's (b, 1, kv, hd) entries at ``length`` in place
    (clamped to the last slot once full, like the reference)."""
    slot = min(length, layer_k.shape[1] - 1)
    layer_k[:, slot] = new_k[:, 0]
    layer_v[:, slot] = new_v[:, 0]


def project_kv_for_decode(k: torch.Tensor, v: torch.Tensor, n_kv_heads: int, head_dim: int,
                          length: int, rope_theta: Optional[float]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precomputed (b, 1, kv*hd) k/v projections → cache entries, RoPE on k
    at position ``length``."""
    b = k.shape[0]
    k = k.reshape(b, 1, n_kv_heads, head_dim)
    v = v.reshape(b, 1, n_kv_heads, head_dim)
    if rope_theta is not None:
        pos = torch.full((b, 1), length, device=k.device)
        k = apply_rope(k, pos, rope_theta)
    return k, v


def decode_attention(q: torch.Tensor, layer_k: torch.Tensor, layer_v: torch.Tensor,
                     length: int, n_heads: int, n_kv_heads: int, head_dim: int,
                     rope_theta: Optional[float], out_dtype) -> torch.Tensor:
    """Single-token attention of a precomputed q projection (b, 1, h*hd)
    against the cache; ``length`` counts the current token. Returns the
    pre-o-projection (b, 1, h*hd) in ``out_dtype``."""
    b = q.shape[0]
    phys = layer_k.shape[1]
    q = q.reshape(b, 1, n_heads, head_dim)
    if rope_theta is not None:
        q = apply_rope(q, torch.full((b, 1), length - 1, device=q.device), rope_theta)
    n_rep = n_heads // n_kv_heads
    k = repeat_kv(layer_k, n_rep)
    v = repeat_kv(layer_v, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * head_dim ** -0.5
    valid = torch.arange(phys, device=q.device) < length
    scores = torch.where(valid[None, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32)).to(out_dtype)
    return out.reshape(b, 1, n_heads * head_dim)


def append_attention(x: torch.Tensor, params: Dict[str, torch.Tensor], layer_k: torch.Tensor,
                     layer_v: torch.Tensor, length: int, n_heads: int, n_kv_heads: int,
                     head_dim: int, rope_theta: Optional[float],
                     project_out: bool = True) -> torch.Tensor:
    """Multi-token cache-extending attention (the paper's frame append): the
    n new tokens x (b, n, d) take positions ``length … length + n − 1``,
    their k/v are written into the linear cache at those slots in place,
    and each new query attends causally to all history and to the new
    tokens before it. Returns (b, n, h*hd), through ``wo`` unless
    ``project_out`` is False (the sparse path masks before wo)."""
    b, n, _ = x.shape
    phys = layer_k.shape[1]
    if length + n > phys:
        raise ValueError(f"appending {n} tokens at {length} overflows a cache of {phys}")
    positions = (length + torch.arange(n, device=x.device))[None].expand(b, n)
    q = (x @ params["wq"]).reshape(b, n, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, n, n_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(b, n, n_kv_heads, head_dim)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    layer_k[:, length: length + n] = k
    layer_v[:, length: length + n] = v
    n_rep = n_heads // n_kv_heads
    slot = torch.arange(phys, device=x.device)[None, :]
    q_pos = (length + torch.arange(n, device=x.device))[:, None]
    out = _direct_attention(q, repeat_kv(layer_k, n_rep), repeat_kv(layer_v, n_rep),
                            slot <= q_pos).reshape(b, n, n_heads * head_dim)
    return out @ params["wo"] if project_out else out
