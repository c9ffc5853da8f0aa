"""GQA attention with RoPE, a linear KV cache and a paged one (the port's
copy of the parts of ``repro.models.attention`` the prefill, decode and
frame-append paths use); non-causal and cross-attention for the audio
encoder-decoder.

Prefill dispatches as the reference does: up to ``BLOCKWISE_THRESHOLD``
positions the direct (materialized-scores) attention, above it the
blockwise online-softmax attention, whose score memory is one (block_q,
block_kv) tile per head; either masks keys outside a sliding ``window``.
Under installed mesh rules whose model axis does not divide the head
count (Scout's 40 heads, StarCoder2-7B's 36 on 16 model ranks) and does
divide the sequence, q's layout puts the sequence on 'model' (the
``act_seq`` fallback), and a causal attention keeps that split: each model
rank runs its own query rows against the whole keys and values
(``_seq_split``), on the direct and the blockwise path alike;
the rules' ``seq_shard_attention`` (``--optimized``) takes that path at
over 2048 positions in any case, as the reference's ``shard_map`` does.
The cache is updated in place (PyTorch idiom; the reference returns new
arrays).

A rotating-window cache (``CacheSpec.window``) holds ``min(max_seq,
window)`` positions: a decode step writes position p at slot ``p % P``,
and once full every slot is valid — the last P positions.

The decode functions take the cache length as a host ``int`` (one stream
of lockstep rows) or as an int32 ``(b,)`` tensor on the device (slot mode:
each row an independent request). The tensor path never reads the lengths
back to the host: the write-position clamp and the valid mask are device
ops. The paged cache (``init_paged_kv_cache``) keeps per-layer page pools
and a (b, max_pages) page table; each decode layer gathers a dense view
through the table (``gather_paged_kv``), runs the unchanged decode on it,
and writes the one new entry back to its page (``scatter_paged_kv``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from ..sharding import serve as serve_mesh  # whole_rows reads the split at call time
from ..sharding.specs import current_rules, local_shard, mesh_placements, shard_act, \
    wrap_local
from .common import Leaf, apply_rope, causal_mask

# a decode cache length: a host int, or an int32 (b,) device tensor per slot
Length = Union[int, torch.Tensor]

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


def split_heads(y: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """(b, s, n·hd) → (b, s, n, hd). Under installed rules whose model axis
    shards the n·hd dim but does not divide the n heads (8 kv heads on 16
    model ranks), the heads have no even split: the dim is gathered first."""
    rules = current_rules()
    if rules is not None and n_heads % rules.axis_size("model"):
        y = shard_act(y, ("batch", None, None))
    return y.reshape(y.shape[0], y.shape[1], n_heads, head_dim)


# the logical layout of q (the sequence takes 'model' only where the heads
# cannot: a fallback)
Q_AXES = ("batch", "act_seq", "heads", "head_dim")


def _want_seq_shard_map(n_heads: int, q_shape) -> bool:
    """The reference's test for the sequence-sharded attention: rules with
    ``seq_shard_attention`` installed, a model axis over 1 that the head
    count does not divide, over 2048 positions that the model axis divides,
    and a batch the data axes divide."""
    rules = current_rules()
    if rules is None or not rules.seq_shard_attention:
        return False
    tp = rules.axis_size("model")
    dp = rules.axis_size(rules.rules.get("batch"))
    b, s = q_shape[0], q_shape[1]
    return tp > 1 and n_heads % tp != 0 and s > 2048 and s % tp == 0 and b % dp == 0


def _seq_on_model(q_shape) -> bool:
    """Whether the installed rules lay q's sequence out over 'model': the
    ``act_seq`` fallback, where the head count does not divide the model
    axis and the sequence does (Scout's 40 heads, StarCoder2's 24 and 36 on
    16 model ranks), as the reference's baseline layout does."""
    rules = current_rules()
    if rules is None:
        return False
    spec = rules.spec(Q_AXES, q_shape)
    return len(spec) > 1 and spec[1] is not None


def _seq_split(q, k, v, attend) -> torch.Tensor:
    """Attention with the query sequence sharded over 'model' (the
    reference's ``shard_map``, and its baseline layout where the heads do
    not divide the model axis): each model rank runs ``attend(q_rows, k,
    v, row0)`` for its ``s / tp`` query rows, ``row0`` = ``shard · s / tp``
    the index of its first, against the whole keys and values (gathered
    over 'model'; their gradients come back as partial sums over it). The
    batch stays on the data axes where they divide it. q, k, v: (b, s, h,
    hd) DTensors; the result is laid out as q."""
    rules = current_rules()
    mesh = rules.mesh
    dp_axis = rules.rules.get("batch")
    rows = {dp_axis: 0} if q.shape[0] % rules.axis_size(dp_axis) == 0 else {}
    s_local = q.shape[1] // rules.axis_size("model")
    q_pl = mesh_placements(mesh, {**rows, "model": 1})
    kv_pl = mesh_placements(mesh, rows)
    kv_grad = mesh_placements(mesh, rows, partial="model")
    qb = local_shard(q, q_pl)
    kb, vb = (local_shard(t, kv_pl, kv_grad) for t in (k, v))
    out = attend(qb, kb, vb, mesh.get_local_rank("model") * s_local)
    return wrap_local(out, mesh, q_pl, q.shape)


def _seq_sharded_attention(q, k, v, window: Optional[int]) -> torch.Tensor:
    """The reference's ``shard_map`` (``--optimized``): the causal
    blockwise attention of each model rank's query rows (``_seq_split``)."""
    return _seq_split(q, k, v, lambda qb, kb, vb, row0: _blockwise_attention(
        qb, kb, vb, row0, True, window))


def _per_head(core, q, k, v) -> torch.Tensor:
    """``core(q, k, v)``, an attention over (b, s, h, hd) tensors, with its
    heads merged: (b, s, h·hd). Under installed rules each rank runs it on
    its batch rows (data axes) and, where the model axis divides the heads,
    its heads: q, k and v are gathered into that layout (a causal attention
    whose heads the model axis does not divide keeps q's sequence split
    instead, ``_seq_split``). Every (row, head) is independent,
    so DTensor propagates none of the core's steps. The heads merge on the
    local block, so the gradient arriving from the output projection is
    brought to this layout before it is split into heads again (split over
    'model' it would not divide 12 heads on 16 ranks). Plain tensors go
    straight through."""
    rules = current_rules()
    if rules is None:
        return core(q, k, v).flatten(2)
    b, _, h, _ = q.shape
    dims = {}
    if b % rules.axis_size(rules.rules.get("batch")) == 0:
        dims[rules.rules.get("batch")] = 0
    if h % rules.axis_size("model") == 0:
        dims["model"] = 2
    pl = mesh_placements(rules.mesh, dims)
    out = core(*(local_shard(t, pl) for t in (q, k, v)))
    return wrap_local(out.flatten(2), rules.mesh, pl, q.shape[:2] + (h * q.shape[3],))


def _attention_mask(sq: int, sk: int, q_offset: int, window: Optional[int], device):
    """The direct attention's (sq, sk) causal mask for queries at q_offset
    + i, keys j; with a ``window``, also key j > query i − window."""
    mask = causal_mask(sq, sk, q_offset, device)
    if window is not None:
        mask = mask & ~causal_mask(sq, sk, q_offset - window, device)
    return mask


def multi_head_attention(x: torch.Tensor, params: Dict[str, torch.Tensor], n_heads: int,
                         n_kv_heads: int, head_dim: int,
                         positions: Optional[torch.Tensor] = None,
                         rope_theta: Optional[float] = 10000.0,
                         blockwise_threshold: Optional[int] = None,
                         window: Optional[int] = None, causal: bool = True,
                         kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         prefix: str = "") -> torch.Tensor:
    """Attention sublayer (projections + attention): (b, s, d) → (b, s, d),
    through ``{prefix}wq`` … ``{prefix}wo``. Causal self-attention by
    default; ``causal=False`` attends to every key (the audio encoder), and
    ``kv_override`` = (k, v), each (b, sk, kv, hd), replaces the k/v
    projections with pre-projected keys and values, used as they are (no
    RoPE on them): cross-attention over the encoder's states, or a prefill's
    own keys, roped once for its cache fill. Above ``blockwise_threshold``
    positions (None: the module's ``BLOCKWISE_THRESHOLD``, read at call
    time) the blockwise online-softmax attention, else the direct one, as in
    the reference. ``window``: each query sees only the keys of its last
    ``window`` positions."""
    b, s, _ = x.shape
    p = prefix
    q = split_heads(x @ params[f"{p}wq"], n_heads, head_dim)
    if rope_theta is not None and positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    if kv_override is None:
        k = split_heads(x @ params[f"{p}wk"], n_kv_heads, head_dim)
        v = split_heads(x @ params[f"{p}wv"], n_kv_heads, head_dim)
        if rope_theta is not None:
            k = apply_rope(k, positions, rope_theta)
    else:
        k, v = kv_override
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
    q = shard_act(q, Q_AXES)
    k = shard_act(k, ("batch", None, "kv_heads", "head_dim"))
    v = shard_act(v, ("batch", None, "kv_heads", "head_dim"))
    n_rep = n_heads // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    sk = k.shape[1]
    if blockwise_threshold is None:
        blockwise_threshold = BLOCKWISE_THRESHOLD
    q_offset = sk - s if causal else 0

    seq_map = causal and _want_seq_shard_map(n_heads, q.shape)  # --optimized

    # the attention of q's rows from row ``row0`` on (the whole sequence
    # from 0, a model rank's rows from its shard's first)
    if seq_map or max(s, sk) > blockwise_threshold:
        def attend(qb, kb, vb, row0):
            return _blockwise_attention(qb, kb, vb, q_offset + row0, causal, window)
    else:
        def attend(qb, kb, vb, row0):
            mask = _attention_mask(qb.shape[1], sk, q_offset + row0, window, qb.device) \
                if causal else None
            return _direct_attention(qb, kb, vb, mask)
    if seq_map or (causal and _seq_on_model(q.shape)):
        # the merged heads take 'model' from the sequence for the o
        # projection (one all_to_all): DTensor has no product of a
        # sequence-sharded input and a head-sharded weight
        out = shard_act(_seq_split(q, k, v, attend).reshape(b, s, n_heads * head_dim),
                        ("batch", None, "heads"))
    else:
        out = _per_head(lambda *qkv: attend(*qkv, 0), q, k, v)
    return out @ params[f"{p}wo"]


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static geometry of one layer's KV cache; ``window`` caps the physical
    length (rotating writes)."""

    batch: int
    max_seq: int
    n_kv_heads: int
    head_dim: int
    window: Optional[int] = None

    @property
    def physical_len(self) -> int:
        return min(self.max_seq, self.window) if self.window else self.max_seq


def kv_cache_layout(spec: CacheSpec, n_layers: int, dtype) -> Dict:
    """The (L, b, P, kv, hd) K and V leaves of a linear or rotating cache
    (``common.Leaf``s: ``Model.init_cache`` makes them) and its length."""
    kv = Leaf((n_layers, spec.batch, spec.physical_len, spec.n_kv_heads, spec.head_dim), dtype)
    return {"k": kv, "v": kv, "length": 0}  # length: a host int, never data-dependent


def init_paged_kv_cache(n_pages: int, page_tokens: int, batch: int, max_pages: int,
                        n_kv_heads: int, head_dim: int, n_layers: int, dtype,
                        device=None) -> Dict:
    """The paged twin of ``kv_cache_layout``: per-layer page pools (L,
    n_pages, page_tokens, kv, hd), a (batch, max_pages) int32 page table
    and per-slot int32 lengths (b,), all on ``device``. ``max_pages ·
    page_tokens`` is the logical ``max_seq``, so the gathered view has the
    dense cache's shape and the decode reduces over the same positions.

    The pools start at zero so pages no table has written hold finite
    values: a masked position then contributes an exact 0.0 probability
    times a finite value, as the dense cache's zeros do. Table rows start
    at the garbage page 0, where free slots write."""
    pool = (n_layers, n_pages, page_tokens, n_kv_heads, head_dim)
    return {
        "k": torch.zeros(pool, dtype=dtype, device=device),
        "v": torch.zeros(pool, dtype=dtype, device=device),
        "page_table": torch.zeros((batch, max_pages), dtype=torch.int32, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def gather_paged_kv(pool_layer: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One layer's dense view of the paged cache: ``pool_layer`` (n_pages,
    page_tokens, kv, hd) gathered by ``table`` (b, max_pages) → (b,
    max_pages · page_tokens, kv, hd), position for position the dense
    layer cache. Positions past a slot's length read whatever page the
    table maps (the garbage page for unmapped entries); the valid mask
    zeroes their probabilities exactly."""
    b, max_pages = table.shape
    _, page_tokens, n_kv, head_dim = pool_layer.shape
    return pool_layer.index_select(0, table.reshape(-1)).reshape(
        b, max_pages * page_tokens, n_kv, head_dim)


def scatter_paged_kv(pool_layer: torch.Tensor, dense_layer: torch.Tensor,
                     table: torch.Tensor, length: torch.Tensor, exchange=None) -> None:
    """Write each slot's new decode entry from its updated dense view
    ``dense_layer`` (b, P, kv, hd) back into its page, in place.

    The write position is ``min(length, P - 1)``, the clamp of
    ``cache_layer_update``, and for an occupied slot it lies in a private
    page (the prompt's partial tail or a decode-grown page: shared prefix
    pages are never written, which is why the final page of a
    ``max_seq``-long prompt stays private). Two rows can only meet on the
    garbage page, where free slots write. There the last row wins, as in
    the reference's scatter: every row of a collision writes the value of
    the highest row that shares its (page, offset), so the result does not
    depend on which duplicate ``index_put_`` lands last (on CUDA that order
    is arbitrary). Free slots read the garbage page back on later steps,
    and their activations feed the batched importance, so the winner
    matters.

    ``exchange``: a serve mesh's ``PageExchange``, where ``pool_layer`` is
    this data rank's slice of the pool and ``dense_layer``, ``table`` and
    ``length`` its slots' rows: every rank's entries and positions are
    gathered, the winners are taken over the whole batch with the whole
    table, and this rank writes those whose pages it holds."""
    phys = dense_layer.shape[1]
    page_tokens = pool_layer.shape[1]
    pos = torch.clamp(length, max=phys - 1).to(torch.int64)
    new = dense_layer[torch.arange(dense_layer.shape[0], device=dense_layer.device), pos]
    if exchange is not None:
        new, pos, table = exchange.rows(new), exchange.rows(pos), exchange.table
    rows = torch.arange(new.shape[0], device=new.device)
    page = table[rows, pos // page_tokens].to(torch.int64)
    off = pos % page_tokens
    flat = page * page_tokens + off
    same = flat[:, None] == flat[None, :]
    winner = torch.where(same, rows[None, :], torch.zeros_like(same, dtype=torch.int64)).amax(1)
    value = new[winner]
    if exchange is not None:
        page, off, value = exchange.local_writes(pool_layer, page, off, value)
    pool_layer[page, off] = value


def _decode_positions(length: Length, b: int, device) -> torch.Tensor:
    """(b, 1) RoPE positions of a decode step's rows at cache ``length``."""
    if isinstance(length, torch.Tensor):
        return length.reshape(-1, 1).expand(b, 1)
    return torch.full((b, 1), length, device=device)


def cache_layer_update(layer_k: torch.Tensor, layer_v: torch.Tensor, new_k: torch.Tensor,
                       new_v: torch.Tensor, length: Length,
                       window: Optional[int] = None) -> None:
    """Write one decode step's (b, 1, kv, hd) entries at ``length`` in place:
    at slot ``length % P`` with a ``window`` (the rotating cache), else
    clamped to the last slot once full, like the reference. A (b,)
    ``length`` writes each row at its own position, on the device."""
    phys = layer_k.shape[1]
    if isinstance(length, torch.Tensor):
        rows = torch.arange(layer_k.shape[0], device=layer_k.device)
        slot = (torch.remainder(length, phys) if window
                else torch.clamp(length, max=phys - 1)).to(torch.int64)
        layer_k[rows, slot] = new_k[:, 0]
        layer_v[rows, slot] = new_v[:, 0]
        return
    slot = length % phys if window else min(length, phys - 1)
    layer_k[:, slot] = new_k[:, 0]
    layer_v[:, slot] = new_v[:, 0]


def project_kv_for_decode(k: torch.Tensor, v: torch.Tensor, n_kv_heads: int, head_dim: int,
                          length: Length, rope_theta: Optional[float]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precomputed (b, 1, kv*hd) k/v projections → cache entries, RoPE on k
    at position ``length`` (each row's own with a (b,) ``length``)."""
    b = k.shape[0]
    k = split_heads(k.reshape(b, 1, -1), n_kv_heads, head_dim)
    v = split_heads(v.reshape(b, 1, -1), n_kv_heads, head_dim)
    if rope_theta is not None:
        k = apply_rope(k, _decode_positions(length, b, k.device), rope_theta)
    return k, v


def decode_attention(q: torch.Tensor, layer_k: torch.Tensor, layer_v: torch.Tensor,
                     length: Length, n_heads: int, n_kv_heads: int, head_dim: int,
                     rope_theta: Optional[float], out_dtype,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention of a precomputed q projection (b, 1, h*hd)
    against the cache; ``length`` counts the current token (a (b,) tensor:
    each row's own count). With a ``window`` the cache rotates: its slots
    hold the last ``min(length, P)`` positions. Returns the
    pre-o-projection (b, 1, h*hd) in ``out_dtype``."""
    b = q.shape[0]
    phys = layer_k.shape[1]
    q = split_heads(q.reshape(b, 1, -1), n_heads, head_dim)
    if rope_theta is not None:
        q = apply_rope(q, _decode_positions(length - 1, b, q.device), rope_theta)
    q = shard_act(q, ("batch", None, "heads", "head_dim"))
    n_rep = n_heads // n_kv_heads
    # Both products are broadcast multiplies summed over their innermost,
    # contiguous dim, so each row's sums run in one order however many rows
    # share the call (a batched matmul may pick its kernel, and so its
    # summation order, by the row count — the CPU's does). A data rank of a
    # sharded serve mesh holds fewer rows than the 1×1 mesh, and its tokens
    # must equal the 1×1 mesh's.
    k = repeat_kv(layer_k, n_rep).to(torch.float32)                    # (b, P, h, hd)
    v_t = repeat_kv(layer_v, n_rep).permute(0, 2, 3, 1).to(
        torch.float32, memory_format=torch.contiguous_format)          # (b, h, hd, P)
    q = q.to(torch.float32)
    scores = (q * k).sum(-1).transpose(1, 2)[:, :, None, :] * head_dim ** -0.5
    slot = torch.arange(phys, device=q.device)
    if isinstance(length, torch.Tensor):
        filled = torch.clamp(length, max=phys) if window else length
        valid = (slot[None, :] < filled[:, None])[:, None, None, :]
    else:
        valid = (slot < (min(length, phys) if window else length))[None, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = (probs * v_t).sum(-1).to(out_dtype)                           # (b, h, hd)
    return out.reshape(b, 1, n_heads * head_dim)


def append_attention(x: torch.Tensor, params: Dict[str, torch.Tensor], layer_k: torch.Tensor,
                     layer_v: torch.Tensor, length: int, n_heads: int, n_kv_heads: int,
                     head_dim: int, rope_theta: Optional[float],
                     project_out: bool = True, kv_replicate: int = 1) -> torch.Tensor:
    """Multi-token cache-extending attention (the paper's frame append): the
    n new tokens x (b, n, d) take positions ``length … length + n − 1``,
    their k/v (each head repeated ``kv_replicate`` times, as the cache
    stores them) are written into the linear cache at those slots in place,
    and each new query attends causally to all history and to the new
    tokens before it. Returns (b, n, h*hd), through ``wo`` unless
    ``project_out`` is False (the sparse path masks before wo)."""
    out = attend_appended(x @ params["wq"], x @ params["wk"], x @ params["wv"], layer_k,
                          layer_v, length, n_heads, n_kv_heads, head_dim, rope_theta,
                          kv_replicate)
    return out @ params["wo"] if project_out else out


def attend_appended(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layer_k: torch.Tensor,
                    layer_v: torch.Tensor, length: int, n_heads: int, n_kv_heads: int,
                    head_dim: int, rope_theta: Optional[float],
                    kv_replicate: int = 1) -> torch.Tensor:
    """``append_attention`` after its q/k/v projections (b, n, h·hd) and
    (b, n, kv·hd), before the o projection: the cache write and the causal
    attention over it. Returns (b, n, h·hd). Its products round by the row
    count (at a few tokens a frame), so on a data-split serve mesh the
    attention runs at the whole batch's, this rank's rows padded
    (``whole_rows``)."""
    b, n, _ = q.shape
    phys = layer_k.shape[1]
    if length + n > phys:
        raise ValueError(f"appending {n} tokens at {length} overflows a cache of {phys}")
    positions = (length + torch.arange(n, device=q.device))[None].expand(b, n)
    q = q.reshape(b, n, n_heads, head_dim)
    k = k.reshape(b, n, n_kv_heads, head_dim)
    v = v.reshape(b, n, n_kv_heads, head_dim)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if kv_replicate > 1:
        k, v = repeat_kv(k, kv_replicate), repeat_kv(v, kv_replicate)
    layer_k[:, length: length + n] = k
    layer_v[:, length: length + n] = v
    n_rep = n_heads // (n_kv_heads * kv_replicate)
    slot = torch.arange(phys, device=q.device)[None, :]
    q_pos = (length + torch.arange(n, device=q.device))[:, None]

    def attend(q, layer_k, layer_v):
        return _direct_attention(q, repeat_kv(layer_k, n_rep), repeat_kv(layer_v, n_rep),
                                 slot <= q_pos)

    out = serve_mesh.whole_rows(attend, local=(q, layer_k, layer_v))
    return out.reshape(b, n, n_heads * head_dim)
