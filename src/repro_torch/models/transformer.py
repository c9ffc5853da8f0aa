"""Decoder block + layer loop of the dense, MoE and VLM families (the
port's copy of the forward, prefill, decode and frame-append parts of
``repro.models.transformer``).

The layer loop is a Python loop over the stacked (L, ...) params, each
layer's weights views taken with one ``unstack`` a call; the decode plan
and the KV cache are updated in place. The training forward
(``stack_forward``) carries the MoE layers' auxiliary loss out, and with ``remat``
recomputes each layer in the backward (``jax.checkpoint`` of the
reference's layer scan). On the planned decode
path the plan of every layer is refreshed once, before the loop
(``SparseExecution.refresh_step``: one selection over all layers' sites),
and every sparsification site computes through the execution backend off
the plan's chunk tables: q/k/v and o through ``backend.project`` (K1 on the
kernel backend), the SwiGLU MLP through ``backend.swiglu_mlp`` (K2), the
non-gated gelu MLP (StarCoder2) through two ``backend.project`` calls (K1
on w_fc, then on w_proj). A MoE layer has no MLP sites: its experts run
``moe.moe_ffn`` on every path (prefill, frame append, decode), over the
call's own tokens, as in the reference. The norms are RMSNorm or LayerNorm
with biases by ``cfg.norm`` (``apply_norm``). With
corruption injection the refresh verifies the streamed payloads against
their ``_ck`` lanes (``_integrity_weights``), the kernels fetch those lanes
beside the payloads, and with recovery off the refresh's damaged rows are
written into the payloads for the step's gathers and restored after it.

The unplanned paths — frame append, and a decode with a sparse context but
no plan (method ``dense``) — select each site's mask in the step itself
(``SparseExecution.mask``: the one-lane K5 walk for ``chunk``) and compute
masked dense products with the bf16 originals; at wbits 8 the int8 leaves
serve the planned decode only, as in the reference; so does the damage of
recovery-off corruption.

In slot mode the decode's ``cache["length"]`` is an int32 (b,) device
tensor (each row its own request); with a paged cache every layer gathers
its dense view through the page table, decodes on it, and scatters the new
entry back (``attention.gather_paged_kv`` / ``scatter_paged_kv``), on a
sharded serve mesh through the cache's ``page_exchange`` (the pages other
data ranks hold).

With a sliding ``window`` the prefill's attention masks keys older than the
window and the cache is a rotating one of ``phys_len`` positions: the
prefill keeps the prompt's last ``phys_len`` positions at slot ``pos %
phys_len``, and each decode step writes at ``length % phys_len``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.quantize import QUANT_SUFFIX_CHECKSUM, QUANT_SUFFIX_PAYLOAD, streamed_operand
from .attention import (
    Length,
    attend_appended,
    cache_layer_update,
    decode_attention,
    gather_paged_kv,
    multi_head_attention,
    project_kv_for_decode,
    repeat_kv,
    scatter_paged_kv,
    split_heads,
)
from ..sharding import serve as serve_mesh  # whole_rows reads the split at call time
from ..sharding.specs import add_residual, shard_act
from .common import apply_rope, gelu, layer_norm, rematerialised, rms_norm, swish, unstack
from .mlp import gelu_mlp, gelu_mlp_planned, swiglu_mlp, swiglu_mlp_planned
from .moe import MoEConfig, moe_ffn

# the offloaded per-layer matrices governed by sparsification — the set the
# engine quantizes at wbits=8; names absent from a family are skipped
SPARSE_WEIGHT_NAMES = (
    "wq", "wk", "wv", "wo",
    "w_gate", "w_up", "w_down",  # swiglu family
    "w_fc", "w_proj",  # non-gated gelu family
)


def moe_cfg_of(cfg: ModelConfig) -> MoEConfig:
    return MoEConfig(n_experts=cfg.n_experts, top_k=cfg.moe_top_k, d_model=cfg.d_model,
                     d_ff=cfg.d_ff, capacity_factor=cfg.moe_capacity_factor,
                     shared_expert=cfg.moe_shared_expert, dispatch=cfg.moe_dispatch)


def site_matrix_names(cfg: ModelConfig) -> Dict[str, Tuple[str, ...]]:
    """Which stored matrices stream through each sparsification site, in
    site matrix order (the gelu family's hidden_mlp site streams one
    matrix, w_fc)."""
    names = {"hidden_attn": ("wq", "wk", "wv"), "attn_out": ("wo",)}
    if cfg.d_ff and not cfg.has_moe:
        if cfg.mlp == "gelu":
            names["hidden_mlp"] = ("w_fc",)
            names["ffn"] = ("w_proj",)
        else:
            names["hidden_mlp"] = ("w_gate", "w_up")
            names["ffn"] = ("w_down",)
    return names


def apply_norm(x: torch.Tensor, params, cfg: ModelConfig, name: str) -> torch.Tensor:
    """The block's ``name`` norm: LayerNorm (weight and bias) or RMSNorm."""
    if cfg.norm == "layernorm":
        return layer_norm(x, params[f"{name}_w"], params[f"{name}_b"])
    return rms_norm(x, params[f"{name}_w"])


def _site_weight(params, sparse_ctx, name):
    """One offloaded matrix as the planned path streams it (quantized where
    the engine packed an int8 payload at wbits=8)."""
    return streamed_operand(params, name,
                            sparse_ctx.wbits == 8 and name + QUANT_SUFFIX_PAYLOAD in params)


def _integrity_weights(stacked, sparse_ctx, cfg: ModelConfig):
    """Each site's ((payload (L, N, D), checksums (L, N/8)), ...) in site
    matrix order — the stored leaves the planned decode streams, with their
    pack-time ``_ck`` lanes — for the refresh's verify; None with integrity
    off."""
    if not sparse_ctx.integrity_enabled:
        return None
    return {kind: tuple((_site_weight(stacked, sparse_ctx, nm)[0],
                         stacked[nm + QUANT_SUFFIX_CHECKSUM]) for nm in names)
            for kind, names in site_matrix_names(cfg).items()}


def _apply_mask(x: torch.Tensor, mask) -> torch.Tensor:
    return x if mask is None else x * mask.to(x.dtype)


def _site_mask(sparse_ctx, kind: str, acts: torch.Tensor):
    """One site's in-step selection: (mask (N,) f32 or None, estimated I/O
    seconds); (None, 0.0) without a sparse context."""
    if sparse_ctx is None:
        return None, 0.0
    return sparse_ctx.mask(kind, acts)


def _dense_mlp(h: torch.Tensor, params, cfg: ModelConfig):
    """The layer's feed-forward, unmasked: (y, the MoE's load-balance aux
    loss — a 0-d f32 tensor — or None for the gelu MLP and SwiGLU). The
    serving paths drop the aux loss; the training forward sums it."""
    if cfg.has_moe:
        return moe_ffn(h, params, moe_cfg_of(cfg))
    return (gelu_mlp(h, params) if cfg.mlp == "gelu" else swiglu_mlp(h, params)), None


def _mlp_maybe_sparse(h: torch.Tensor, params, cfg: ModelConfig, sparse_ctx):
    """The MLP (SwiGLU, or the gelu family's with biases, added in the
    compute dtype) with the paper's hidden (gate+up-shared) and ffn masks
    selected in the step (the unplanned paths); a MoE layer's experts
    unmasked at no I/O (it has no MLP sites). Returns (y, estimated I/O
    seconds)."""
    if sparse_ctx is None or cfg.has_moe:
        return _dense_mlp(h, params, cfg)[0], 0.0
    mask_g, io_g = _site_mask(sparse_ctx, "hidden_mlp", h)
    hm = _apply_mask(h, mask_g)
    if cfg.mlp == "gelu":
        mid = gelu(hm @ params["w_fc"] + params["b_fc"])
        mask_f, io_f = _site_mask(sparse_ctx, "ffn", mid)
        y = _apply_mask(mid, mask_f) @ params["w_proj"] + params["b_proj"]
        return y, io_g + io_f
    mid = swish(hm @ params["w_gate"]) * (hm @ params["w_up"])
    mask_f, io_f = _site_mask(sparse_ctx, "ffn", mid)
    return _apply_mask(mid, mask_f) @ params["w_down"], io_g + io_f


def block_forward(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                  window: Optional[int] = None, h: Optional[torch.Tensor] = None,
                  kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Dense block over a full sequence, no cache: (x_out, the MoE's aux
    loss or None). ``h`` is the block's first norm of x and ``kv`` its
    roped keys and values, where the caller has them already."""
    if h is None:
        h = apply_norm(x, params, cfg, "ln1")
    h = shard_act(h, ("batch", None, "act_embed"))
    x = add_residual(x, multi_head_attention(h, params, cfg.n_heads, cfg.n_kv_heads,
                                             cfg.resolved_head_dim, positions=positions,
                                             rope_theta=cfg.rope_theta, window=window,
                                             kv_override=kv))
    h = shard_act(apply_norm(x, params, cfg, "ln2"), ("batch", None, "act_embed"))
    y, aux = _dense_mlp(h, params, cfg)
    return shard_act(add_residual(x, y), ("batch", "act_seq", "act_embed")), aux


def block_prefill(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                  window: Optional[int] = None, phys_len: Optional[int] = None):
    """Dense block over a full sequence; returns (x_out, k, v) where k/v are
    this layer's cache fill (k roped). Above ``BLOCKWISE_THRESHOLD``
    positions the attention is the blockwise one, as in the reference;
    ``window`` masks keys older than the window. With a ``phys_len``
    shorter than the sequence, k/v keep its last ``phys_len`` positions,
    rolled so that position p sits at slot ``p % phys_len`` (the rotating
    cache's layout). With ``cfg.kv_replicate`` > 1 each kv head of the
    fill is repeated that many times, as the cache stores it."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h = shard_act(apply_norm(x, params, cfg, "ln1"), ("batch", None, "act_embed"))
    k = split_heads(h @ params["wk"], cfg.n_kv_heads, hd)
    v = split_heads(h @ params["wv"], cfg.n_kv_heads, hd)
    if cfg.rope_theta is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    x = block_forward(params, x, cfg, positions, window, h, (k, v))[0]
    if cfg.kv_replicate > 1:
        k, v = repeat_kv(k, cfg.kv_replicate), repeat_kv(v, cfg.kv_replicate)
    if phys_len is not None and phys_len < s:
        roll = s % phys_len
        k = torch.roll(k[:, -phys_len:], shifts=roll, dims=1)
        v = torch.roll(v[:, -phys_len:], shifts=roll, dims=1)
    return x, k, v


def stack_prefill(stacked, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                  cache: Dict[str, Any], window: Optional[int] = None) -> torch.Tensor:
    """Run every layer over the prompt, filling ``cache`` in place (its
    physical length is the ``phys_len`` of a rotating cache)."""
    s = x.shape[1]
    phys = cache["k"].shape[2]
    for layer, params in enumerate(unstack(stacked)):
        x, k, v = block_prefill(params, x, cfg, positions, window, phys)
        cache["k"][layer, :, :k.shape[1]] = k
        cache["v"][layer, :, :v.shape[1]] = v
    cache["length"] = s
    return x


def stack_forward(stacked, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                  window: Optional[int] = None, remat: bool = False):
    """Every layer over a whole sequence, no cache (the reference's
    ``stack_forward`` without a sparse context): (x, the layers' summed MoE
    aux loss, a 0-d f32 tensor). With ``remat`` each layer is recomputed in
    the backward."""
    block = rematerialised(block_forward, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for params in unstack(stacked):
        x, layer_aux = block(params, x, cfg, positions, window)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


def _unplanned_qkv(params, x: torch.Tensor, cfg: ModelConfig, sparse_ctx):
    """The unplanned paths' attention input: the ln1 norm of x, the
    hidden_attn site's mask selected from it and the masked q/k/v
    products, over the whole batch's rows on a data-split serve mesh
    (``whole_rows``). Returns (q, k, v, estimated I/O seconds)."""
    def run(x):
        h = apply_norm(x, params, cfg, "ln1")
        mask_q, io = _site_mask(sparse_ctx, "hidden_attn", h)
        h = _apply_mask(h, mask_q)
        return h @ params["wq"], h @ params["wk"], h @ params["wv"], io

    return serve_mesh.whole_rows(run, x)


def _unplanned_out_mlp(params, x: torch.Tensor, attn: torch.Tensor, cfg: ModelConfig,
                       sparse_ctx):
    """The unplanned paths' rest of the block after the attention core: the
    attn_out site's mask and the o projection, the residual, the ln2 norm
    and the MLP (with its sites' masks), over the whole batch's rows on a
    data-split serve mesh. Returns (x_out, the attn_out site's and the
    MLP's estimated I/O seconds)."""
    def run(x, attn):
        mask_o, io_o = _site_mask(sparse_ctx, "attn_out", attn)
        x = x + _apply_mask(attn, mask_o) @ params["wo"]
        y, io_mlp = _mlp_maybe_sparse(apply_norm(x, params, cfg, "ln2"), params, cfg, sparse_ctx)
        return x + y, io_o, io_mlp

    return serve_mesh.whole_rows(run, x, attn)


def block_append(params, x: torch.Tensor, layer_k: torch.Tensor, layer_v: torch.Tensor,
                 length: int, cfg: ModelConfig, sparse_ctx=None):
    """n new tokens x (b, n, d) through one layer, extending its cache in
    place at ``length …``. With a sparse context every site selects its
    mask from this frame's activations. Returns (x_out, estimated I/O
    seconds)."""
    q, k, v, io = _unplanned_qkv(params, x, cfg, sparse_ctx)
    attn = attend_appended(q, k, v, layer_k, layer_v, length, cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim, cfg.rope_theta, cfg.kv_replicate)
    x, io_o, io_mlp = _unplanned_out_mlp(params, x, attn, cfg, sparse_ctx)
    return x, io + io_o + io_mlp


def stack_append(stacked, x: torch.Tensor, cache: Dict[str, Any], cfg: ModelConfig,
                 sparse_ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append n tokens to every layer's cache (the paper's frame append);
    ``cache["length"]`` advances by n. Returns (x, the frame's estimated
    I/O seconds, a 0-d f32 tensor)."""
    length = cache["length"]
    if isinstance(length, torch.Tensor):
        raise NotImplementedError("frame append extends one stream's linear cache; slot "
                                  "mode (per-slot lengths) has no frame append")
    io = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, params in enumerate(unstack(stacked)):
        x, lat = block_append(params, x, cache["k"][layer], cache["v"][layer], length, cfg,
                              sparse_ctx)
        io = io + lat
    cache["length"] = length + x.shape[1]
    return x, io


def _planned_mlp(h, params, cfg: ModelConfig, sparse_ctx, plan, layer: int) -> torch.Tensor:
    """Planned-decode sparse MLP: read this layer's masks and tables, run
    the backend's fused SwiGLU (or the gelu family's two projections),
    record both MLP sites' importances for the next refresh. Quantized
    when the first MLP matrix has its int8 payload at wbits 8."""
    mask_g = plan["hidden_mlp"]["mask"][layer]
    mask_f = plan["ffn"]["mask"][layer]
    sparse_ctx.record_importance("hidden_mlp", h, plan, layer)
    gelu_family = cfg.mlp == "gelu"
    first = "w_fc" if gelu_family else "w_gate"
    quantized = sparse_ctx.wbits == 8 and first + QUANT_SUFFIX_PAYLOAD in params
    if gelu_family:
        y, mid = gelu_mlp_planned(h, params, sparse_ctx.backend, mask_g, mask_f,
                                  sparse_ctx.kernel_tables(plan, "hidden_mlp", layer),
                                  sparse_ctx.kernel_tables(plan, "ffn", layer),
                                  quantized=quantized)
    else:
        starts, sizes = sparse_ctx.mlp_kernel_plan(plan, layer)
        y, mid = swiglu_mlp_planned(h, params, sparse_ctx.backend, mask_g, mask_f, starts,
                                    sizes, quantized=quantized)
    sparse_ctx.record_importance("ffn", mid, plan, layer)
    return y


def block_decode(params, x: torch.Tensor, layer_k: torch.Tensor, layer_v: torch.Tensor,
                 length: Length, cfg: ModelConfig, sparse_ctx=None, plan=None,
                 layer: int = 0, window: Optional[int] = None):
    """One decode token through one layer. ``length``: tokens in the cache
    before this one (a host int, or each slot's in a (b,) tensor); a
    ``window`` makes the cache a rotating one. With a sparse context and a decode plan (the planned
    path, already refreshed for this step by ``stack_decode``) every site
    computes through the execution backend off the plan's tables; with a
    sparse context and an empty plan (method ``dense``) each site takes
    ``sparse_ctx.mask`` and a masked dense product; without one the block
    runs dense. Returns (x_out, the unplanned path's estimated I/O seconds
    — 0.0 on the others, where the refresh charges it)."""
    hd = cfg.resolved_head_dim
    b = x.shape[0]
    planned = sparse_ctx is not None and bool(plan)
    io = 0.0
    if planned:
        h = apply_norm(x, params, cfg, "ln1")
        mask_q = plan["hidden_attn"]["mask"][layer]
        sparse_ctx.record_importance("hidden_attn", h, plan, layer)
        hs, hz = sparse_ctx.kernel_tables(plan, "hidden_attn", layer)
        hflat = h.reshape(b, -1)
        outs = []
        for name in ("wq", "wk", "wv"):
            w, sc = _site_weight(params, sparse_ctx, name)
            y = sparse_ctx.backend.project(w, hflat, mask_q, hs, hz, sc,
                                           params.get(name + QUANT_SUFFIX_CHECKSUM))
            outs.append(y.to(h.dtype).reshape(b, 1, -1))
        q, k, v = outs
    else:
        q, k, v, io = _unplanned_qkv(params, x, cfg, sparse_ctx)
    new_k, new_v = project_kv_for_decode(k, v, cfg.n_kv_heads, hd, length, cfg.rope_theta)
    if cfg.kv_replicate > 1:  # the cache stores each kv head kv_replicate times
        new_k, new_v = repeat_kv(new_k, cfg.kv_replicate), repeat_kv(new_v, cfg.kv_replicate)
    cache_layer_update(layer_k, layer_v, new_k, new_v, length, window)
    attn = decode_attention(q, layer_k, layer_v, length + 1, cfg.n_heads, cfg.n_cache_kv_heads, hd,
                            cfg.rope_theta, x.dtype, window)
    if not planned:
        x, io_o, io_mlp = _unplanned_out_mlp(params, x, attn, cfg, sparse_ctx)
        return x, io + io_o + io_mlp
    mask_o = plan["attn_out"]["mask"][layer]
    sparse_ctx.record_importance("attn_out", attn, plan, layer)
    w_o, sc_o = _site_weight(params, sparse_ctx, "wo")
    y_o = sparse_ctx.backend.project(w_o, attn.reshape(b, -1), mask_o,
                                     *sparse_ctx.kernel_tables(plan, "attn_out", layer),
                                     sc_o, params.get("wo" + QUANT_SUFFIX_CHECKSUM))
    x = x + y_o.to(attn.dtype).reshape(b, 1, -1)
    h = apply_norm(x, params, cfg, "ln2")
    if not cfg.has_moe:
        return x + _planned_mlp(h, params, cfg, sparse_ctx, plan, layer), io
    y, lat = _mlp_maybe_sparse(h, params, cfg, sparse_ctx)
    return x + y, io + lat


def stack_decode(stacked, x: torch.Tensor, cache: Dict[str, Any], cfg: ModelConfig,
                 sparse_ctx=None, plan=None, refresh: bool = True,
                 window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode token through every layer; the cache (and plan) update in
    place and ``cache["length"]`` advances by one (every slot's, free ones
    too, as in the reference). A paged cache is decoded layer by layer
    through dense views of its pools (never with a ``window``, which makes
    the dense cache a rotating one). On the planned path the
    plan of every layer is refreshed first, in one selection
    (``refresh_step``; a refresh of layer l reads only the importances
    layer l recorded on the previous step). Returns (x, io (L,)) — the
    per-layer I/O estimates the engine's prefetch timeline prices: on the
    planned path nonzero only on refresh steps, on the unplanned path
    (method ``dense``) every step's site masks' estimates, 0 without a
    sparse context."""
    length = cache["length"]
    planned = sparse_ctx is not None and bool(plan)
    undo = []
    if planned:
        if sparse_ctx.integrity_enabled:
            io = sparse_ctx.refresh_step(plan, refresh,
                                         _integrity_weights(stacked, sparse_ctx, cfg))
        else:
            io = sparse_ctx.refresh_step(plan, refresh)
        # recovery off: the epoch's damaged rows reach this step's gathers
        undo = sparse_ctx.apply_corruption(plan, stacked, site_matrix_names(cfg))
    else:
        io = torch.zeros((cfg.n_layers,), dtype=torch.float32, device=x.device)
    table = cache.get("page_table")
    if table is not None and window is not None:
        raise ValueError("paged KV does not compose with sliding windows")
    # on a sharded serve mesh: this data rank's slice of the pool, and how
    # it reaches the pages other ranks hold (sharding.serve.PageExchange)
    exchange = cache.get("page_exchange")
    try:
        for layer, params in enumerate(unstack(stacked)):
            layer_k, layer_v = cache["k"][layer], cache["v"][layer]
            if exchange is not None:
                layer_k, layer_v = (gather_paged_kv(exchange.pages(p), exchange.view)
                                    for p in (layer_k, layer_v))
            elif table is not None:
                layer_k, layer_v = gather_paged_kv(layer_k, table), gather_paged_kv(layer_v, table)
            x, lat = block_decode(params, x, layer_k, layer_v, length, cfg, sparse_ctx, plan,
                                  layer, window)
            if table is not None:
                scatter_paged_kv(cache["k"][layer], layer_k, table, length, exchange)
                scatter_paged_kv(cache["v"][layer], layer_v, table, length, exchange)
            if sparse_ctx is not None and not planned:
                io[layer] = lat
    finally:
        if undo:
            sparse_ctx.restore_payloads(undo)
    cache["length"] = length + 1
    return x, io
