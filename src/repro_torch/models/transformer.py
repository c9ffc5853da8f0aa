"""Decoder block + layer loop of the dense and VLM families (the port's copy
of the forward, prefill, decode and frame-append parts of
``repro.models.transformer``).

The layer loop is a Python loop over the stacked (L, ...) params; the
decode plan and the KV cache are updated in place. On the planned decode
path the plan of every layer is refreshed once, before the loop
(``SparseExecution.refresh_step``: one selection over all layers' sites),
and every sparsification site computes through the execution backend off
the plan's chunk tables: q/k/v and o through ``backend.project`` (K1 on the
kernel backend), the MLP through ``backend.swiglu_mlp`` (K2). With
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
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.quantize import QUANT_SUFFIX_CHECKSUM, QUANT_SUFFIX_PAYLOAD, QUANT_SUFFIX_SCALE
from .attention import (
    append_attention,
    cache_layer_update,
    decode_attention,
    multi_head_attention,
    project_kv_for_decode,
)
from .common import apply_rope, rms_norm, swish
from .mlp import swiglu_mlp, swiglu_mlp_planned

# the offloaded per-layer matrices governed by sparsification — the set the
# engine quantizes at wbits=8
SPARSE_WEIGHT_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def site_matrix_names(cfg: ModelConfig) -> Dict[str, Tuple[str, ...]]:
    """Which stored matrices stream through each sparsification site."""
    names = {"hidden_attn": ("wq", "wk", "wv"), "attn_out": ("wo",)}
    if cfg.d_ff and not cfg.has_moe:
        names["hidden_mlp"] = ("w_gate", "w_up")
        names["ffn"] = ("w_down",)
    return names


def layer_slice(stacked: Dict[str, torch.Tensor], layer: int) -> Dict[str, torch.Tensor]:
    """One layer's params as views of the stacked (L, ...) leaves."""
    return {name: leaf[layer] for name, leaf in stacked.items()}


def _site_weight(params, sparse_ctx, name):
    """One offloaded matrix as the planned path streams it: (int8 payload,
    per-block scales) at wbits=8, (bf16 weight, None) at 16."""
    if sparse_ctx.wbits == 8 and name + QUANT_SUFFIX_PAYLOAD in params:
        return params[name + QUANT_SUFFIX_PAYLOAD], params[name + QUANT_SUFFIX_SCALE]
    return params[name], None


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


def _mlp_maybe_sparse(h: torch.Tensor, params, sparse_ctx):
    """SwiGLU with the paper's gate(+up-shared) and down masks selected in
    the step (the unplanned paths). Returns (y, estimated I/O seconds)."""
    if sparse_ctx is None:
        return swiglu_mlp(h, params), 0.0
    mask_g, io_g = _site_mask(sparse_ctx, "hidden_mlp", h)
    hm = _apply_mask(h, mask_g)
    mid = swish(hm @ params["w_gate"]) * (hm @ params["w_up"])
    mask_f, io_f = _site_mask(sparse_ctx, "ffn", mid)
    return _apply_mask(mid, mask_f) @ params["w_down"], io_g + io_f


def block_prefill(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Dense block over a full sequence; returns (x_out, k, v) where k/v are
    this layer's cache fill (k roped). Above ``BLOCKWISE_THRESHOLD``
    positions the attention is the blockwise one, as in the reference."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h = rms_norm(x, params["ln1_w"])
    k = (h @ params["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ params["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.rope_theta is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    x = x + multi_head_attention(h, params, cfg.n_heads, cfg.n_kv_heads, hd,
                                 positions=positions, rope_theta=cfg.rope_theta)
    x = x + swiglu_mlp(rms_norm(x, params["ln2_w"]), params)
    return x, k, v


def stack_prefill(stacked, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                  cache: Dict[str, Any]) -> torch.Tensor:
    """Run every layer over the prompt, filling ``cache`` in place."""
    s = x.shape[1]
    for layer in range(cfg.n_layers):
        x, k, v = block_prefill(layer_slice(stacked, layer), x, cfg, positions)
        cache["k"][layer, :, :s] = k
        cache["v"][layer, :, :s] = v
    cache["length"] = s
    return x


def stack_forward(stacked, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """Every layer over a whole sequence, no cache (the reference's
    ``stack_forward`` without a sparse context)."""
    for layer in range(cfg.n_layers):
        x, _, _ = block_prefill(layer_slice(stacked, layer), x, cfg, positions)
    return x


def block_append(params, x: torch.Tensor, layer_k: torch.Tensor, layer_v: torch.Tensor,
                 length: int, cfg: ModelConfig, sparse_ctx=None):
    """n new tokens x (b, n, d) through one layer, extending its cache in
    place at ``length …``. With a sparse context every site selects its
    mask from this frame's activations. Returns (x_out, estimated I/O
    seconds)."""
    h = rms_norm(x, params["ln1_w"])
    mask_q, io = _site_mask(sparse_ctx, "hidden_attn", h)
    attn = append_attention(_apply_mask(h, mask_q), params, layer_k, layer_v, length,
                            cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                            cfg.rope_theta, project_out=sparse_ctx is None)
    if sparse_ctx is not None:
        mask_o, lat = _site_mask(sparse_ctx, "attn_out", attn)
        io = io + lat
        attn = _apply_mask(attn, mask_o) @ params["wo"]
    x = x + attn
    y, lat = _mlp_maybe_sparse(rms_norm(x, params["ln2_w"]), params, sparse_ctx)
    return x + y, io + lat


def stack_append(stacked, x: torch.Tensor, cache: Dict[str, Any], cfg: ModelConfig,
                 sparse_ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append n tokens to every layer's cache (the paper's frame append);
    ``cache["length"]`` advances by n. Returns (x, the frame's estimated
    I/O seconds, a 0-d f32 tensor)."""
    length = cache["length"]
    io = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(cfg.n_layers):
        x, lat = block_append(layer_slice(stacked, layer), x, cache["k"][layer],
                              cache["v"][layer], length, cfg, sparse_ctx)
        io = io + lat
    cache["length"] = length + x.shape[1]
    return x, io


def _planned_mlp(h, params, sparse_ctx, plan, layer: int) -> torch.Tensor:
    """Planned-decode sparse MLP: read this layer's masks and tables, run
    the backend's fused SwiGLU, record both MLP sites' importances for the
    next refresh."""
    mask_g = plan["hidden_mlp"]["mask"][layer]
    mask_f = plan["ffn"]["mask"][layer]
    sparse_ctx.record_importance("hidden_mlp", h, plan, layer)
    starts, sizes = sparse_ctx.mlp_kernel_plan(plan, layer)
    y, mid = swiglu_mlp_planned(h, params, sparse_ctx.backend, mask_g, mask_f, starts, sizes,
                                quantized=sparse_ctx.wbits == 8)
    sparse_ctx.record_importance("ffn", mid, plan, layer)
    return y


def block_decode(params, x: torch.Tensor, layer_k: torch.Tensor, layer_v: torch.Tensor,
                 length: int, cfg: ModelConfig, sparse_ctx=None, plan=None,
                 layer: int = 0):
    """One decode token through one layer. ``length``: tokens in the cache
    before this one. With a sparse context and a decode plan (the planned
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
    h = rms_norm(x, params["ln1_w"])
    if planned:
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
        mask_q, io = _site_mask(sparse_ctx, "hidden_attn", h)
        h = _apply_mask(h, mask_q)
        q, k, v = (h @ params[name] for name in ("wq", "wk", "wv"))
    new_k, new_v = project_kv_for_decode(k, v, cfg.n_kv_heads, hd, length, cfg.rope_theta)
    cache_layer_update(layer_k, layer_v, new_k, new_v, length)
    attn = decode_attention(q, layer_k, layer_v, length + 1, cfg.n_heads, cfg.n_kv_heads, hd,
                            cfg.rope_theta, x.dtype)
    if planned:
        mask_o = plan["attn_out"]["mask"][layer]
        sparse_ctx.record_importance("attn_out", attn, plan, layer)
        w_o, sc_o = _site_weight(params, sparse_ctx, "wo")
        y_o = sparse_ctx.backend.project(w_o, attn.reshape(b, -1), mask_o,
                                         *sparse_ctx.kernel_tables(plan, "attn_out", layer),
                                         sc_o, params.get("wo" + QUANT_SUFFIX_CHECKSUM))
        attn = y_o.to(attn.dtype).reshape(b, 1, -1)
    else:
        mask_o, lat = _site_mask(sparse_ctx, "attn_out", attn)
        io = io + lat
        attn = _apply_mask(attn, mask_o) @ params["wo"]
    x = x + attn
    h = rms_norm(x, params["ln2_w"])
    if planned:
        return x + _planned_mlp(h, params, sparse_ctx, plan, layer), io
    y, lat = _mlp_maybe_sparse(h, params, sparse_ctx)
    return x + y, io + lat


def stack_decode(stacked, x: torch.Tensor, cache: Dict[str, Any], cfg: ModelConfig,
                 sparse_ctx=None, plan=None, refresh: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode token through every layer; the cache (and plan) update in
    place and ``cache["length"]`` advances by one. On the planned path the
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
    try:
        for layer in range(cfg.n_layers):
            x, lat = block_decode(layer_slice(stacked, layer), x, cache["k"][layer],
                                  cache["v"][layer], length, cfg, sparse_ctx, plan, layer)
            if sparse_ctx is not None and not planned:
                io[layer] = lat
    finally:
        if undo:
            sparse_ctx.restore_payloads(undo)
    cache["length"] = length + 1
    return x, io
