"""Model builder of the port: one front door (``Model``) over the
reference's families (``repro.models.model``).

  * ``_DecoderLM`` — the dense, mixture-of-experts and early-fusion VLM
    decoders: RMSNorm or LayerNorm with biases, a SwiGLU or a non-gated
    gelu MLP with biases or a MoE layer (``models/moe.py``; with a shared
    expert, and with a projector for an early-fusion MoE such as
    Llama-4-Scout), a separate or a tied head (``embed.T``). Its decode is
    the planned sparse decode, and it takes frames and a paged cache.
  * ``_Zamba`` — the hybrid (Zamba2): groups of ``attn_every`` Mamba2
    layers (``models/ssm.py``), each followed by one shared attention +
    SwiGLU block whose weights every application reuses, with a KV cache per
    application; then a tail of the remaining Mamba2 layers.
  * ``_XLSTM`` — the recurrent (xLSTM): mLSTM and sLSTM blocks
    (``models/xlstm.py``), the state their cache.
  * ``_Whisper`` — the audio encoder-decoder: a non-causal encoder over the
    projected frontend plus sinusoidal positions, then a decoder with learned
    positions, causal self-attention with a KV cache and cross-attention
    over the encoder's keys and values, which prefill computes once.

The three non-decoder families reach no sparsification site: their decode
ignores the sparse context, ``decode_step_planned`` spreads their one I/O
figure (0) evenly over the layers, and frame append and paged KV refuse
them, as in the reference.

    model.init(seed, device)                       -> params (stacked leaves)
    model.init_cache(b, max_seq, device)           -> the family's cache (a KV
        cache rotates past WINDOW_ENGAGE_THRESHOLD positions:
        ``effective_window``); under installed mesh rules each rank makes
        only its block of each leaf (``cache_layout``, ``cache_axes``)
    model.init_paged_cache(b, max_seq, page_tokens, n_pages, device)
                                                   -> paged KV cache (decoders)
    model.forward(params, batch, remat=None)       -> (hidden, aux): the
        final-normed hidden states and the summed MoE load-balance loss
        (0.0 for the other families); ``remat`` (default ``cfg.remat``)
        recomputes each layer in the backward, at the reference's grain
    model.final_norm(params, x), model.logits(params, hidden)
                                                   -> the norm after the last layer,
                                                      hidden @ head (embed.T when tied)
    model.prefill(params, batch, max_seq)          -> (last_logits, cache)
        (prompts over 2048 positions, a VLM's vision tokens included, take
        the blockwise attention, as in the reference)
    model.append_embeds(params, frame, cache, sparse_ctx, device)
                                                   -> (hidden, io) (decoders)
    model.decode_step(params, token, cache, sparse_ctx)
                                                   -> (logits, io)
    model.decode_step_planned(params, token, cache, sparse_ctx, plan, refresh)
                                                   -> (logits, io (L,))
        (the cache's ``length`` is a host int, or for a decoder an int32 (b,)
        tensor of per-slot lengths in slot mode, where the cache may be paged)

The cache and the plan update in place. A batch is {"tokens": (b, s_text)}
plus, for a VLM, {"frontend": (b, n_front, d_frontend)} — the projected
frontend embeddings come first in the residual stream (early fusion:
[vision | text]) — and for the audio family {"frontend": (b,
frontend_tokens, d_frontend)}, the encoder's input.

Weights are made on the target device from a seeded ``torch.Generator``
with the reference's init scales (fan-in normal, 0.02 for the embedding
and head); JAX's PRNG is not recreated — parity tests carry the
reference's params over with ``models/convert.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..sharding import serve as serve_mesh  # whole_rows reads the split at call time
from ..sharding.specs import add_residual, current_rules, over_batch, replicated, shard_act
from .attention import (
    split_heads,
    CacheSpec,
    cache_layer_update,
    decode_attention,
    kv_cache_layout,
    init_paged_kv_cache,
    multi_head_attention,
    project_kv_for_decode,
)
from .common import BLOCK_AXES, Leaf, layer_norm, rematerialised, rms_norm, sinusoidal_positions, tree_leaves, \
    tree_unflatten, unstack, with_axes
from .mlp import gelu_mlp
from .moe import moe_param_shapes
from .ssm import Mamba2Config, mamba2_decode_step, mamba2_forward, mamba2_param_shapes, \
    mamba2_state_layout
from .transformer import (
    apply_norm,
    block_decode,
    block_forward,
    block_prefill,
    moe_cfg_of,
    stack_append,
    stack_decode,
    stack_forward,
    stack_prefill,
)
from .xlstm import (
    MLSTM_STATE_AXES,
    XLSTMConfig,
    mlstm_forward,
    mlstm_param_shapes,
    mlstm_state_layout,
    slstm_forward,
    slstm_param_shapes,
    slstm_state_layout,
)

COMPUTE_DTYPE = torch.bfloat16

# sliding windows engage only for ultra-long decode, as in the reference;
# read at call time (tests lower it to reach the rotating cache cheaply)
WINDOW_ENGAGE_THRESHOLD = 65_536

# Whisper's learned decoder positions (indexed modulo their count)
DEC_POSITIONS = 4096

# the layout of a sublayer's input under mesh rules (the reference's
# ``shard_act`` of a block's normed input): the sequence whole, as a
# product's input must be (``sharding.specs.add_residual``); the identity
# with no rules installed
WHOLE_SEQ = ("batch", None, "act_embed")


def _new_cache(impl, batch_size: int, max_seq: int, device) -> Dict:
    """The family ``impl``'s empty cache (``impl.cache_layout``) on
    ``device``: whole tensors; under installed mesh rules DTensors laid out
    by their logical axes (``impl.cache_axes()``, the reference's cache
    shardings, so a prefill's writes meet a DTensor of their own kind), of
    which this rank makes only its block (``MeshRules.full``), as GSPMD
    gives each device of the reference's jitted prefill only its block."""
    rules = current_rules()
    axes = dict(tree_leaves(impl.cache_axes()))

    def make(leaf, logical):
        if isinstance(leaf, tuple):  # a recurrent block's state
            return tuple(map(make, leaf, logical))
        if not isinstance(leaf, Leaf):
            return leaf  # the length
        if rules is None:
            return leaf.new(device)
        return rules.full(leaf.shape, logical, leaf.fill, leaf.dtype, device)

    return tree_unflatten((path, make(leaf, axes[path]))
                          for path, leaf in tree_leaves(impl.cache_layout(batch_size, max_seq)))


def effective_window(cfg: ModelConfig, seq_len: int) -> Optional[int]:
    """The sliding window a sequence (or cache) of ``seq_len`` positions
    runs with: the config's, past ``WINDOW_ENGAGE_THRESHOLD``, else None."""
    if cfg.sliding_window and seq_len > WINDOW_ENGAGE_THRESHOLD:
        return cfg.sliding_window
    return None


def _phys_len(cfg: ModelConfig, max_seq: int) -> int:
    """A KV cache's physical length: the window when it engages."""
    window = effective_window(cfg, max_seq)
    return min(max_seq, window) if window else max_seq


def _decode_window(cfg: ModelConfig, phys: int) -> Optional[int]:
    """The window a decode step runs with, read off the dense cache's
    physical length, as in the reference: a cache of exactly
    ``sliding_window`` positions rotates."""
    return cfg.sliding_window if cfg.sliding_window and phys == cfg.sliding_window else None


def block_param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """{name: (shape, init std or 'ones'/'zeros', logical axes)} of one
    decoder block: the norms (LayerNorm's biases beside its weights),
    q/k/v/o, and the SwiGLU MLP, the gelu family's w_fc/b_fc/w_proj/b_proj
    or a MoE layer's router/we_gate/we_up/we_down (and ws_gate/ws_up/ws_down
    with the shared expert). The axes are ``BLOCK_AXES``'."""
    d, f = cfg.d_model, cfg.d_ff
    hd_all = cfg.n_heads * cfg.resolved_head_dim
    kv_all = cfg.n_kv_heads * cfg.resolved_head_dim
    shapes = {
        "ln1_w": ((d,), "ones"),
        "ln2_w": ((d,), "ones"),
        "wq": ((d, hd_all), 1.0 / math.sqrt(d)),
        "wk": ((d, kv_all), 1.0 / math.sqrt(d)),
        "wv": ((d, kv_all), 1.0 / math.sqrt(d)),
        "wo": ((hd_all, d), 1.0 / math.sqrt(hd_all)),
    }
    if cfg.norm == "layernorm":
        shapes.update({"ln1_b": ((d,), "zeros"), "ln2_b": ((d,), "zeros")})
    if cfg.has_moe:
        return {**with_axes(shapes, BLOCK_AXES), **moe_param_shapes(moe_cfg_of(cfg))}
    if cfg.mlp == "gelu":
        shapes.update({"w_fc": ((d, f), 1.0 / math.sqrt(d)), "b_fc": ((f,), "zeros"),
                       "w_proj": ((f, d), 1.0 / math.sqrt(f)), "b_proj": ((d,), "zeros")})
    else:
        shapes.update({"w_gate": ((d, f), 1.0 / math.sqrt(d)),
                       "w_up": ((d, f), 1.0 / math.sqrt(d)),
                       "w_down": ((f, d), 1.0 / math.sqrt(f))})
    return with_axes(shapes, BLOCK_AXES)


def _nested(top: str, shapes: Dict[str, tuple], *lead: int) -> Dict[str, tuple]:
    """``shapes`` under ``top/``, each leaf stacked over ``lead`` dims, a
    "layer" axis each (the reference's ``stack_layer_defs``)."""
    return {f"{top}/{k}": ((*lead, *shape), std, ("layer",) * len(lead) + axes)
            for k, (shape, std, axes) in shapes.items()}


def _embed_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The embedding, the final norm, the head (none when tied) and an
    early-fusion model's projector."""
    d = cfg.d_model
    shapes = {"embed": ((cfg.vocab_size, d), 0.02, ("vocab", "embed")),
              "final_norm_w": ((d,), "ones", ("embed",))}
    if cfg.norm == "layernorm":
        shapes["final_norm_b"] = ((d,), "zeros", ("embed",))
    if not cfg.tie_embeddings:
        shapes["head"] = ((d, cfg.vocab_size), 0.02, ("embed", "vocab"))
    if cfg.d_frontend and not cfg.is_encdec:
        shapes["projector"] = ((cfg.d_frontend, d), 1.0 / math.sqrt(cfg.d_frontend),
                               (None, "embed"))
    return shapes


def _lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.to(torch.int64)]


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings in the compute dtype; on a mesh each data rank
    looks up its batch rows in the whole table (``over_batch``)."""
    return over_batch(_lookup, weights=(1,))(tokens, params["embed"]).to(COMPUTE_DTYPE)


def _final_norm(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, params["final_norm_w"], params["final_norm_b"])
    return rms_norm(x, params["final_norm_w"])


def _logits(params, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return hidden @ head.to(hidden.dtype)


def _decode_logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A decode step's f32 logits (b, vocab) from the last layer's (b, 1,
    d): the final norm and the head, over the whole batch's rows on a
    data-split serve mesh (``whole_rows``)."""
    return serve_mesh.whole_rows(
        lambda x: _logits(params, _final_norm(params, x, cfg)[:, 0], cfg).to(torch.float32), x)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


class Model:
    """The front door: dispatches on ``cfg.arch_type`` to the family's
    implementation and gives every family the same calls."""

    def __init__(self, cfg: ModelConfig):
        if cfg.arch_type not in _FAMILIES:
            raise ValueError(f"unknown arch_type {cfg.arch_type!r}")
        self.cfg = cfg
        self.family = cfg.arch_type
        self._impl = _FAMILIES[cfg.arch_type](cfg)

    @property
    def text_offset(self) -> int:
        """Where the token-aligned hidden states start (after the vision
        prefix of a VLM prompt)."""
        return self._impl.text_offset

    def param_shapes(self) -> Dict[str, tuple]:
        """{"top" or "top/leaf": (shape, init std or 'ones'/'zeros', logical
        axes)}: the reference's param tree and its ``ParamDef``s, two levels
        deep, stacked leaves included (a "layer" axis for each stacking)."""
        return self._impl.param_shapes()

    def param_axes(self) -> Dict:
        """The logical axes of ``init``'s tree, in its structure: a tuple of
        axis names (or None) per leaf, from the same tables as the shapes
        (the reference's ``Model.param_axes``)."""
        return tree_unflatten((name, axes) for name, (_, _, axes)
                              in self.param_shapes().items())

    def init(self, seed: int = 0, device=None) -> Dict:
        """Random weights on ``device`` (default ``cuda``; no card raises)
        from a seeded generator, leaves in sorted order. A leaf of 3 or more
        dims is drawn slice by slice along its first, so the f32 transient
        is one layer's (an (8, 8192, 28672) leaf of InternVL2-76B would take
        7.5 GB at once)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        params: Dict = {}
        for name, (shape, std, _) in sorted(self.param_shapes().items()):
            top, _, sub = name.partition("/")
            if std in ("ones", "zeros"):
                fill = torch.ones if std == "ones" else torch.zeros
                leaf = fill(shape, dtype=COMPUTE_DTYPE, device=device)
            elif len(shape) >= 3:
                leaf = torch.empty(shape, dtype=COMPUTE_DTYPE, device=device)
                for i in range(shape[0]):
                    leaf[i] = torch.randn(shape[1:], generator=gen, device=device) * std
            else:
                leaf = (torch.randn(shape, generator=gen, device=device) * std).to(COMPUTE_DTYPE)
            if sub:
                params.setdefault(top, {})[sub] = leaf
            else:
                params[top] = leaf
        return params

    def init_cache(self, batch_size: int, max_seq: int, device=None) -> Dict:
        """The family's empty decode cache for ``max_seq`` positions on
        ``device`` (default ``cuda``): a KV cache (rotating past the window
        threshold), recurrent states, or both. Under installed mesh rules
        each leaf is a DTensor laid out by ``cache_axes``, this rank making
        only its block."""
        return _new_cache(self._impl, batch_size, max_seq, resolve_device(device))

    def cache_layout(self, batch_size: int, max_seq: int) -> Dict:
        """``init_cache``'s tree before it is made: a ``common.Leaf`` (whole
        shape, dtype, fill) per tensor, tuples of them for a recurrent
        block's state, and the length."""
        return self._impl.cache_layout(batch_size, max_seq)

    def cache_axes(self):
        """The logical axes of ``init_cache``'s tree, in its structure: a
        tuple of axis names (or None) per tensor leaf, () for the length.
        ``ServeMesh.place_cache`` reads its "batch" dims."""
        return self._impl.cache_axes()

    def paged_cache_axes(self):
        """The logical axes of ``init_paged_cache``'s tree: the pools'
        "kv_page" dim partitions over data ranks as dense caches' "batch"
        dims do."""
        if not self.is_decoder:
            raise NotImplementedError(f"paged KV not supported for {self.family}")
        return self._impl.paged_cache_axes()

    @property
    def is_decoder(self) -> bool:
        """A decoder family (dense/moe/vlm): the one with sparsification
        sites, frame append, slot mode and a paged cache."""
        return isinstance(self._impl, _DecoderLM)

    @property
    def supports_paged_kv(self) -> bool:
        """The reference's name for ``is_decoder`` where a paged cache is
        meant."""
        return self.is_decoder

    def init_paged_cache(self, batch_size: int, max_seq: int, page_tokens: int, n_pages: int,
                         device=None) -> Dict:
        """The paged twin of ``init_cache`` (``attention.init_paged_kv_cache``):
        ``n_pages`` pages of ``page_tokens`` positions per layer, a per-slot
        page table and per-slot lengths, on ``device`` (default ``cuda``).
        Refuses a ``max_seq`` that pages do not tile, sliding windows, and
        the non-decoder families."""
        if not self.is_decoder:
            raise NotImplementedError(f"paged KV not supported for {self.family}")
        return self._impl.init_paged_cache(batch_size, max_seq, page_tokens, n_pages,
                                           resolve_device(device))

    def forward(self, params, batch: Dict[str, torch.Tensor], remat: Optional[bool] = None):
        """Dense forward over a whole sequence, no cache: (the final-normed
        hidden states (b, s, d), the MoE layers' summed load-balance aux
        loss, a 0-d f32 tensor — 0.0 for the families without MoE). With
        ``remat`` (None: the config's) each layer is recomputed in the
        backward, at the reference's grain: every decoder layer, every
        Mamba2 layer of a group (not the tail, not the shared block), every
        xLSTM block, every Whisper decoder layer (not the encoder). Past the
        window threshold the attention is windowed."""
        return self._impl.forward(params, batch, self.cfg.remat if remat is None else remat)

    def final_norm(self, params, x: torch.Tensor) -> torch.Tensor:
        """The norm after the last layer: LayerNorm (weight and bias) or
        RMSNorm, by the config's ``norm``."""
        return _final_norm(params, x, self.cfg)

    def logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        """hidden (..., d) @ the LM head (d, vocab), in hidden's dtype; the
        head is ``embed.T`` when the embeddings are tied."""
        return shard_act(_logits(params, hidden, self.cfg), ("batch", None, "vocab"))

    def prefill(self, params, batch: Dict[str, torch.Tensor], max_seq: int):
        """The prompt through every layer: (last-position logits (b, vocab)
        in the compute dtype, a freshly filled cache)."""
        return self._impl.prefill(params, batch, max_seq)

    def append_embeds(self, params, frame_embeds: torch.Tensor, cache: Dict,
                      sparse_ctx=None, device=None):
        """The frame-append stage (paper §2.1, ``_DecoderLM.append_embeds``);
        the non-decoder families refuse it."""
        if not self.is_decoder:
            raise NotImplementedError(f"append_frame not supported for {self.family}")
        return self._impl.append_embeds(params, frame_embeds, cache, sparse_ctx,
                                        resolve_device(device))

    def decode_step(self, params, token: torch.Tensor, cache: Dict, sparse_ctx=None):
        """One greedy-decode step: token (b, 1) → (logits (b, vocab) f32,
        the step's estimated I/O seconds, a 0-d f32 tensor); ``cache``
        updates in place. A decoder with a sparse context takes the
        unplanned path (each site's mask selected in the step)."""
        return self._impl.decode_step(params, token, cache, sparse_ctx)

    def decode_step_planned(self, params, token: torch.Tensor, cache: Dict,
                            sparse_ctx=None, plan: Optional[Dict] = None,
                            refresh: bool = True):
        """``decode_step`` with the chunk plan threaded through (``plan``
        and ``cache`` update in place; ``refresh``, a host bool, selects
        recompute vs reuse): (logits, io (L,) per-layer I/O estimates).
        Families without sparsification sites run their plain step, spread
        its I/O evenly over the layers, and leave ``plan`` as it was."""
        if self.is_decoder:
            return self._impl.decode_step_planned(params, token, cache, sparse_ctx, plan,
                                                  refresh)
        logits, io = self._impl.decode_step(params, token, cache, sparse_ctx)
        n_layers = self.cfg.n_layers
        return logits, (io / n_layers).expand(n_layers)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


# ---------------------------------------------------------------------------
# dense / moe / vlm decoder LM
# ---------------------------------------------------------------------------


class _DecoderLM:
    """Params {embed, final_norm_w (and _b for LayerNorm), head (absent when
    tied), projector (VLM only), layers: {name: (L, ...)}}."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.has_frontend = bool(cfg.d_frontend)
        self.text_offset = cfg.frontend_tokens if self.has_frontend else 0

    def param_shapes(self) -> Dict[str, tuple]:
        return {**_embed_shapes(self.cfg),
                **_nested("layers", block_param_shapes(self.cfg), self.cfg.n_layers)}

    def cache_layout(self, batch_size: int, max_seq: int) -> Dict:
        """A linear KV cache of ``max_seq`` positions, or past the window
        threshold a rotating one of ``min(max_seq, sliding_window)``."""
        cfg = self.cfg
        spec = CacheSpec(batch=batch_size, max_seq=max_seq, n_kv_heads=cfg.n_cache_kv_heads,
                         head_dim=cfg.resolved_head_dim, window=effective_window(cfg, max_seq))
        return kv_cache_layout(spec, cfg.n_layers, COMPUTE_DTYPE)

    def cache_axes(self):
        kv = ("layer", "batch", "cache_seq", "cache_kv_heads", "head_dim")
        return {"k": kv, "v": kv, "length": ()}

    def paged_cache_axes(self):
        kv = ("layer", "kv_page", "page_tokens", "cache_kv_heads", "head_dim")
        return {"k": kv, "v": kv, "page_table": ("batch", None), "length": ("batch",)}

    def init_paged_cache(self, batch_size: int, max_seq: int, page_tokens: int, n_pages: int,
                         device) -> Dict:
        cfg = self.cfg
        if max_seq % page_tokens != 0:
            raise ValueError(f"max_seq ({max_seq}) must be divisible by page_tokens "
                             f"({page_tokens})")
        if effective_window(cfg, max_seq):
            raise ValueError("paged KV does not compose with sliding windows")
        return init_paged_kv_cache(n_pages, page_tokens, batch_size, max_seq // page_tokens,
                                   cfg.n_cache_kv_heads, cfg.resolved_head_dim, cfg.n_layers,
                                   COMPUTE_DTYPE, device)

    def _embed_input(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The residual stream of a prompt: [frontend @ projector | embed
        (tokens)] for a VLM, the token embeddings otherwise."""
        x = _embed(params, batch["tokens"])
        if self.has_frontend:
            front = batch["frontend"].to(COMPUTE_DTYPE)
            x = torch.cat([front @ params["projector"].to(COMPUTE_DTYPE), x], dim=1)
        return shard_act(x, ("batch", "act_seq", "act_embed"))

    def forward(self, params, batch: Dict[str, torch.Tensor], remat: bool):
        x = self._embed_input(params, batch)
        b, s, _ = x.shape
        x, aux = stack_forward(params["layers"], x, self.cfg, _positions(b, s, x.device),
                               effective_window(self.cfg, s), remat)
        return _final_norm(params, x, self.cfg), aux

    def prefill(self, params, batch: Dict[str, torch.Tensor], max_seq: int):
        """A prompt longer than ``attention.BLOCKWISE_THRESHOLD`` positions
        (vision tokens included) takes the blockwise attention. Past the
        window threshold (of ``max_seq``) the attention is windowed and the
        cache rotating: it keeps the prompt's last ``sliding_window``
        positions."""
        x = self._embed_input(params, batch)
        b, s, _ = x.shape
        if s > max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
        cache = _new_cache(self, b, max_seq, x.device)
        x = stack_prefill(params["layers"], x, self.cfg, _positions(b, s, x.device), cache,
                          effective_window(self.cfg, max_seq))
        return _logits(params, _final_norm(params, x, self.cfg)[:, -1], self.cfg), cache

    def append_embeds(self, params, frame_embeds: torch.Tensor, cache: Dict,
                      sparse_ctx, device):
        """One frame of patch embeddings (b, n, d_frontend) → projector →
        an n-token extension of every layer's cache (the paper's frame
        append, §2.1), on ``device``. Without a projector the embeddings
        enter the stack as they are. ``cache`` updates in place. Returns
        (final-normed hidden (b, n, d), io: the frame's estimated I/O
        seconds, a scalar tensor)."""
        x = frame_embeds.to(device).to(COMPUTE_DTYPE)
        if "projector" in params:
            x = serve_mesh.whole_rows(lambda x: x @ params["projector"].to(COMPUTE_DTYPE), x)
        x, io = stack_append(params["layers"], x, cache, self.cfg, sparse_ctx)
        return _final_norm(params, x, self.cfg), io

    def decode_step(self, params, token: torch.Tensor, cache: Dict, sparse_ctx=None):
        logits, io = self.decode_step_planned(params, token, cache, sparse_ctx)
        return logits, io.sum()

    def decode_step_planned(self, params, token: torch.Tensor, cache: Dict,
                            sparse_ctx=None, plan: Optional[Dict] = None,
                            refresh: bool = True):
        """The window is read off the cache, as in the reference: a dense
        cache whose physical length equals ``sliding_window`` rotates; a
        paged one never does."""
        cfg = self.cfg
        window = None if "page_table" in cache else _decode_window(cfg, cache["k"].shape[2])
        x = _embed(params, token)
        x, io = stack_decode(params["layers"], x, cache, cfg, sparse_ctx, plan, refresh, window)
        return shard_act(_decode_logits(params, x, cfg), ("batch", "vocab")), io


# ---------------------------------------------------------------------------
# zamba2 hybrid: groups of Mamba2 layers + one shared attention/MLP block
# ---------------------------------------------------------------------------


class _Zamba:
    """Params {embed, final_norm_w, head, mamba_groups: {name: (groups,
    group size, ...)}, mamba_tail: {name: (tail, ...)} (when the layers do
    not split into whole groups), shared: {one decoder block}}. Cache
    {mamba_groups / mamba_tail: {"conv", "ssm"} stacked over their layers,
    attn_k / attn_v (groups, b, phys, kv, hd): one KV cache per application
    of the shared block, length}."""

    text_offset = 0

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.mcfg = Mamba2Config(d_model=cfg.d_model, d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
                                 expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim)
        self.group_size = cfg.attn_every
        self.n_groups = cfg.n_layers // cfg.attn_every
        self.n_tail = cfg.n_layers - self.n_groups * self.group_size

    def param_shapes(self) -> Dict[str, tuple]:
        cfg = self.cfg
        layer = {**mamba2_param_shapes(self.mcfg), "mnorm_w": ((cfg.d_model,), "ones", ("embed",))}
        shapes = {**_embed_shapes(cfg),
                  **_nested("mamba_groups", layer, self.n_groups, self.group_size),
                  **_nested("shared", block_param_shapes(cfg))}
        if self.n_tail:
            shapes.update(_nested("mamba_tail", layer, self.n_tail))
        return shapes

    def _layers(self, params):
        """(layer params, its state's stack in the cache, its index there,
        the shared block's application after it or None), in order."""
        for i, lp in enumerate(unstack(params["mamba_groups"], 2)):
            g, j = divmod(i, self.group_size)
            yield lp, "mamba_groups", i, g if j == self.group_size - 1 else None
        if self.n_tail:
            for j, lp in enumerate(unstack(params["mamba_tail"])):
                yield lp, "mamba_tail", j, None

    def _mamba_layer(self, lp, x: torch.Tensor) -> torch.Tensor:
        h = shard_act(rms_norm(x, lp["mnorm_w"]), WHOLE_SEQ)
        return add_residual(x, mamba2_forward(h, lp, self.mcfg))

    def forward(self, params, batch: Dict[str, torch.Tensor], remat: bool):
        cfg = self.cfg
        x = shard_act(_embed(params, batch["tokens"]), ("batch", "act_seq", "act_embed"))
        b, s, _ = x.shape
        positions, window = _positions(b, s, x.device), effective_window(cfg, s)
        in_group = rematerialised(self._mamba_layer, remat)
        for lp, stack, _, app in self._layers(params):
            x = (in_group if stack == "mamba_groups" else self._mamba_layer)(lp, x)
            if app is not None:
                x = block_forward(params["shared"], x, cfg, positions, window)[0]
        return _final_norm(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)

    def cache_layout(self, batch_size: int, max_seq: int) -> Dict:
        cfg = self.cfg

        def stacked_state(n):
            return {k: dataclasses.replace(leaf, shape=(n, *leaf.shape)) for k, leaf in
                    mamba2_state_layout(self.mcfg, batch_size, COMPUTE_DTYPE).items()}

        kv = Leaf((self.n_groups, batch_size, _phys_len(cfg, max_seq), cfg.n_kv_heads,
                   cfg.resolved_head_dim), COMPUTE_DTYPE)
        cache = {"mamba_groups": stacked_state(self.n_groups * self.group_size),
                 "attn_k": kv, "attn_v": kv, "length": 0}
        if self.n_tail:
            cache["mamba_tail"] = stacked_state(self.n_tail)
        return cache

    def cache_axes(self):
        mstate = {"conv": ("layer", "batch", None, "conv_dim"),
                  "ssm": ("layer", "batch", "ssm_heads", None, None)}
        kv = ("layer", "batch", "cache_seq", "cache_kv_heads", "head_dim")
        axes = {"mamba_groups": mstate, "attn_k": kv, "attn_v": kv, "length": ()}
        if self.n_tail:
            axes["mamba_tail"] = dict(mstate)
        return axes

    def _mamba_step(self, lp, h: torch.Tensor, conv: torch.Tensor, ssm: torch.Tensor):
        """One Mamba2 layer's recurrent step: (out, conv window, SSM state).
        Under mesh rules it runs on each data rank's rows (``over_batch``),
        the layer's weights whole: DTensor has no strategy for its products
        of flattened batch-sharded dims."""
        names = sorted(lp)

        def step(h, conv, ssm, *weights):
            out, st = mamba2_decode_step(h, {"conv": conv, "ssm": ssm},
                                         dict(zip(names, weights)), self.mcfg)
            return out, st["conv"], st["ssm"]

        return over_batch(step, weights=tuple(range(3, 3 + len(names))))(
            h, conv, ssm, *(lp[n] for n in names))

    def prefill(self, params, batch: Dict[str, torch.Tensor], max_seq: int):
        """The chunked-SSD forward over the prompt through every Mamba2
        layer, keeping each one's final state, and each application of the
        shared block fills its KV cache."""
        cfg = self.cfg
        x = _embed(params, batch["tokens"])
        b, s, _ = x.shape
        cache = _new_cache(self, b, max_seq, x.device)
        positions, window = _positions(b, s, x.device), effective_window(cfg, max_seq)
        phys = cache["attn_k"].shape[2]
        for lp, stack, i, app in self._layers(params):
            out, st = mamba2_forward(shard_act(rms_norm(x, lp["mnorm_w"]), WHOLE_SEQ), lp,
                                     self.mcfg, return_state=True)
            x = x + out
            for key, v in st.items():
                cache[stack][key][i] = v
            if app is not None:
                x, k, v = block_prefill(params["shared"], x, cfg, positions, window, phys)
                cache["attn_k"][app, :, :k.shape[1]] = k
                cache["attn_v"][app, :, :v.shape[1]] = v
        cache["length"] = s
        return _logits(params, _final_norm(params, x, cfg)[:, -1], cfg), cache

    def decode_step(self, params, token: torch.Tensor, cache: Dict, sparse_ctx=None):
        """The recurrent step of every Mamba2 layer and the shared block's
        decode against each application's cache; ``sparse_ctx`` is
        ignored."""
        cfg = self.cfg
        x = _embed(params, token)
        length = cache["length"]
        window = _decode_window(cfg, cache["attn_k"].shape[2])
        for lp, stack, i, app in self._layers(params):
            states = cache[stack]
            out, conv, ssm = self._mamba_step(lp, rms_norm(x, lp["mnorm_w"]),
                                              states["conv"][i], states["ssm"][i])
            x = x + out
            states["conv"][i], states["ssm"][i] = conv, ssm
            if app is not None:
                x, _ = block_decode(params["shared"], x, cache["attn_k"][app],
                                    cache["attn_v"][app], length, cfg, window=window)
        cache["length"] = length + 1
        return _decode_logits(params, x, cfg), torch.zeros((), dtype=torch.float32,
                                                           device=x.device)


# ---------------------------------------------------------------------------
# xLSTM: a Python loop over heterogeneous blocks
# ---------------------------------------------------------------------------


class _XLSTM:
    """Params {embed, final_norm_w, head, block_i: {the block's leaves,
    bnorm_w}}: sLSTM at ``cfg.slstm_layers``, mLSTM elsewhere. Cache
    {block_i: the block's state tuple, length}."""

    text_offset = 0

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.xcfg = XLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads)

    def _is_slstm(self, i: int) -> bool:
        return i in self.cfg.slstm_layers

    def param_shapes(self) -> Dict[str, tuple]:
        shapes = _embed_shapes(self.cfg)
        for i in range(self.cfg.n_layers):
            block = slstm_param_shapes(self.xcfg) if self._is_slstm(i) \
                else mlstm_param_shapes(self.xcfg)
            shapes.update(_nested(f"block_{i}",
                                  {**block, "bnorm_w": ((self.cfg.d_model,), "ones", ("embed",))}))
        return shapes

    def _block(self, i: int, bp, x: torch.Tensor, state):
        """Block i over x from ``state``: (x + its output, its new state)."""
        fn = slstm_forward if self._is_slstm(i) else mlstm_forward
        out, state = fn(shard_act(rms_norm(x, bp["bnorm_w"]), WHOLE_SEQ), bp, self.xcfg,
                        state=state)
        return add_residual(x, out), state

    def _run(self, params, x: torch.Tensor, cache: Dict) -> torch.Tensor:
        """Every block over x, each from its state in ``cache``, which takes
        the new states in place."""
        for i in range(self.cfg.n_layers):
            x, cache[f"block_{i}"] = self._block(i, params[f"block_{i}"], x, cache[f"block_{i}"])
        return x

    def forward(self, params, batch: Dict[str, torch.Tensor], remat: bool):
        """``remat`` is ignored, as in the reference: the recurrences
        rematerialise inside their chunked scans (``models/scan.py``), and a
        checkpoint around a block would make the backward run each scan a
        third time."""
        x = shard_act(_embed(params, batch["tokens"]), ("batch", "act_seq", "act_embed"))
        x = self._run(params, x, _new_cache(self, x.shape[0], x.shape[1], x.device))
        return _final_norm(params, x, self.cfg), torch.zeros((), dtype=torch.float32,
                                                             device=x.device)

    def cache_layout(self, batch_size: int, max_seq: int) -> Dict:
        cache = {f"block_{i}": (slstm_state_layout(self.xcfg, batch_size) if self._is_slstm(i)
                                else mlstm_state_layout(self.xcfg, batch_size))
                 for i in range(self.cfg.n_layers)}
        cache["length"] = 0
        return cache

    def cache_axes(self):
        axes = {f"block_{i}": (("batch", None),) * 4 if self._is_slstm(i) else MLSTM_STATE_AXES
                for i in range(self.cfg.n_layers)}
        axes["length"] = ()
        return axes

    def prefill(self, params, batch: Dict[str, torch.Tensor], max_seq: int):
        x = _embed(params, batch["tokens"])
        cache = _new_cache(self, x.shape[0], max_seq, x.device)
        x = self._run(params, x, cache)
        cache["length"] = x.shape[1]
        return _logits(params, _final_norm(params, x, self.cfg)[:, -1], self.cfg), cache

    def decode_step(self, params, token: torch.Tensor, cache: Dict, sparse_ctx=None):
        """Every block's recurrent step; ``sparse_ctx`` is ignored."""
        x = self._run(params, _embed(params, token), cache)
        cache["length"] += 1
        return _decode_logits(params, x, self.cfg), torch.zeros((), dtype=torch.float32,
                                                                device=x.device)


# ---------------------------------------------------------------------------
# whisper-style encoder-decoder (audio)
# ---------------------------------------------------------------------------


class _Whisper:
    """Params {embed, final_norm_w/_b, head, pos_embed_dec (4096, d),
    frontend_proj, enc_final_w/_b, encoder: {block: (E, ...)}, decoder:
    {block + the cross-attention's x_wq/x_wk/x_wv/x_wo and ln_x_w/_b: (L,
    ...)}}. Cache {k, v (L, b, phys, kv, hd): self-attention; enc_k, enc_v
    (L, b, frontend_tokens, kv, hd): the encoder's keys and values; length}."""

    text_offset = 0

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def param_shapes(self) -> Dict[str, tuple]:
        cfg = self.cfg
        d = cfg.d_model
        block = block_param_shapes(cfg)
        dec = {**block, **{f"x_{k}": block[k] for k in ("wq", "wk", "wv", "wo")},
               "ln_x_w": ((d,), "ones", ("embed",)), "ln_x_b": ((d,), "zeros", ("embed",))}
        return {**_embed_shapes(cfg),
                "pos_embed_dec": ((DEC_POSITIONS, d), 0.01, (None, "embed")),
                "frontend_proj": ((cfg.d_frontend, d), 1.0 / math.sqrt(cfg.d_frontend),
                                  (None, "embed")),
                "enc_final_w": ((d,), "ones", ("embed",)),
                "enc_final_b": ((d,), "zeros", ("embed",)),
                **_nested("encoder", block, cfg.encoder_layers),
                **_nested("decoder", dec, cfg.n_layers)}

    def _attention(self, h, lp, **kw):
        cfg = self.cfg
        return multi_head_attention(h, lp, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                                    rope_theta=None, **kw)

    def _encode(self, params, frontend: torch.Tensor) -> torch.Tensor:
        """The frontend (b, n, d_frontend) → projection + sinusoidal
        positions → the non-causal encoder blocks → the final LayerNorm."""
        cfg = self.cfg
        x = frontend.to(COMPUTE_DTYPE) @ params["frontend_proj"].to(COMPUTE_DTYPE)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(COMPUTE_DTYPE)[None]
        x = shard_act(x, ("batch", "act_seq", "act_embed"))
        for lp in unstack(params["encoder"]):
            h = shard_act(apply_norm(x, lp, cfg, "ln1"), WHOLE_SEQ)
            x = add_residual(x, self._attention(h, lp, causal=False))
            x = add_residual(x, gelu_mlp(shard_act(apply_norm(x, lp, cfg, "ln2"), WHOLE_SEQ),
                                         lp))
        return shard_act(layer_norm(x, params["enc_final_w"], params["enc_final_b"]), WHOLE_SEQ)

    def _enc_kv(self, lp, enc: torch.Tensor):
        """One decoder layer's cross-attention keys and values over the
        encoder's states, each (b, sk, kv, hd)."""
        cfg = self.cfg
        return tuple(split_heads(enc @ lp[name], cfg.n_kv_heads, cfg.resolved_head_dim)
                     for name in ("x_wk", "x_wv"))

    def _dec_pos(self, params, positions) -> torch.Tensor:
        """The learned decoder positions (an int, or a tensor of them),
        indexed modulo the table's 4096 rows (the assigned decode contexts
        exceed Whisper's trained 448, as in the reference)."""
        table = params["pos_embed_dec"]
        return replicated(lambda t: t[positions % t.shape[0]])(table).to(COMPUTE_DTYPE)

    def _cross_mlp(self, lp, x: torch.Tensor, enc_kv) -> torch.Tensor:
        """The decoder block after its self-attention: cross-attention over
        ``enc_kv``, then the MLP."""
        cfg = self.cfg
        h = shard_act(layer_norm(x, lp["ln_x_w"], lp["ln_x_b"]), WHOLE_SEQ)
        x = add_residual(x, self._attention(h, lp, causal=False, kv_override=enc_kv,
                                            prefix="x_"))
        return add_residual(x, gelu_mlp(shard_act(apply_norm(x, lp, cfg, "ln2"), WHOLE_SEQ),
                                        lp))

    def _block(self, lp, x: torch.Tensor, enc_kv, positions, window) -> torch.Tensor:
        """One decoder block over a whole sequence (no cache)."""
        h = shard_act(apply_norm(x, lp, self.cfg, "ln1"), WHOLE_SEQ)
        x = add_residual(x, self._attention(h, lp, positions=positions, causal=True,
                                            window=window))
        return self._cross_mlp(lp, x, enc_kv)

    def _layer(self, lp, x: torch.Tensor, enc: torch.Tensor, positions, window) -> torch.Tensor:
        """One decoder layer over a whole sequence, its cross-attention keys
        and values computed from the encoder's states."""
        return self._block(lp, x, self._enc_kv(lp, enc), positions, window)

    def forward(self, params, batch: Dict[str, torch.Tensor], remat: bool):
        cfg = self.cfg
        enc = self._encode(params, batch["frontend"])
        b, s = batch["tokens"].shape
        x = _embed(params, batch["tokens"])
        x = x + self._dec_pos(params, torch.arange(s, device=x.device))[None]
        x = shard_act(x, ("batch", "act_seq", "act_embed"))
        positions, window = _positions(b, s, x.device), effective_window(cfg, s)
        layer = rematerialised(self._layer, remat)
        for lp in unstack(params["decoder"]):
            x = layer(lp, x, enc, positions, window)
        return _final_norm(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)

    def cache_layout(self, batch_size: int, max_seq: int) -> Dict:
        cfg = self.cfg
        kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        self_kv = Leaf((cfg.n_layers, batch_size, _phys_len(cfg, max_seq), kv, hd), COMPUTE_DTYPE)
        enc_kv = Leaf((cfg.n_layers, batch_size, cfg.frontend_tokens, kv, hd), COMPUTE_DTYPE)
        return {"k": self_kv, "v": self_kv, "enc_k": enc_kv, "enc_v": enc_kv, "length": 0}

    def cache_axes(self):
        kv = ("layer", "batch", "cache_seq", "cache_kv_heads", "head_dim")
        return {"k": kv, "v": kv, "enc_k": kv, "enc_v": kv, "length": ()}

    def prefill(self, params, batch: Dict[str, torch.Tensor], max_seq: int):
        """Encode the audio, fill every decoder layer's cross-attention keys
        and values once, and prefill the decoder with the prompt tokens. A
        prompt longer than the cache keeps its last positions unrotated
        (the reference's layout, copied)."""
        cfg = self.cfg
        enc = self._encode(params, batch["frontend"])
        b, s = batch["tokens"].shape
        cache = _new_cache(self, b, max_seq, enc.device)
        x = _embed(params, batch["tokens"])
        x = x + self._dec_pos(params, torch.arange(s, device=x.device))[None]
        positions, window = _positions(b, s, x.device), effective_window(cfg, max_seq)
        phys = cache["k"].shape[2]
        enc_kvs = []
        for layer, lp in enumerate(unstack(params["decoder"])):
            enc_kv = self._enc_kv(lp, enc)
            enc_kvs.append(enc_kv)
            h = apply_norm(x, lp, cfg, "ln1")
            k, v = (split_heads(h @ lp[name], cfg.n_kv_heads, cfg.resolved_head_dim)[:, -phys:]
                    for name in ("wk", "wv"))
            cache["k"][layer, :, :k.shape[1]] = k
            cache["v"][layer, :, :v.shape[1]] = v
            x = self._block(lp, x, enc_kv, positions, window)
        # stacked whole, as in the reference: the frames may be fewer than
        # the config's frontend_tokens the empty cache was sized for
        cache["enc_k"] = torch.stack([k for k, _ in enc_kvs])
        cache["enc_v"] = torch.stack([v for _, v in enc_kvs])
        cache["length"] = s
        return _logits(params, _final_norm(params, x, cfg)[:, -1], cfg), cache

    def _dec_qkv(self, lp, x: torch.Tensor):
        """A decode step's self-attention projections of x (b, 1, d)."""
        h = apply_norm(x, lp, self.cfg, "ln1")
        return h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]

    def _dec_rest(self, lp, x: torch.Tensor, attn: torch.Tensor, enc_k: torch.Tensor,
                  enc_v: torch.Tensor) -> torch.Tensor:
        """A decode step's layer after its self-attention: the o projection,
        a residual, then ``_cross_mlp`` over the encoder's keys and values."""
        return self._cross_mlp(lp, x + attn @ lp["wo"], (enc_k, enc_v))

    def decode_step(self, params, token: torch.Tensor, cache: Dict, sparse_ctx=None):
        """Self-attention against the cache, cross-attention against the
        encoder's keys and values, the MLP; ``sparse_ctx`` is ignored."""
        cfg = self.cfg
        n_kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        length = cache["length"]
        x = _embed(params, token) + self._dec_pos(params, length)
        window = _decode_window(cfg, cache["k"].shape[2])
        for layer, lp in enumerate(unstack(params["decoder"])):
            # at the whole batch's row count on a data-split serve mesh
            # (whole_rows), but the self-attention over this rank's KV
            # cache, which it writes in place (its rows are independent)
            lk, lv = cache["k"][layer], cache["v"][layer]
            q, k, v = serve_mesh.whole_rows(functools.partial(self._dec_qkv, lp), x)
            nk, nv = project_kv_for_decode(k, v, n_kv, hd, length, None)
            cache_layer_update(lk, lv, nk, nv, length, window)
            attn = decode_attention(q, lk, lv, length + 1, cfg.n_heads, n_kv, hd, None, x.dtype,
                                    window)
            x = serve_mesh.whole_rows(functools.partial(self._dec_rest, lp), x, attn,
                                      local=(cache["enc_k"][layer], cache["enc_v"][layer]))
        cache["length"] = length + 1
        return _decode_logits(params, x, cfg), torch.zeros((), dtype=torch.float32,
                                                           device=x.device)


_FAMILIES = {"dense": _DecoderLM, "moe": _DecoderLM, "vlm": _DecoderLM, "hybrid": _Zamba,
             "ssm": _XLSTM, "audio": _Whisper}
