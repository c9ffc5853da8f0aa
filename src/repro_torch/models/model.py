"""Model builder of the port: the decoder LM of the dense, mixture-of-experts
and early-fusion VLM families (the reference's ``_DecoderLM`` of
``repro.models.model``): RMSNorm or LayerNorm with biases, a SwiGLU or a
non-gated gelu MLP with biases or a MoE layer (``models/moe.py``; with a
shared expert, and with a projector for an early-fusion MoE such as
Llama-4-Scout), a separate or a tied head (``embed.T``). The SSM, hybrid
and audio families raise until their slice lands (ROADMAP.md, queue 1).

    model.init(seed, device)                       -> params (stacked leaves)
    model.init_cache(b, max_seq, device)           -> linear KV cache (rotating
        past WINDOW_ENGAGE_THRESHOLD positions: ``effective_window``)
    model.init_paged_cache(b, max_seq, page_tokens, n_pages, device)
                                                   -> paged KV cache
    model.forward(params, batch)                   -> hidden
    model.final_norm(params, x), model.logits(params, hidden)
                                                   -> the norm after the last layer,
                                                      hidden @ head (embed.T when tied)
    model.prefill(params, batch, max_seq)          -> (last_logits, cache)
        (prompts over 2048 positions, a VLM's vision tokens included, take
        the blockwise attention, as in the reference)
    model.append_embeds(params, frame, cache, sparse_ctx, device)
                                                   -> (hidden, io)
    model.decode_step_planned(params, token, cache, sparse_ctx, plan, refresh)
                                                   -> (logits, io (L,))
        (the cache's ``length`` is a host int, or an int32 (b,) tensor of
        per-slot lengths in slot mode, where the cache may be paged)

A batch is {"tokens": (b, s_text)} plus, for a VLM, {"frontend": (b,
n_front, d_frontend)}: the projected frontend embeddings come first in the
residual stream (early fusion: [vision | text]).

Weights are made on the target device from a seeded ``torch.Generator``
with the reference's init scales (fan-in normal, 0.02 for the embedding
and head); JAX's PRNG is not recreated — parity tests carry the
reference's params over with ``models/convert.py``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from .attention import CacheSpec, init_kv_cache, init_paged_kv_cache
from .common import layer_norm, rms_norm
from .moe import moe_param_shapes
from .transformer import moe_cfg_of, stack_append, stack_decode, stack_forward, stack_prefill

COMPUTE_DTYPE = torch.bfloat16

# sliding windows engage only for ultra-long decode, as in the reference;
# read at call time (tests lower it to reach the rotating cache cheaply)
WINDOW_ENGAGE_THRESHOLD = 65_536


def effective_window(cfg: ModelConfig, seq_len: int) -> Optional[int]:
    """The sliding window a sequence (or cache) of ``seq_len`` positions
    runs with: the config's, past ``WINDOW_ENGAGE_THRESHOLD``, else None."""
    if cfg.sliding_window and seq_len > WINDOW_ENGAGE_THRESHOLD:
        return cfg.sliding_window
    return None


class Model:
    """Decoder LM over a params dict {embed, final_norm_w (and _b for
    LayerNorm), head (absent when tied), projector (VLM only), layers:
    {name: (L, ...)}}."""

    def __init__(self, cfg: ModelConfig):
        if cfg.arch_type not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"repro_torch serves the dense, MoE and early-fusion VLM decoders only; "
                f"{cfg.name} ({cfg.arch_type}) lands in a later slice — see ROADMAP.md, "
                "queue 1"
            )
        self.cfg = cfg
        self.family = cfg.arch_type
        self.has_frontend = bool(cfg.d_frontend)

    @property
    def text_offset(self) -> int:
        """Where the token-aligned hidden states start (after the vision
        prefix of a VLM prompt)."""
        return self.cfg.frontend_tokens if self.has_frontend else 0

    def param_shapes(self) -> Dict[str, tuple]:
        """{name: (shape, init std, 'ones' or 'zeros')} with layer leaves
        stacked: LayerNorm's biases beside its weights, the gelu family's
        w_fc/b_fc/w_proj/b_proj in place of gate/up/down, a MoE layer's
        router/we_gate/we_up/we_down (and ws_gate/ws_up/ws_down with the
        shared expert) in place of the MLP, no head when the embeddings are
        tied."""
        c = self.cfg
        d, f, n_l = c.d_model, c.d_ff, c.n_layers
        hd_all = c.n_heads * c.resolved_head_dim
        kv_all = c.n_kv_heads * c.resolved_head_dim
        shapes = {
            "embed": ((c.vocab_size, d), 0.02),
            "final_norm_w": ((d,), "ones"),
            "layers/ln1_w": ((n_l, d), "ones"),
            "layers/ln2_w": ((n_l, d), "ones"),
            "layers/wq": ((n_l, d, hd_all), 1.0 / math.sqrt(d)),
            "layers/wk": ((n_l, d, kv_all), 1.0 / math.sqrt(d)),
            "layers/wv": ((n_l, d, kv_all), 1.0 / math.sqrt(d)),
            "layers/wo": ((n_l, hd_all, d), 1.0 / math.sqrt(hd_all)),
        }
        if c.norm == "layernorm":
            shapes.update({"final_norm_b": ((d,), "zeros"), "layers/ln1_b": ((n_l, d), "zeros"),
                           "layers/ln2_b": ((n_l, d), "zeros")})
        if c.has_moe:
            shapes.update({f"layers/{name}": ((n_l,) + shape, std)
                           for name, (shape, std) in moe_param_shapes(moe_cfg_of(c)).items()})
        elif c.mlp == "gelu":
            shapes.update({"layers/w_fc": ((n_l, d, f), 1.0 / math.sqrt(d)),
                           "layers/b_fc": ((n_l, f), "zeros"),
                           "layers/w_proj": ((n_l, f, d), 1.0 / math.sqrt(f)),
                           "layers/b_proj": ((n_l, d), "zeros")})
        else:
            shapes.update({"layers/w_gate": ((n_l, d, f), 1.0 / math.sqrt(d)),
                           "layers/w_up": ((n_l, d, f), 1.0 / math.sqrt(d)),
                           "layers/w_down": ((n_l, f, d), 1.0 / math.sqrt(f))})
        if not c.tie_embeddings:
            shapes["head"] = ((d, c.vocab_size), 0.02)
        if self.has_frontend:
            shapes["projector"] = ((c.d_frontend, d), 1.0 / math.sqrt(c.d_frontend))
        return shapes

    def init(self, seed: int = 0, device=None) -> Dict:
        """Random weights on ``device`` (default ``cuda``; no card raises)
        from a seeded generator. A stacked leaf is drawn layer by layer, so
        the f32 transient is one layer's (an (8, 8192, 28672) leaf of
        InternVL2-76B would take 7.5 GB at once)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        params: Dict = {"layers": {}}
        for name, (shape, std) in sorted(self.param_shapes().items()):
            top, _, sub = name.partition("/")
            if std in ("ones", "zeros"):
                fill = torch.ones if std == "ones" else torch.zeros
                leaf = fill(shape, dtype=COMPUTE_DTYPE, device=device)
            elif sub:
                leaf = torch.empty(shape, dtype=COMPUTE_DTYPE, device=device)
                for layer in range(shape[0]):
                    leaf[layer] = torch.randn(shape[1:], generator=gen, device=device) * std
            else:
                leaf = (torch.randn(shape, generator=gen, device=device) * std).to(COMPUTE_DTYPE)
            if sub:
                params[top][sub] = leaf
            else:
                params[top] = leaf
        return params

    def init_cache(self, batch_size: int, max_seq: int, device=None) -> Dict:
        """A linear KV cache of ``max_seq`` positions, or past the window
        threshold a rotating one of ``min(max_seq, sliding_window)``."""
        device = resolve_device(device)
        cfg = self.cfg
        spec = CacheSpec(batch=batch_size, max_seq=max_seq, n_kv_heads=cfg.n_kv_heads,
                         head_dim=cfg.resolved_head_dim, window=effective_window(cfg, max_seq))
        return init_kv_cache(spec, cfg.n_layers, COMPUTE_DTYPE, device)

    @property
    def supports_paged_kv(self) -> bool:
        """Every family the port serves (the decoder LMs) takes a paged cache."""
        return True

    def init_paged_cache(self, batch_size: int, max_seq: int, page_tokens: int, n_pages: int,
                         device=None) -> Dict:
        """The paged twin of ``init_cache`` (``attention.init_paged_kv_cache``):
        ``n_pages`` pages of ``page_tokens`` positions per layer, a per-slot
        page table and per-slot lengths, on ``device`` (default ``cuda``).
        Refuses a ``max_seq`` that pages do not tile, and sliding windows."""
        device = resolve_device(device)
        cfg = self.cfg
        if max_seq % page_tokens != 0:
            raise ValueError(f"max_seq ({max_seq}) must be divisible by page_tokens "
                             f"({page_tokens})")
        if effective_window(cfg, max_seq):
            raise ValueError("paged KV does not compose with sliding windows")
        return init_paged_kv_cache(n_pages, page_tokens, batch_size, max_seq // page_tokens,
                                   cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers,
                                   COMPUTE_DTYPE, device)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.to(torch.int64)].to(COMPUTE_DTYPE)

    def _embed_input(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The residual stream of a prompt: [frontend @ projector | embed
        (tokens)] for a VLM, the token embeddings otherwise."""
        x = self._embed(params, batch["tokens"])
        if self.has_frontend:
            front = batch["frontend"].to(COMPUTE_DTYPE)
            x = torch.cat([front @ params["projector"].to(COMPUTE_DTYPE), x], dim=1)
        return x

    def forward(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Dense forward over a whole sequence, no cache: the final-normed
        hidden states (b, s, d) (the reference also returns the MoE
        auxiliary loss, which serving drops; ``moe.moe_ffn`` returns it).
        Past the window threshold the attention is windowed."""
        x = self._embed_input(params, batch)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x = stack_forward(params["layers"], x, self.cfg, positions,
                          effective_window(self.cfg, s))
        return self.final_norm(params, x)

    def final_norm(self, params, x: torch.Tensor) -> torch.Tensor:
        """The norm after the last layer: LayerNorm (weight and bias) or
        RMSNorm, by the config's ``norm``."""
        if self.cfg.norm == "layernorm":
            return layer_norm(x, params["final_norm_w"], params["final_norm_b"])
        return rms_norm(x, params["final_norm_w"])

    def logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        """hidden (..., d) @ the LM head (d, vocab), in hidden's dtype; the
        head is ``embed.T`` when the embeddings are tied."""
        head = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        return hidden @ head.to(hidden.dtype)

    def prefill(self, params, batch: Dict[str, torch.Tensor], max_seq: int):
        """Dense forward over the prompt. Returns (last-position logits
        (b, vocab) in the compute dtype, a freshly filled cache). A prompt
        longer than ``attention.BLOCKWISE_THRESHOLD`` positions (vision
        tokens included) takes the blockwise attention. Past the window
        threshold (of ``max_seq``) the attention is windowed and the cache
        rotating: it keeps the prompt's last ``sliding_window`` positions."""
        x = self._embed_input(params, batch)
        b, s, _ = x.shape
        if s > max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
        cache = self.init_cache(b, max_seq, x.device)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x = stack_prefill(params["layers"], x, self.cfg, positions, cache,
                          effective_window(self.cfg, max_seq))
        return self.logits(params, self.final_norm(params, x)[:, -1]), cache

    def append_embeds(self, params, frame_embeds: torch.Tensor, cache: Dict,
                      sparse_ctx=None, device=None):
        """One frame of patch embeddings (b, n, d_frontend) → projector →
        an n-token extension of every layer's cache (the paper's frame
        append, §2.1), on ``device`` (default ``cuda``; no card raises).
        Without a projector the embeddings enter the stack as they are.
        ``cache`` updates in place. Returns (final-normed hidden (b, n, d),
        io: the frame's estimated I/O seconds, a scalar tensor)."""
        x = frame_embeds.to(resolve_device(device)).to(COMPUTE_DTYPE)
        if "projector" in params:
            x = x @ params["projector"].to(COMPUTE_DTYPE)
        x, io = stack_append(params["layers"], x, cache, self.cfg, sparse_ctx)
        return self.final_norm(params, x), io

    def decode_step_planned(self, params, token: torch.Tensor, cache: Dict,
                            sparse_ctx=None, plan: Optional[Dict] = None,
                            refresh: bool = True):
        """One greedy-decode step: token (b, 1) → (logits (b, vocab) f32,
        io (L,) per-layer I/O estimates). ``cache`` and ``plan`` update in
        place; ``refresh`` (host bool) selects recompute vs reuse of the
        chunk plan. The window is read off the cache, as in the reference:
        a dense cache whose physical length equals ``sliding_window``
        rotates; a paged one never does."""
        cfg = self.cfg
        window = None
        if "page_table" not in cache and cfg.sliding_window \
                and cache["k"].shape[2] == cfg.sliding_window:
            window = cfg.sliding_window
        x = self._embed(params, token)
        x, io = stack_decode(params["layers"], x, cache, cfg, sparse_ctx, plan, refresh, window)
        return self.logits(params, self.final_norm(params, x)[:, 0]).to(torch.float32), io


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
