"""Model builder of the port: the decoder LM of the dense and early-fusion
VLM families (the reference's ``_DecoderLM`` of ``repro.models.model``).
Other families raise until their slice lands (ROADMAP.md, queue 1).

    model.init(seed, device)                       -> params (stacked leaves)
    model.forward(params, batch)                   -> hidden
    model.prefill(params, batch, max_seq)          -> (last_logits, cache)
        (prompts over 2048 positions, a VLM's vision tokens included, take
        the blockwise attention, as in the reference)
    model.append_embeds(params, frame, cache, sparse_ctx, device)
                                                   -> (hidden, io)
    model.decode_step_planned(params, token, cache, sparse_ctx, plan, refresh)
                                                   -> (logits, io (L,))

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
from .attention import CacheSpec, init_kv_cache
from .common import rms_norm
from .transformer import stack_append, stack_decode, stack_forward, stack_prefill

COMPUTE_DTYPE = torch.bfloat16

# sliding windows engage only for ultra-long decode in the reference
WINDOW_ENGAGE_THRESHOLD = 65_536


class Model:
    """Decoder LM over a params dict {embed, final_norm_w, head, projector
    (VLM only), layers: {name: (L, ...)}}."""

    def __init__(self, cfg: ModelConfig):
        if cfg.arch_type not in ("dense", "vlm") or cfg.has_moe or cfg.mlp != "swiglu" \
                or cfg.norm != "rmsnorm" or cfg.tie_embeddings:
            raise NotImplementedError(
                f"repro_torch serves the dense and early-fusion VLM SwiGLU/RMSNorm "
                f"decoders only; {cfg.name} ({cfg.arch_type}) lands in a later slice — "
                "see ROADMAP.md, queue 1"
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
        """{name: (shape, init std or 'ones')} with layer leaves stacked."""
        c = self.cfg
        d, f, n_l = c.d_model, c.d_ff, c.n_layers
        hd_all = c.n_heads * c.resolved_head_dim
        kv_all = c.n_kv_heads * c.resolved_head_dim
        shapes = {
            "embed": ((c.vocab_size, d), 0.02),
            "final_norm_w": ((d,), "ones"),
            "head": ((d, c.vocab_size), 0.02),
            "layers/ln1_w": ((n_l, d), "ones"),
            "layers/ln2_w": ((n_l, d), "ones"),
            "layers/wq": ((n_l, d, hd_all), 1.0 / math.sqrt(d)),
            "layers/wk": ((n_l, d, kv_all), 1.0 / math.sqrt(d)),
            "layers/wv": ((n_l, d, kv_all), 1.0 / math.sqrt(d)),
            "layers/wo": ((n_l, hd_all, d), 1.0 / math.sqrt(hd_all)),
            "layers/w_gate": ((n_l, d, f), 1.0 / math.sqrt(d)),
            "layers/w_up": ((n_l, d, f), 1.0 / math.sqrt(d)),
            "layers/w_down": ((n_l, f, d), 1.0 / math.sqrt(f)),
        }
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
            if std == "ones":
                leaf = torch.ones(shape, dtype=COMPUTE_DTYPE, device=device)
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
        device = resolve_device(device)
        cfg = self.cfg
        if cfg.sliding_window and max_seq > WINDOW_ENGAGE_THRESHOLD:
            raise NotImplementedError("rotating-window KV caches are not ported yet")
        spec = CacheSpec(batch=batch_size, max_seq=max_seq, n_kv_heads=cfg.n_kv_heads,
                         head_dim=cfg.resolved_head_dim)
        return init_kv_cache(spec, cfg.n_layers, COMPUTE_DTYPE, device)

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
        hidden states (b, s, d) (the reference also returns a MoE auxiliary
        loss; the port serves no MoE)."""
        x = self._embed_input(params, batch)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x = stack_forward(params["layers"], x, self.cfg, positions)
        return rms_norm(x, params["final_norm_w"])

    def prefill(self, params, batch: Dict[str, torch.Tensor], max_seq: int):
        """Dense forward over the prompt. Returns (last-position logits
        (b, vocab) in the compute dtype, a freshly filled cache). A prompt
        longer than ``attention.BLOCKWISE_THRESHOLD`` positions (vision
        tokens included) takes the blockwise attention."""
        x = self._embed_input(params, batch)
        b, s, _ = x.shape
        if s > max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
        cache = self.init_cache(b, max_seq, x.device)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x = stack_prefill(params["layers"], x, self.cfg, positions, cache)
        x = rms_norm(x, params["final_norm_w"])
        return x[:, -1] @ params["head"].to(x.dtype), cache

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
        return rms_norm(x, params["final_norm_w"]), io

    def decode_step_planned(self, params, token: torch.Tensor, cache: Dict,
                            sparse_ctx=None, plan: Optional[Dict] = None,
                            refresh: bool = True):
        """One greedy-decode step: token (b, 1) → (logits (b, vocab) f32,
        io (L,) per-layer I/O estimates). ``cache`` and ``plan`` update in
        place; ``refresh`` (host bool) selects recompute vs reuse of the
        chunk plan."""
        x = self._embed(params, token)
        x, io = stack_decode(params["layers"], x, cache, self.cfg, sparse_ctx, plan, refresh)
        x = rms_norm(x, params["final_norm_w"])
        logits = (x[:, 0] @ params["head"].to(x.dtype)).to(torch.float32)
        return logits, io


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
