"""ModelConfig: the port's copy of ``repro.configs.base``.

Only the fields the served families read are kept; ``reduced()`` derives
the same smoke-test variant as the reference (2 layers, d_model ≤ 256,
≤ 4 heads, ≤ 4 experts of top-k ≤ 2 at capacity factor 8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | vlm (the families this port serves so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope_theta: Optional[float] = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False  # the head is embed.T
    # MoE: experts, routed experts a token, per-expert capacity factor, the
    # always-on shared expert, and the dispatch (scatter | gather;
    # ep_shard_map runs as gather without a mesh)
    n_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_shared_expert: bool = False
    moe_dispatch: str = "scatter"
    # rotating-window KV cache, engaged past WINDOW_ENGAGE_THRESHOLD
    # positions (models/model.py); reduced() keeps it
    sliding_window: Optional[int] = None
    # VLM frontend: the vision embedding width fed to the projector, and the
    # tokens of one frame
    d_frontend: int = 0
    frontend_tokens: int = 0
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def has_moe(self) -> bool:
        return self.n_experts > 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: 2 layers, d_model ≤ 256,
        ≤ 4 heads, d_ff scaled with d_model, ≤ 4 experts with top-k ≤ 2 at
        capacity factor 8.0, d_frontend ≤ 64 and ≤ 16 frontend tokens (the
        reference's rule)."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        scale = d_model / self.d_model
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=max(64, int(self.d_ff * scale)) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_capacity_factor=8.0 if self.n_experts else self.moe_capacity_factor,
            d_frontend=min(self.d_frontend, 64) if self.d_frontend else 0,
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One workload geometry (prompt length × batch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"
