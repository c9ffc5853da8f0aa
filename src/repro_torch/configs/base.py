"""ModelConfig: the port's copy of ``repro.configs.base``.

Only the fields the served and trained families read are kept;
``reduced()`` derives the same smoke-test variant as the reference (2
layers, d_model ≤ 256, ≤ 4 heads, ≤ 4 experts of top-k ≤ 2 at capacity
factor 8, the SSM and encoder widths cut by the reference's rules; ``remat``
carried as it is).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | vlm | hybrid | ssm | audio
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
    # Mamba2 (the hybrid family): state width, conv taps, inner expansion
    # and head width; the shared attention block follows every
    # ``attn_every`` Mamba2 layers
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0
    # xLSTM: the blocks that are sLSTM (the rest mLSTM)
    slstm_layers: Tuple[int, ...] = ()
    # rotating-window KV cache, engaged past WINDOW_ENGAGE_THRESHOLD
    # positions (models/model.py); reduced() keeps it
    sliding_window: Optional[int] = None
    # VLM frontend: the vision embedding width fed to the projector, and the
    # tokens of one frame; for the audio encoder-decoder the frame width and
    # the encoder's positions, and its depth
    d_frontend: int = 0
    frontend_tokens: int = 0
    encoder_layers: int = 0
    # training: rematerialise each layer's activations in the backward
    # (``torch.utils.checkpoint``) instead of keeping them
    remat: bool = True
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def has_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.arch_type == "audio"

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: 2 layers, d_model ≤ 256,
        ≤ 4 heads, d_ff scaled with d_model, ≤ 4 experts with top-k ≤ 2 at
        capacity factor 8.0, d_frontend ≤ 64 and ≤ 16 frontend tokens, SSM
        heads ≤ 32 wide with a state ≤ 16, a shared attention block after
        every layer, one sLSTM block (the second) and ≤ 2 encoder layers
        (the reference's rules)."""
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
            ssm_head_dim=min(self.ssm_head_dim, 32) if self.ssm_state else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            attn_every=min(self.attn_every, 1) if self.attn_every else 0,
            slstm_layers=(tuple(i for i in self.slstm_layers if i < 2)
                          or ((1,) if self.slstm_layers else ())),
            d_frontend=min(self.d_frontend, 64) if self.d_frontend else 0,
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
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
