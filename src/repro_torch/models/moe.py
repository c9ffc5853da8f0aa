"""Mixture-of-Experts layer: top-k router + sort-based capacity dispatch
(the port's copy of ``repro.models.moe``, without the expert-parallel
``moe_ffn_ep``, which waits for the sharding slice).

Every expert computes over its ``capacity`` slots, empty slots zero, as in
the reference: the expert products are batched matmuls over all E experts
(``ecd,edf->ecf``), outside any kernel, as the reference leaves them to
XLA. Routing and dispatch follow the reference step by step so that, on
equal inputs, the same tokens go to the same slots and the same ones drop:

  * top-k is a stable descending sort (``jax.lax.top_k`` puts the lower
    expert id first on a tie; ``torch.topk`` leaves the order open);
  * assignments are grouped by expert with a stable argsort, ranked with
    ``searchsorted(side="left")``, and those ranked at or past the capacity
    drop (their buffer position is one past the buffer, a row that is cut
    off);
  * the combine adds each token's weighted contributions in the
    reference's update order (ascending expert id, rounding after each add
    in the compute dtype), with no atomics: a gather to (t, K, d) and a
    fixed-order sum, so the result is the same on every run.

Implements both MoE architectures the port serves:
  * olmoe-1b-7b:           64 experts, top-8, SwiGLU experts
  * llama4-scout-17b-a16e: 16 experts, top-1 + the always-on shared expert
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from .common import swish

DISPATCHES = ("scatter", "gather", "ep_shard_map")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int  # per-expert hidden
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4-style always-on shared expert
    router_aux_weight: float = 0.01
    # "scatter" (the reference's baseline) | "gather" (pure gathers with a
    # padded drop row) | "ep_shard_map" (expert parallel; without a mesh,
    # as here, it runs as "gather")
    dispatch: str = "scatter"

    def capacity(self, n_tokens: int) -> int:
        """Per-expert token capacity, padded to a multiple of 128 from 256
        up, and at least ``top_k``."""
        c = math.ceil(n_tokens * self.top_k * self.capacity_factor / self.n_experts)
        if c >= 256:
            c = -(-c // 128) * 128
        return max(c, self.top_k)


def moe_param_shapes(cfg: MoEConfig) -> Dict[str, Tuple[tuple, float]]:
    """{name: (shape, init std)} of one layer's MoE params: the reference's
    ``ParamDef``s (router std 0.02; the experts fan-in normal, the fan-in
    being the second-to-last dim)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    shapes = {
        "router": ((d, e), 0.02),
        "we_gate": ((e, d, f), 1.0 / math.sqrt(d)),
        "we_up": ((e, d, f), 1.0 / math.sqrt(d)),
        "we_down": ((e, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.shared_expert:
        shapes.update({
            "ws_gate": ((d, f), 1.0 / math.sqrt(d)),
            "ws_up": ((d, f), 1.0 / math.sqrt(d)),
            "ws_down": ((f, d), 1.0 / math.sqrt(f)),
        })
    return shapes


def route(xt: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """Router of t tokens xt (t, d): (probs (t, E) f32, top_w (t, K) f32
    normalised, top_e (t, K) int64), top-k with ties to the lower expert."""
    logits = (xt @ router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, : cfg.top_k], top_e[:, : cfg.top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_e


def dispatch_plan(top_e: torch.Tensor, cap: int, n_experts: int):
    """Group the t·K assignments by expert (stable): (order (t·K,) int64,
    keep (t·K,) bool, buf_pos (t·K,) int64) in sorted order; buf_pos =
    expert · cap + rank for a kept assignment, E · cap (one past the
    buffer) for a dropped one."""
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.searchsorted(se, torch.arange(n_experts, device=se.device), side="left")
    rank = torch.arange(se.numel(), device=se.device) - first[se]
    keep = rank < cap
    buf_pos = torch.where(keep, se * cap + rank, torch.full_like(se, n_experts * cap))
    return order, keep, buf_pos


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: MoEConfig,
            prefix: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) → (y (b, s, d) in x's dtype, the router's load-balance
    aux loss, a 0-d f32 tensor). The capacity is computed over the call's
    own b·s tokens."""
    if cfg.dispatch not in DISPATCHES:
        raise ValueError(f"moe dispatch must be one of {DISPATCHES}, got {cfg.dispatch!r}")
    p = prefix
    e, k = cfg.n_experts, cfg.top_k
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)
    probs, top_w, top_e = route(xt, params[f"{p}router"], cfg)

    # Switch-style load-balance auxiliary loss
    me = probs.mean(dim=0)
    assign = torch.zeros((t, e), dtype=torch.float32, device=dev)
    assign.scatter_add_(1, top_e, torch.ones_like(top_w))
    ce = assign.mean(dim=0) / k
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight

    cap = cfg.capacity(t)
    order, keep, buf_pos = dispatch_plan(top_e, cap, e)
    st = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)[order]
    sw = top_w.reshape(-1)[order]

    if cfg.dispatch == "scatter":
        # dropped rows land on the extra last row, which is cut off
        x_buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
        x_buf[buf_pos] = xt[st]
    else:  # gather (and ep_shard_map without a mesh)
        # the token in each expert slot (t = empty → the zero pad row)
        slot_tok = torch.full((e * cap + 1,), t, dtype=torch.int64, device=dev)
        slot_tok[buf_pos] = st
        x_buf = torch.cat([xt, xt.new_zeros((1, d))])[slot_tok]
    x_buf = x_buf[:-1].reshape(e, cap, d)

    gate = torch.bmm(x_buf, params[f"{p}we_gate"])
    up = torch.bmm(x_buf, params[f"{p}we_up"])
    y_buf = torch.bmm(swish(gate) * up, params[f"{p}we_down"]).reshape(e * cap, d)

    # combine: each assignment's output, weighted (in the compute dtype);
    # then per token its K contributions in sorted (ascending expert) order
    contrib = y_buf[torch.clamp(buf_pos, max=e * cap - 1)]
    contrib = contrib * (sw * keep.to(torch.float32))[:, None].to(contrib.dtype)
    slot_of = torch.empty_like(order)
    slot_of[order] = torch.arange(order.numel(), device=dev)  # assignment → sorted position
    pos = torch.sort(slot_of.reshape(t, k), dim=1).values  # each token's, in sorted order
    parts = contrib.to(x.dtype)[pos]  # (t, K, d)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]

    if cfg.shared_expert:
        sh = swish(xt @ params[f"{p}ws_gate"]) * (xt @ params[f"{p}ws_up"])
        y = y + sh @ params[f"{p}ws_down"]
    return y.reshape(b, s, d), aux
