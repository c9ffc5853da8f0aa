"""Mixture-of-Experts layer: top-k router + sort-based capacity dispatch,
and the expert-parallel ``moe_ffn_ep`` over ``all_to_all`` (the port's copy
of ``repro.models.moe``).

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

from ..sharding import serve as serve_mesh  # its row_split, read at call time
from ..sharding.specs import MeshRules, current_rules, local_shard, mesh_placements, \
    replicated, shard_act, wrap_local
from .common import swish

DISPATCHES = ("scatter", "gather", "ep_shard_map")

# None, or a list to which every MoE call appends its dropped assignments
# (over capacity; a 0-d int64 tensor on the device, this rank's), read by
# the caller after the step: nothing syncs with the host here
DROP_LOG = None


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
    # padded drop row) | "ep_shard_map" (expert parallel under installed
    # mesh rules; without them it runs as "gather")
    dispatch: str = "scatter"

    def capacity(self, n_tokens: int) -> int:
        """Per-expert token capacity, padded to a multiple of 128 from 256
        up, and at least ``top_k``."""
        c = math.ceil(n_tokens * self.top_k * self.capacity_factor / self.n_experts)
        if c >= 256:
            c = -(-c // 128) * 128
        return max(c, self.top_k)


def moe_param_shapes(cfg: MoEConfig) -> Dict[str, Tuple[tuple, float, tuple]]:
    """{name: (shape, init std, logical axes)} of one layer's MoE params:
    the reference's ``ParamDef``s (router std 0.02; the experts fan-in
    normal, the fan-in being the second-to-last dim)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    shapes = {
        "router": ((d, e), 0.02, ("embed", None)),
        "we_gate": ((e, d, f), 1.0 / math.sqrt(d), ("expert", "embed", "ffn")),
        "we_up": ((e, d, f), 1.0 / math.sqrt(d), ("expert", "embed", "ffn")),
        "we_down": ((e, f, d), 1.0 / math.sqrt(f), ("expert", "ffn", "embed")),
    }
    if cfg.shared_expert:
        shapes.update({
            "ws_gate": ((d, f), 1.0 / math.sqrt(d), ("embed", "ffn")),
            "ws_up": ((d, f), 1.0 / math.sqrt(d), ("embed", "ffn")),
            "ws_down": ((f, d), 1.0 / math.sqrt(f), ("ffn", "embed")),
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


def _dispatch(xt: torch.Tensor, router: torch.Tensor, cfg: MoEConfig, cap: int):
    """Route t tokens xt (t, d) and fill the expert buffer: (x_buf (E, cap,
    d), the load-balance aux loss, sw (t·K,) the sorted assignments'
    weights, (order, keep, buf_pos) the dispatch plan)."""
    e, k = cfg.n_experts, cfg.top_k
    t, d = xt.shape
    dev = xt.device
    probs, top_w, top_e = route(xt, router, cfg)

    # Switch-style load-balance auxiliary loss
    me = probs.mean(dim=0)
    assign = torch.zeros((t, e), dtype=torch.float32, device=dev)
    assign.scatter_add_(1, top_e, torch.ones_like(top_w))
    ce = assign.mean(dim=0) / k
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight

    order, keep, buf_pos = dispatch_plan(top_e, cap, e)
    if DROP_LOG is not None:
        DROP_LOG.append((~keep).sum())
    st = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)[order]
    sw = top_w.reshape(-1)[order]
    if cfg.dispatch == "scatter":
        # dropped rows land on the extra last row, which is cut off
        x_buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=dev)
        x_buf[buf_pos] = xt[st]
    else:  # gather (and ep_shard_map without a mesh)
        # the token in each expert slot (t = empty → the zero pad row)
        slot_tok = torch.full((e * cap + 1,), t, dtype=torch.int64, device=dev)
        slot_tok[buf_pos] = st
        x_buf = torch.cat([xt, xt.new_zeros((1, d))])[slot_tok]
    return x_buf[:-1].reshape(e, cap, d), aux, sw, order, keep, buf_pos


def _combine(y_buf: torch.Tensor, sw: torch.Tensor, order: torch.Tensor, keep: torch.Tensor,
             buf_pos: torch.Tensor, t: int, k: int, dtype) -> torch.Tensor:
    """Each assignment's output weighted (in the compute dtype); then per
    token its K contributions added in sorted (ascending expert) order:
    (t, d) in ``dtype``."""
    e, cap, d = y_buf.shape
    y_flat = y_buf.reshape(e * cap, d)
    contrib = y_flat[torch.clamp(buf_pos, max=e * cap - 1)]
    contrib = contrib * (sw * keep.to(torch.float32))[:, None].to(contrib.dtype)
    slot_of = torch.empty_like(order)
    slot_of[order] = torch.arange(order.numel(), device=order.device)  # assignment → sorted
    pos = torch.sort(slot_of.reshape(t, k), dim=1).values  # each token's, in sorted order
    parts = contrib.to(dtype)[pos]  # (t, K, d)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    return y


def _shared_expert(xt: torch.Tensor, params: Dict[str, torch.Tensor], p: str) -> torch.Tensor:
    return (swish(xt @ params[f"{p}ws_gate"]) * (xt @ params[f"{p}ws_up"])) @ params[f"{p}ws_down"]


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: MoEConfig,
            prefix: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) → (y (b, s, d) in x's dtype, the router's load-balance
    aux loss, a 0-d f32 tensor). The capacity is computed over the call's
    own b·s tokens. ``ep_shard_map`` runs ``moe_ffn_ep`` under installed
    mesh rules and the ``gather`` dispatch without them, as in the
    reference. Under rules the routing and the combine run replicated
    (``sharding.specs.replicated``: DTensor has no strategy for their
    sorts and index writes) and the expert buffers take their logical
    layout ("expert" over 'model', "expert_capacity" over the data axes).

    On a serve mesh whose data ranks each hold some rows of the batch
    (``sharding.serve.row_split``), the call's tokens are the whole
    batch's: the rows are gathered over ``data`` in rank order, routed and
    computed as the 1×1 mesh does, and this rank keeps its own rows, so a
    rank's rows never change another row's capacity, drops or arithmetic."""
    if cfg.dispatch not in DISPATCHES:
        raise ValueError(f"moe dispatch must be one of {DISPATCHES}, got {cfg.dispatch!r}")
    split = serve_mesh.row_split()
    if split is not None and current_rules() is None:
        y, aux = _moe_ffn(split.replicate(x), params, cfg, prefix)
        return split.put_batch(y), aux
    return _moe_ffn(x, params, cfg, prefix)


def _moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: MoEConfig,
             prefix: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` over the call's own rows."""
    if cfg.dispatch == "ep_shard_map":
        if current_rules() is not None:
            return moe_ffn_ep(x, params, cfg, prefix)
        cfg = dataclasses.replace(cfg, dispatch="gather")
    p = prefix
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    x_buf, aux, sw, order, keep, buf_pos = replicated(
        lambda xt_, router: _dispatch(xt_, router, cfg, cfg.capacity(t)))(
        xt, params[f"{p}router"])
    x_buf = shard_act(x_buf, ("expert", "expert_capacity", "act_embed"))
    gate = torch.bmm(x_buf, params[f"{p}we_gate"])
    up = torch.bmm(x_buf, params[f"{p}we_up"])
    h = shard_act(swish(gate) * up, ("expert", "expert_capacity", "ffn"))
    y_buf = shard_act(torch.bmm(h, params[f"{p}we_down"]),
                      ("expert", "expert_capacity", "act_embed"))
    y = replicated(lambda yb, w: _combine(yb, w, order, keep, buf_pos, t, cfg.top_k, x.dtype))(
        y_buf, sw)
    if cfg.shared_expert:
        y = y + _shared_expert(xt, params, p)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# expert parallelism: all_to_all over the model axis
# ---------------------------------------------------------------------------

# all_to_all_single launches of the expert-parallel MoE, forward and
# backward (the tests and the chip check read it: zero means the gather
# fallback ran)
ALL_TO_ALL_COUNT = {"forward": 0, "backward": 0}


class _AllToAll(torch.autograd.Function):
    """Equal-split ``all_to_all_single`` over dim 0 in a process group; its
    gradient is the same exchange backwards."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _exchange(x, group, "forward")

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _exchange(grad, ctx.group, "backward"), None


def _exchange(x: torch.Tensor, group, direction: str) -> torch.Tensor:
    import torch.distributed as dist

    ALL_TO_ALL_COUNT[direction] += 1
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Rank r's i-th of ``group.size()`` equal blocks of ``x`` (dim 0) goes
    to rank i, which keeps them in rank order (``jax.lax.all_to_all`` with
    ``split_axis = concat_axis = 0, tiled``); differentiable."""
    return _AllToAll.apply(x, group)


def _first_of(sorted_keys: torch.Tensor, n: int) -> torch.Tensor:
    """searchsorted(side="left") of 0..n-1 in ascending ``sorted_keys``."""
    return torch.searchsorted(sorted_keys, torch.arange(n, device=sorted_keys.device),
                              side="left")


def _scatter_drop(n: int, fill: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """A (n,) int64 vector of ``fill`` with ``values`` written at ``index``;
    an index of n or more is dropped (``.at[].set(mode="drop")``)."""
    out = torch.full((n + 1,), fill, dtype=torch.int64, device=index.device)
    out[torch.clamp(index, max=n)] = values.to(torch.int64)
    return out[:n]


def moe_ffn_ep(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: MoEConfig,
               prefix: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism with hand-written dispatch and return
    ``all_to_all``s over 'model' (the reference's ``moe_ffn_ep``, its
    ``shard_map`` as this rank's local block of the DTensors).

    The t tokens split over (data axes, 'model'), t_dev a rank; the
    experts over 'model', E/ep a rank. Each rank routes its tokens, groups
    its assignments by destination shard into ``c_send`` slots a shard
    (dropping past it), and three all_to_alls move the token rows and their
    local expert ids out and the results home. The receiving rank groups
    what it got by local expert into ``c_recv`` slots an expert (dropping
    past it) and runs its experts. The aux loss takes its two means over
    all token shards. Falls back to ``gather`` where the geometry does not
    divide (E % ep, b % dp or s % ep), as the reference does. Needs
    installed rules."""
    rules = current_rules()
    mesh = rules.mesh
    ep = rules.axis_size("model")
    dp_axis = rules.rules.get("batch")
    dp = rules.axis_size(dp_axis)
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    if e % ep or b % dp or s % ep:
        return moe_ffn(x, params, dataclasses.replace(cfg, dispatch="gather"), prefix)
    p = prefix
    e_loc = e // ep
    t_dev = t // (dp * ep)
    c_send = max(k, math.ceil(t_dev * k * cfg.capacity_factor / ep))
    c_recv = max(k, math.ceil(ep * c_send * cfg.capacity_factor / e_loc))
    group = mesh.get_group("model")
    tok_axes = MeshRules._axis_names(dp_axis) + ("model",)
    tok_pl = mesh_placements(mesh, {tok_axes: 0})
    rows_pl = mesh_placements(mesh, {dp_axis: 0})
    rep_pl = mesh_placements(mesh, {})
    ew_pl = mesh_placements(mesh, {"model": 0})

    # the reference's token layout: xt = x.reshape(t, d) in chunks of t_dev
    # rows over (data axes, 'model'), data major; the flatten is made with
    # the batch over the data axes alone, where each rank's rows are whole
    xt = x.redistribute(mesh, rows_pl).reshape(t, d)
    xl = local_shard(xt, tok_pl)  # (t_dev, d)
    # replicated operands used on this rank's tokens: their gradients are
    # partial sums over the token shards
    router = local_shard(params[f"{p}router"], rep_pl, mesh_placements(mesh, {}, tok_axes))
    ew_grad = mesh_placements(mesh, {"model": 0}, MeshRules._axis_names(dp_axis))
    we_gate, we_up, we_down = (local_shard(params[f"{p}{n}"], ew_pl, ew_grad)
                               for n in ("we_gate", "we_up", "we_down"))
    dev = xl.device

    probs, top_w, top_e = route(xl, router, cfg)
    # aux loss from the means over every token shard
    shards = dp * ep
    mean_pl = mesh_placements(mesh, {}, tok_axes)
    me = wrap_local(probs.mean(dim=0) / shards, mesh, mean_pl, (e,)).full_tensor()
    assign = torch.zeros((t_dev, e), dtype=torch.float32, device=dev)
    assign.scatter_add_(1, top_e, torch.ones_like(top_w))
    ce = wrap_local(assign.mean(dim=0) / k / shards, mesh, mean_pl, (e,)).full_tensor()
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight

    # ---- send side: group assignments by destination expert shard ----
    flat_e = top_e.reshape(t_dev * k)
    flat_tok = torch.arange(t_dev, device=dev)[:, None].expand(t_dev, k).reshape(-1)
    dest = flat_e // e_loc
    order = torch.argsort(dest, stable=True)
    sd, stok, sexp = dest[order], flat_tok[order], flat_e[order]
    rank = torch.arange(t_dev * k, device=dev) - _first_of(sd, ep)[sd]
    keep = rank < c_send
    slot = torch.where(keep, sd * c_send + rank, torch.full_like(sd, ep * c_send))
    slot_tok = _scatter_drop(ep * c_send, t_dev, slot, stok)
    send_eid = _scatter_drop(ep * c_send, -1, slot, sexp % e_loc)
    send_x = torch.cat([xl, xl.new_zeros((1, d))])[slot_tok]  # (ep·c_send, d)
    # assignment → its slot among those sent (ep·c_send: dropped)
    a_slot = torch.empty_like(slot)
    a_slot[order] = slot
    a_slot = a_slot.reshape(t_dev, k)

    # ---- out over the model axis ----
    recv_x = all_to_all(send_x, group)
    recv_eid = all_to_all(send_eid, group)

    # ---- receive side: group by local expert, capacity-pad, compute ----
    eid = torch.where(recv_eid < 0, torch.full_like(recv_eid, e_loc), recv_eid)  # pads last
    r_order = torch.argsort(eid, stable=True)
    r_eid = eid[r_order]
    r_rank = torch.arange(ep * c_send, device=dev) - _first_of(r_eid, e_loc)[
        torch.clamp(r_eid, max=e_loc - 1)]
    r_keep = (r_eid < e_loc) & (r_rank < c_recv)
    r_slot = torch.where(r_keep, r_eid * c_recv + r_rank, torch.full_like(r_eid, e_loc * c_recv))
    if DROP_LOG is not None:
        DROP_LOG.append((~keep).sum() + ((r_eid < e_loc) & ~r_keep).sum())
    buf_src = _scatter_drop(e_loc * c_recv, ep * c_send, r_slot, r_order)
    x_buf = torch.cat([recv_x, recv_x.new_zeros((1, d))])[buf_src].reshape(e_loc, c_recv, d)
    gate = torch.bmm(x_buf, we_gate)
    up = torch.bmm(x_buf, we_up)
    y_buf = torch.bmm(swish(gate) * up, we_down).reshape(e_loc * c_recv, d)

    # ---- back to the received layout, then home ----
    row_slot = _scatter_drop(ep * c_send, e_loc * c_recv, buf_src,
                             torch.arange(e_loc * c_recv, device=dev))
    ret = torch.cat([y_buf, y_buf.new_zeros((1, d))])[row_slot]
    back = torch.cat([all_to_all(ret, group), ret.new_zeros((1, d))])

    # ---- combine: each assignment's result, weighted, summed over K ----
    y = xl.new_zeros((t_dev, d))
    for kk in range(k):
        yk = back[a_slot[:, kk]]
        y = y + (yk * top_w[:, kk: kk + 1].to(yk.dtype)).to(xl.dtype)
    y = wrap_local(y, mesh, tok_pl, (t, d)).redistribute(mesh, rows_pl).reshape(b, s, d)
    aux = wrap_local(aux, mesh, rep_pl, ())
    if cfg.shared_expert:
        y = y + _shared_expert(xt, params, p).reshape(b, s, d)
    return y, aux
