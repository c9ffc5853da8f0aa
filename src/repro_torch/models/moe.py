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
from ..sharding.specs import MeshRules, current_rules, local_shard, mesh_placements, wrap_local
from .common import swish

DISPATCHES = ("scatter", "gather", "ep_shard_map")

# None, or a list to which every MoE call appends its dropped assignments
# (over capacity; a 0-d int64 tensor on the device, this rank's), read by
# the caller after the step: nothing syncs with the host here
DROP_LOG = None
# None, or a list to which every call under installed mesh rules appends
# (its first expert, its first capacity slot, its x_buf block) (the tests
# hold the block to the 1×1 buffer's)
BLOCK_LOG = None


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
    reference. Under rules the expert buffer is laid out by its logical
    axes ("expert" over 'model', "expert_capacity" over the data axes) and
    each rank fills, computes and combines only its block
    (``_moe_ffn_blocks``), with the 1×1 path's slots, drops, aux loss and
    forward values.

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
    if current_rules() is not None:
        return _moe_ffn_blocks(x, params, cfg, prefix)
    p = prefix
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    x_buf, aux, sw, order, keep, buf_pos = _dispatch(xt, params[f"{p}router"], cfg,
                                                     cfg.capacity(t))
    gate = torch.bmm(x_buf, params[f"{p}we_gate"])
    up = torch.bmm(x_buf, params[f"{p}we_up"])
    y_buf = torch.bmm(swish(gate) * up, params[f"{p}we_down"])
    y = _combine(y_buf, sw, order, keep, buf_pos, t, cfg.top_k, x.dtype)
    if cfg.shared_expert:
        y = y + _shared_expert(xt, params, p)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# the dispatch sharded over the mesh: each rank its block of the buffer
# ---------------------------------------------------------------------------


def _coordinate(mesh, axis) -> int:
    """This rank's index along a mesh axis or tuple of axes (major to
    minor, as a dim sharded over them splits); 0 for None."""
    index = 0
    for name in MeshRules._axis_names(axis):
        index = index * int(mesh.size(mesh.mesh_dim_names.index(name))) + \
            int(mesh.get_local_rank(name))
    return index


def _gather_rows(local: torch.Tensor, mesh, rows_pl: tuple, n: int, grad_pl=None) -> torch.Tensor:
    """Every rank's rows of a (n/ranks, ...) tensor laid out ``rows_pl``,
    whole (an all-gather; differentiable, ``grad_pl`` the layout of the
    gradient that comes back, as ``local_shard`` takes it)."""
    dt = wrap_local(local, mesh, rows_pl, (n, *local.shape[1:]))
    return local_shard(dt, mesh_placements(mesh, {}), grad_pl)


def _moe_ffn_blocks(x, params: Dict[str, torch.Tensor], cfg: MoEConfig, p: str):
    """``_moe_ffn`` under installed rules, the expert buffer laid out as
    the reference's ``shard_act(x_buf, ("expert", "expert_capacity",
    "act_embed"))`` asks: a rank fills and computes only its block, its
    experts (over 'model') × its capacity slots (over the data axes), on
    local tensors with explicit collectives.

    The t tokens are split by rows over the data axes (where the batch
    divides them). A data rank routes its own rows; a token's rank within
    its expert is its local stable rank plus the earlier data ranks'
    counts for that expert (an exclusive prefix over the all-gathered (E,)
    counts), which is ``dispatch_plan``'s rank over all t·K assignments,
    so the slots and drops are the 1×1 path's, capacity over all t
    tokens. The tokens and their slots are all-gathered over the data
    axes (t·d and t·K elements a rank) and each rank takes its block's
    rows: its x_buf block is that block of the 1×1 buffer. The aux loss is
    the 1×1 path's arithmetic on the all-gathered (t, E) probabilities.

    The combine keeps ``_combine``'s order. For each j < K, every rank
    writes the weighted output of each token's j-th assignment (ascending
    expert) that its block holds into a (t, d) part, zero elsewhere; the
    parts are summed over the ranks that split the buffer onto the
    token's owner, exact since one rank holds each assignment; the owner
    adds the K parts in order. No rank holds more than t·d elements of a
    kind: not the (E, cap, d) buffer, the (E·cap, d) result or the (t·K,
    d) contributions. Both dispatches (``scatter``, ``gather``) fill the
    block the same way."""
    from torch.distributed.tensor import DTensor

    rules = current_rules()
    mesh = rules.mesh
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = cfg.capacity(t)
    dp_axis = rules.rules.get("batch")
    rows = dp_axis if b % rules.axis_size(dp_axis) == 0 else None
    n_rows, r_rows = rules.axis_size(rows), _coordinate(mesh, rows)
    t_loc = t // n_rows
    exp_axis, cap_axis = (tuple(rules.spec(("expert", "expert_capacity", "act_embed"),
                                           (e, cap, d))) + (None, None))[:2]
    e_loc, c_loc = e // rules.axis_size(exp_axis), cap // rules.axis_size(cap_axis)
    e0, c0 = _coordinate(mesh, exp_axis) * e_loc, _coordinate(mesh, cap_axis) * c_loc
    n_blk = e_loc * c_loc
    split = MeshRules._axis_names(exp_axis) + MeshRules._axis_names(cap_axis)
    whole = mesh_placements(mesh, {})
    rows_pl = mesh_placements(mesh, {rows: 0} if rows else {})
    # a rank's block takes part in sums over the ranks that split the
    # buffer; the other axes hold copies of it
    blk_partial = mesh_placements(mesh, {}, split)

    xt = x.redistribute(mesh, rows_pl).reshape(t, d)
    xl = local_shard(xt, rows_pl)  # (t_loc, d): this data rank's rows
    xt_all = local_shard(xt, whole, blk_partial)  # (t, d)
    router = local_shard(params[f"{p}router"], whole, mesh_placements(mesh, {}, rows))
    w_pl = mesh_placements(mesh, {exp_axis: 0} if exp_axis else {})
    w_grad = mesh_placements(mesh, {exp_axis: 0} if exp_axis else {}, cap_axis)
    we_gate, we_up, we_down = (local_shard(params[f"{p}{n}"], w_pl, w_grad)
                               for n in ("we_gate", "we_up", "we_down"))
    dev = xl.device

    # ---- routing: this data rank's rows; the rank over all t tokens ----
    probs, top_w, top_e = route(xl, router, cfg)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.searchsorted(se, torch.arange(e, device=dev), side="left")
    counts = torch.diff(first, append=first.new_full((1,), se.numel()))
    before = _gather_rows(counts[None], mesh, rows_pl, n_rows)[:r_rows].sum(dim=0)
    grank = before[se] + torch.arange(se.numel(), device=dev) - first[se]
    keep = grank < cap
    if DROP_LOG is not None:
        DROP_LOG.append((~keep).sum())
    pos = torch.empty_like(se)
    pos[order] = torch.where(keep, se * cap + grank, torch.full_like(se, e * cap))
    pos_all = _gather_rows(pos.reshape(t_loc, k), mesh, rows_pl, t)  # (t, K), token order
    top_e_all = _gather_rows(top_e, mesh, rows_pl, t)
    probs_all = _gather_rows(probs, mesh, rows_pl, t)
    w_all = _gather_rows(top_w, mesh, rows_pl, t, blk_partial)

    # Switch-style load-balance aux loss, the 1×1 arithmetic on all tokens
    assign = torch.zeros((t, e), dtype=torch.float32, device=dev)
    assign.scatter_add_(1, top_e_all, torch.ones_like(w_all))
    aux = e * torch.sum(probs_all.mean(dim=0) * (assign.mean(dim=0) / k)) * \
        cfg.router_aux_weight

    # ---- this rank's block of slots: the assignment in each ----
    ex, slot = pos_all.reshape(-1) // cap, pos_all.reshape(-1) % cap
    mine = (ex >= e0) & (ex < e0 + e_loc) & (slot >= c0) & (slot < c0 + c_loc)
    row = torch.where(mine, (ex - e0) * c_loc + slot - c0, torch.full_like(ex, n_blk))
    slot_asg = torch.full((n_blk + 1,), t * k, dtype=torch.int64, device=dev)
    slot_asg[row] = torch.arange(t * k, device=dev)  # (a dropped one lands past the block)
    slot_asg = slot_asg[:n_blk]
    filled = slot_asg < t * k
    slot_tok = torch.clamp(slot_asg // k, max=t - 1)
    x_blk = torch.where(filled[:, None], xt_all[slot_tok], xt_all.new_zeros(()))
    x_blk = x_blk.reshape(e_loc, c_loc, d)
    del xt_all  # (t, d): not kept for the backward, so not past the dispatch
    if BLOCK_LOG is not None:
        BLOCK_LOG.append((e0, c0, x_blk.detach()))
    y_blk = torch.bmm(swish(torch.bmm(x_blk, we_gate)) * torch.bmm(x_blk, we_up), we_down)

    # ---- combine: each slot's output weighted, as the 1×1 path weighs it;
    # then per j < K the tokens' j-th assignments (by ascending expert),
    # summed onto their owners, and added in that order ----
    asg = torch.clamp(slot_asg, max=t * k - 1)
    w_slot = torch.where(filled, w_all.reshape(-1)[asg], w_all.new_zeros(()))
    contrib = (y_blk.reshape(n_blk, d) * w_slot[:, None].to(y_blk.dtype)).to(x.dtype)
    by_expert = torch.sort(top_e_all, dim=1, stable=True).indices  # (t, K): k of the j-th
    j_of = torch.empty_like(by_expert)
    j_of.scatter_(1, by_expert, torch.arange(k, device=dev).expand(t, k).contiguous())
    j_slot = torch.where(filled, j_of.reshape(-1)[asg], torch.full_like(asg, k))
    y = None
    for j in range(k):
        vals = torch.where((j_slot == j)[:, None], contrib, contrib.new_zeros(()))
        part = contrib.new_zeros((t, d)).index_put((slot_tok,), vals, accumulate=True)
        part = DTensor.from_local(part, mesh, blk_partial, run_check=False,
                                  shape=torch.Size((t, d)), stride=(d, 1))
        part = local_shard(part, rows_pl)  # (t_loc, d): one rank's term, exact
        y = part if y is None else y + part
    y = wrap_local(y, mesh, rows_pl, (t, d)).reshape(b, s, d)
    if cfg.shared_expert:
        y = y + _shared_expert(xt, params, p).reshape(b, s, d)
    return y, DTensor.from_local(aux, mesh, whole, run_check=False)


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
