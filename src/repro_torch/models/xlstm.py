"""xLSTM blocks (sLSTM + mLSTM), the substrate of xLSTM-125M (the port's
copy of ``repro.models.xlstm``).

mLSTM: a matrix memory C (dh × dh) per head with exponential gating and a
max-stabiliser state; the block up-projects by 2, takes q/k/v from the inner
stream, gates the output and projects down. sLSTM: a scalar memory whose
gates mix the previous hidden state head by head, then a gelu feed-forward
(factor 4/3). Both run their recurrence in f32 as a chunked scan
(``models/scan.py``): chunks of ``XLSTMConfig.chunk`` = 64 steps, as in the
reference, only each chunk's start state kept for the backward and the
chunk's steps recomputed there, so training at 4k tokens does not keep
every step's matrix memory. The reference pads the sequence to whole
chunks whose padded steps never touch the state; here a tail chunk runs
only its own steps, so a decode step is one step, not 64. The m states
start at −1e30.

Under mesh rules both scans run on local blocks (``over_batch``): each
data rank its batch rows; over 'model' the mLSTM splits its matrix
memory's value rows (``_mlstm_region``) and the sLSTM its gate columns
(``_slstm_region``), as the reference's compiled steps split them.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..sharding.specs import current_rules, over_batch, shard_act
from .common import Leaf, gelu, rms_norm, swish
from .scan import chunked_scan

NEG_M = -1e30  # the initial max-stabiliser, as in the reference


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int
    m_proj_factor: float = 2.0
    s_ff_factor: float = 1.3334
    chunk: int = 64  # the scans' rematerialisation grain, in steps

    @property
    def d_inner(self) -> int:
        return int(self.m_proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def s_head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff_s(self) -> int:
        return int(self.s_ff_factor * self.d_model)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_param_shapes(cfg: XLSTMConfig) -> Dict[str, Tuple[tuple, object, tuple]]:
    """{name: (shape, init std or 'ones'/'zeros', logical axes)} of one
    mLSTM block, the reference's ``ParamDef``s (the gate projections at std
    0.02, the forget bias at ones)."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    return {
        "w_up": ((d, 2 * di), 1.0 / math.sqrt(d), ("embed", "ffn")),
        "w_q": ((di, di), 1.0 / math.sqrt(di), ("ffn", "heads")),
        "w_k": ((di, di), 1.0 / math.sqrt(di), ("ffn", "heads")),
        "w_v": ((di, di), 1.0 / math.sqrt(di), ("ffn", "heads")),
        "w_ig": ((di, h), 0.02, ("ffn", None)),
        "b_ig": ((h,), "zeros", (None,)),
        "w_fg": ((di, h), 0.02, ("ffn", None)),
        "b_fg": ((h,), "ones", (None,)),
        "norm_w": ((di,), "ones", ("ffn",)),
        "w_down": ((di, d), 1.0 / math.sqrt(di), ("ffn", "embed")),
    }


def mlstm_state_layout(cfg: XLSTMConfig, batch: int) -> Tuple[Leaf, ...]:
    """The leaves of (C (b, h, dh, dh), n (b, h, dh), m (b, h)), f32; m at
    −1e30."""
    h, dh = cfg.n_heads, cfg.head_dim
    return (Leaf((batch, h, dh, dh), torch.float32), Leaf((batch, h, dh), torch.float32),
            Leaf((batch, h), torch.float32, NEG_M))


def mlstm_state_init(cfg: XLSTMConfig, batch: int, device=None):
    """(C, n, m) of ``mlstm_state_layout``."""
    return tuple(leaf.new(device) for leaf in mlstm_state_layout(cfg, batch))


def _mlstm_step(state, qt, kt, vt, li, lf):
    """One mLSTM step: (b, h, dh) q/k/v and (b, h) log gates, from (c, n,
    m); returns (the new state, y_t (b, h, dh))."""
    c, n, m = state
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)[..., None]  # (b, h, 1)
    f_p = torch.exp(lf + m - m_new)[..., None]
    c = f_p[..., None] * c + i_p[..., None] * torch.einsum("bhv,bhk->bhvk", vt, kt)
    n = f_p * n + i_p * kt
    num = torch.einsum("bhvk,bhk->bhv", c, qt)
    den = torch.einsum("bhk,bhk->bh", n, qt).abs()
    den = torch.maximum(den, torch.exp(-m_new))[..., None]
    return (c, n, m_new), num / den


def _mlstm_scan(chunk, q, k, v, log_i, f_pre, c, n, m):
    """The mLSTM recurrence over (b, s, h, dh) f32 inputs and the forget
    gate's pre-activations from the state (c, n, m), chunked by ``chunk``
    steps. Returns (y (b, s, h, dh), the state after the last step). Each
    value row of C, and so each element of y, depends only on its row of v
    and on q, k, the gates, n and m whole, so v and C may hold a share of
    the rows (dh / tp of every head on a mesh, ``_mlstm_region``): y and C
    come back with those rows, by the same ops on each element."""
    return chunked_scan(_mlstm_step, (q, k, v, log_i, F.logsigmoid(f_pre)), (), (c, n, m),
                        chunk, v.shape[2:])


# the mLSTM state's logical axes: (C, n, m)
MLSTM_STATE_AXES = (("batch", "heads", None, None), ("batch", "heads", None), ("batch", "heads"))


def _mlstm_region(chunk: int):
    """The mLSTM scan on local blocks (``over_batch``): each data rank its
    batch rows and, where the model axis divides dh, each model rank the
    dh / tp value rows of every head of v and C (and so of y), with q, k,
    the gates, n and m whole, as the reference's layouts split its
    products along d_inner over 'model'. Where it does not divide dh, the
    scan runs whole on every model rank."""
    return over_batch(functools.partial(_mlstm_scan, chunk), model={2: 3, 5: 2},
                      out_model=(3, (2, None, None)))


def mlstm_forward(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: XLSTMConfig,
                  state=None):
    """(b, s, d) → (out (b, s, d), the new state); ``state`` None starts
    from ``mlstm_state_init``."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    # the up projection as two products, one a half of w_up's columns, each
    # half laid out as w_up is (its columns over 'model'): split after the
    # product, the (b, s, 2·di) output would be gathered whole on every
    # model rank, and the weight's gradient computed whole on each
    w_x, w_z = (shard_act(w, ("embed", "ffn")) for w in params["w_up"].chunk(2, dim=-1))
    xm, z = x @ w_x, x @ w_z  # (b, s, di) each
    xm = shard_act(xm, ("batch", None, "ffn"))
    qf = (xm @ params["w_q"]).reshape(b, s, h, dh).to(torch.float32)
    kf = (xm @ params["w_k"]).reshape(b, s, h, dh).to(torch.float32) / (dh ** 0.5)
    vf = (xm @ params["w_v"]).reshape(b, s, h, dh).to(torch.float32)
    log_i = (xm @ params["w_ig"] + params["b_ig"]).to(torch.float32)
    f_pre = (xm @ params["w_fg"] + params["b_fg"]).to(torch.float32)
    if state is None:
        state = mlstm_state_init(cfg, b, x.device)
    y, (c, n, m) = _mlstm_region(cfg.chunk)(qf, kf, vf, log_i, f_pre, *state)
    # the state as the cache lays it out: one gather of C's rows
    state = tuple(shard_act(t, axes) for t, axes in zip((c, n, m), MLSTM_STATE_AXES))
    # y gathered whole over 'model' (it came back by value rows), and after
    # its heads merge laid out by rows alone, so that its gradient comes back
    # so: sharded over 'model' along d_inner, it could not be viewed as (h,
    # dh) where the heads do not divide the axis (xLSTM-125M's 4 over 16)
    y = shard_act(y, ("batch", None, None, None))
    y = shard_act(y.reshape(b, s, cfg.d_inner), ("batch", None, None)).to(x.dtype)
    # the normed y laid out as z and w_down's rows are (d_inner over
    # 'model', a local slice), so that each model rank multiplies its share
    # of d_inner and computes its block of w_down's gradient: left to
    # DTensor's propagation, torch 2.11 computed the whole gradient on every
    # model rank (2.13 sliced)
    y = shard_act(rms_norm(y, params["norm_w"]), ("batch", None, "ffn")) * swish(z)
    return y @ params["w_down"], state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_param_shapes(cfg: XLSTMConfig) -> Dict[str, Tuple[tuple, object, tuple]]:
    """{name: (shape, init std or 'ones'/'zeros', logical axes)} of one
    sLSTM block: the z/i/f/o gate pre-activations, their head-wise recurrent
    mix (std 0.02) and the feed-forward."""
    d, h, sdh = cfg.d_model, cfg.n_heads, cfg.s_head_dim
    return {
        "w_gates": ((d, 4 * d), 1.0 / math.sqrt(d), ("embed", "ffn")),
        "r_gates": ((h, sdh, 4 * sdh), 0.02, ("heads", None, None)),
        "b_gates": ((4 * d,), "zeros", ("ffn",)),
        "norm_w": ((d,), "ones", ("embed",)),
        "w_ff_up": ((d, cfg.d_ff_s), 1.0 / math.sqrt(d), ("embed", "ffn")),
        "w_ff_down": ((cfg.d_ff_s, d), 1.0 / math.sqrt(cfg.d_ff_s), ("ffn", "embed")),
    }


def slstm_state_layout(cfg: XLSTMConfig, batch: int) -> Tuple[Leaf, ...]:
    """The leaves of (c, n, m, h), each (b, d) f32; m at −1e30."""
    z = Leaf((batch, cfg.d_model), torch.float32)
    return (z, z, Leaf(z.shape, torch.float32, NEG_M), z)


def slstm_state_init(cfg: XLSTMConfig, batch: int, device=None):
    """(c, n, m, h) of ``slstm_state_layout``."""
    return tuple(leaf.new(device) for leaf in slstm_state_layout(cfg, batch))


def slstm_forward(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: XLSTMConfig,
                  state=None):
    """sLSTM with the head-wise recurrent gate mix, then the feed-forward:
    (b, s, d) → (out, the new state)."""
    pre = (x @ params["w_gates"] + params["b_gates"]).to(torch.float32)  # (b, s, 4d)
    if state is None:
        state = slstm_state_init(cfg, x.shape[0], x.device)
    ys, state = _slstm_region(cfg.chunk)(pre, params["r_gates"].to(torch.float32), *state)
    y = rms_norm(ys.to(x.dtype), params["norm_w"])
    return gelu(y @ params["w_ff_up"]) @ params["w_ff_down"], state


def _slstm_cell(state, g):
    """The sLSTM's update of (c, n, m, h_prev) from the (b, 4d) gate sums
    (pre-activations plus the recurrent mix, gate-major: z, i, f, o);
    returns (the new state, the new hidden state (b, d))."""
    c, n, m, _ = state
    zt, it, ft, ot = g.chunk(4, dim=-1)
    zt, ot, log_f = torch.tanh(zt), torch.sigmoid(ot), F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p * c + i_p * zt
    n = f_p * n + i_p
    h_new = ot * c / torch.clamp(n, min=1e-6)
    return (c, n, m_new, h_new), h_new


def _slstm_step(state, pre_t, r_w):
    """One sLSTM step: the (b, 4d) gate pre-activations with the head-wise
    recurrent mix r_w (h, sdh, 4 sdh), from (c, n, m, h_prev); returns (the
    new state, the new hidden state (b, d))."""
    h_prev = state[3]
    b, d4 = pre_t.shape
    h, sdh = r_w.shape[0], r_w.shape[1]
    rec = torch.einsum("bhk,hkj->bhj", h_prev.reshape(b, h, sdh), r_w)
    # (b, h, 4 sdh) → the (b, 4d) gate layout: gate-major, then heads
    rec = rec.reshape(b, h, 4, sdh).transpose(1, 2).reshape(b, d4)
    return _slstm_cell(state, pre_t + rec)


def _slstm_scan(chunk, pre, r_w, c, n, m, h_prev):
    """The sLSTM recurrence over the (b, s, 4d) f32 gate pre-activations
    with the head-wise recurrent mix r_w from the state (c, n, m, h_prev),
    chunked by ``chunk`` steps. Returns (the hidden states (b, s, d) f32,
    the state after the last step)."""
    return chunked_scan(_slstm_step, (pre,), (r_w,), (c, n, m, h_prev), chunk, h_prev.shape[1:])


# ---------------------------------------------------------------------------
# the sLSTM over 'model'
# ---------------------------------------------------------------------------


def slstm_block(d: int, sdh: int, tp: int, rank: int):
    """Where model rank ``rank`` of ``tp`` sits in the (b, 4d) gate layout
    (gate-major, then heads) when its 4d columns are split into ``tp``
    contiguous blocks, as the gate projection's output is over 'model':
    (first head, heads, gates) of its block, whose recurrent mix it
    computes from whole heads of h. None where a block is neither whole
    gates of every head nor whole heads of one gate."""
    w = 4 * d // tp
    if (4 * d) % tp:
        return None
    if w % d == 0:
        return 0, d // sdh, w // d
    if d % w or w % sdh:
        return None
    return rank * w % d // sdh, w // sdh, 1


def gate_rows(r_w: torch.Tensor) -> torch.Tensor:
    """The recurrent mix (h, sdh, 4 sdh) as (4d, sdh): row (gate, head,
    column) holds that gate column's weights over its head's sdh inputs,
    in the (b, 4d) gate layout's order."""
    h, sdh = r_w.shape[0], r_w.shape[1]
    return r_w.reshape(h, sdh, 4, sdh).permute(2, 0, 3, 1).reshape(4 * h * sdh, sdh)


def slstm_block_sums(block, h_prev, pre_t, rows):
    """A model rank's block of the (b, 4d) gate sums (``slstm_block``):
    pre_t (b, w) its w = 4d/tp columns plus their recurrent mix from the
    whole h_prev (b, d), ``rows`` (w, sdh) their rows of ``gate_rows``:
    1/tp of the step's product."""
    j0, hl, gl = block
    b, sdh = h_prev.shape[0], rows.shape[1]
    heads = h_prev.reshape(b, -1, sdh)[:, j0: j0 + hl]
    rec = torch.einsum("bhi,ghki->bghk", heads, rows.reshape(gl, hl, sdh, sdh)).reshape(b, -1)
    return pre_t + rec


def _slstm_block_step(block, gather, state, pre_t, rows):
    """One sLSTM step on a model rank's block: its gate sums, gathered
    whole in rank order (``gather``), then the whole update, as on one
    process."""
    return _slstm_cell(state, gather(slstm_block_sums(block, state[3], pre_t, rows)))


class _GatherOverModel(torch.autograd.Function):
    """Every model rank's (b, w) block, whole (b, tp·w) in rank order: one
    all-gather over the model group. The gradient that comes back is a
    part of a sum on each rank (over_batch counts a whole output's
    cotangent on model rank 0 alone); it leaves summed over the model
    ranks, each rank its own block: one reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group):
        from ..sharding.serve import _all_gather

        ctx.group = group
        return _all_gather(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        b, tp = g.shape[0], dist.get_world_size(ctx.group)
        parts = g.reshape(b, tp, -1).permute(1, 0, 2).reshape(tp * b, -1).contiguous()
        out = parts.new_empty((b, parts.shape[1]))
        # reduce_scatter_single is the name since torch 2.13, as in _all_gather
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        scatter(out, parts, group=ctx.group)
        return out, None


def _slstm_block_scan(chunk, block, rank, group, pre, r_w, c, n, m, h_prev):
    """``_slstm_scan`` on model rank ``rank``'s block of the gate columns:
    pre (b, s, w) its columns, r_w and the state whole; each step issues
    one all-gather of the (b, w) gate sums over ``group`` (one
    reduce-scatter in the backward). Returns the whole hidden states and
    state, the same on every model rank."""
    w = pre.shape[2]
    rows = gate_rows(r_w)[rank * w: (rank + 1) * w]
    def gather(x):
        return _GatherOverModel.apply(x, group)

    return chunked_scan(functools.partial(_slstm_block_step, block, gather), (pre,), (rows,),
                        (c, n, m, h_prev), chunk, h_prev.shape[1:])


def _slstm_region(chunk: int):
    """The sLSTM scan on local blocks (``over_batch``): each data rank its
    batch rows, and, where the model axis splits the 4d gate columns into
    blocks ``slstm_block`` places, each model rank its block of the gate
    pre-activations as the gate projection left them and of the recurrent
    mix, whose product is its 1/tp of the work; the block's gate sums are
    all-gathered over 'model' each step and every model rank updates the
    whole state, which it keeps whole as the cache lays it out
    (``("batch", None)``). The reference's compiled step at (16, 16) splits
    the product alike, one gate of one head a rank, and gathers each
    head's gate sums over 4 ranks, keeping the state split 4 ways inside
    its scan. Elsewhere (one model rank, or no such block) the scan runs
    whole on every model rank."""
    def run(pre, r_w, *state):
        rules = current_rules()
        tp = rules.axis_size("model") if rules is not None else 1
        d, sdh = state[3].shape[1], r_w.shape[1]
        rank = rules.mesh.get_local_rank("model") if tp > 1 else 0
        block = slstm_block(d, sdh, tp, rank) if tp > 1 else None
        if block is None:
            return over_batch(functools.partial(_slstm_scan, chunk), weights=(1,))(pre, r_w,
                                                                                  *state)
        fn = functools.partial(_slstm_block_scan, chunk, block, rank,
                               rules.mesh.get_group("model"))
        return over_batch(fn, weights=(1,), model={0: 2}, out_model=(None, (None,) * 4))(
            pre, r_w, *state)

    return run
