"""Mamba2 (SSD) blocks, the substrate of Zamba2-7B (the port's copy of
``repro.models.ssm``).

The full-sequence forward is the chunked state-space-duality form (Dao & Gu
2024): within a chunk of ``chunk`` steps the recurrence is masked matmuls,
across chunks a loop carries the (b, h, p, n) f32 state. The sequence is
padded to whole chunks with dt = 0 (decay 1, no input), so the carried state
is exact. Decode is the O(1) recurrent update. Where the reference lets JAX
promote a bf16 × f32 product to f32, the bf16 side is cast up here first;
where it casts back to the input's dtype, so does this.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..sharding import serve as serve_mesh  # whole_rows reads the split at call time
from ..sharding.specs import over_batch, shard_act
from .common import Leaf, rms_norm, swish


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba2_param_shapes(cfg: Mamba2Config) -> Dict[str, Tuple[tuple, object, tuple]]:
    """{name: (shape, init std or 'ones'/'zeros', logical axes)} of one
    Mamba2 layer, the reference's ``ParamDef``s (fan-in normal; the conv
    taps at 0.5)."""
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + cfg.n_heads
    return {
        "w_in": ((cfg.d_model, d_in_proj), 1.0 / math.sqrt(cfg.d_model), ("embed", "conv_dim")),
        "conv_w": ((cfg.d_conv, cfg.conv_dim), 0.5, (None, "conv_dim")),
        "conv_b": ((cfg.conv_dim,), "zeros", ("conv_dim",)),
        "a_log": ((cfg.n_heads,), "zeros", ("ssm_heads",)),
        "dt_bias": ((cfg.n_heads,), "zeros", ("ssm_heads",)),
        "d_skip": ((cfg.n_heads,), "ones", ("ssm_heads",)),
        "norm_w": ((cfg.d_inner,), "ones", ("conv_dim",)),
        "w_out": ((cfg.d_inner, cfg.d_model), 1.0 / math.sqrt(cfg.d_inner),
                  ("conv_dim", "embed")),
    }


def _split_in_proj(zxbcdt: torch.Tensor, cfg: Mamba2Config):
    """The in-projection's (z, xBC, dt) lanes."""
    d_in = cfg.d_inner
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in: d_in + cfg.conv_dim],
            zxbcdt[..., d_in + cfg.conv_dim:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d_conv: int):
    """Depthwise causal conv over (b, s, c), then swish; the taps are summed
    in f32 and rounded once to xbc's dtype. Every channel is independent:
    on a mesh each data rank runs its batch rows and each model rank its
    channels (``over_batch``)."""
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, d_conv - 1, 0))
    views = torch.stack([pad[:, i: i + s] for i in range(d_conv)])  # (d_conv, b, s, c)
    out = torch.einsum("kbsc,kc->bsc", views.to(torch.float32), w.to(torch.float32))
    return swish(out.to(xbc.dtype) + b)


def _heads(xbc: torch.Tensor, cfg: Mamba2Config):
    """xBC (..., conv_dim) → x (..., h, p), B and C (..., h, n): the groups
    repeated over their heads."""
    lead = xbc.shape[:-1]
    g, n = cfg.n_groups, cfg.d_state
    xs = xbc[..., : cfg.d_inner].reshape(*lead, cfg.n_heads, cfg.head_dim)
    bmat = xbc[..., cfg.d_inner: cfg.d_inner + g * n].reshape(*lead, g, n)
    cmat = xbc[..., cfg.d_inner + g * n:].reshape(*lead, g, n)
    rep = cfg.n_heads // g
    return xs, bmat.repeat_interleave(rep, dim=-2), cmat.repeat_interleave(rep, dim=-2)


def _dt_decay(dt: torch.Tensor, params, cfg: Mamba2Config):
    """(dt, a): softplus(dt + dt_bias) and -exp(a_log), in f32."""
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"].to(torch.float32))
    return dt, -torch.exp(params["a_log"].to(torch.float32))


def _ssd_chunks(xs_f, b_h, c_h, dt, da, q: int, d_state: int):
    """The chunked SSD scan over (b, s, h, ·) inputs (x in f32, B and C,
    the step sizes and log-decays), from a zero state: (y (b, s, h, p) f32
    before the skip, the state at the end (b, h, p, n) f32). Every head is
    independent: on a mesh each data rank runs its batch rows and each
    model rank its heads (``over_batch``), B and C taken from the groups'
    whole repeat."""
    b, s, h, pdim = xs_f.shape
    pad = (-s) % q
    if pad:  # padded steps: dt = 0 (decay 1), no input
        xs_f, b_h, c_h = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xs_f, b_h, c_h))
        da, dt = F.pad(da, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    nc = (s + pad) // q
    iq = torch.arange(q, device=xs_f.device)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]
    state = torch.zeros((b, h, pdim, d_state), dtype=torch.float32, device=xs_f.device)
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        xs_i, b_i, c_i, dt_i = xs_f[:, sl], b_h[:, sl], c_h[:, sl], dt[:, sl]
        cs = torch.cumsum(da[:, sl], dim=1)  # (b, q, h) decay from the chunk's start
        # the carried state's contribution
        y = torch.einsum("bqhn,bhpn->bqhp", c_i.to(torch.float32), state) \
            * torch.exp(cs)[..., None]
        # within the chunk: the masked "attention" form; exp above the
        # diagonal overflows, so it is selected away, never multiplied
        seg = cs[:, :, None, :] - cs[:, None, :, :]  # (b, q, q, h)
        l_mat = torch.where(causal, torch.exp(seg), torch.zeros((), device=xs_f.device))
        scores = torch.einsum("bqhn,bkhn->bqkh", c_i, b_i).to(torch.float32) \
            * l_mat * dt_i[:, None, :, :]
        y = y + torch.einsum("bqkh,bkhp->bqhp", scores, xs_i)
        ys.append(y)
        # the state at the chunk's end
        decay_out = torch.exp(cs[:, -1:, :] - cs)
        weighted = xs_i * (dt_i * decay_out)[..., None]
        state = torch.exp(cs[:, -1, :])[..., None, None] * state + torch.einsum(
            "bqhp,bqhn->bhpn", weighted, b_i.to(torch.float32))
    return torch.cat(ys, dim=1)[:, :s], state


def _conv_region(d_conv: int):
    """The causal conv on local blocks (``over_batch``): each data rank its
    batch rows, each model rank its channels of xBC and of the taps and
    bias (conv_dim over 'model', as the reference lays them out), where the
    model axis divides conv_dim; else every channel on every model rank."""
    return over_batch(functools.partial(_causal_conv, d_conv=d_conv), weights=(1, 2),
                      model={0: 2, 1: 1, 2: 0}, out_model=2)


def _ssd_region(q: int, d_state: int):
    """The SSD scan on local blocks (``over_batch``): each data rank its
    batch rows, each model rank its SSD heads of every input (ssm_heads
    over 'model'), where the model axis divides them; else every head on
    every model rank. B and C come whole, repeated over the heads, and each
    rank takes its heads' copies: their gradients come back as those
    heads' slices, exact, and are gathered whole."""
    return over_batch(functools.partial(_ssd_chunks, q=q, d_state=d_state),
                      model={i: 2 for i in range(5)}, out_model=(2, 1))


def mamba2_forward(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: Mamba2Config,
                   return_state: bool = False):
    """Full-sequence chunked SSD forward: (b, s, d) → (b, s, d). With
    ``return_state`` also the decode-ready state {"conv": the last d_conv −
    1 raw xBC inputs (before the conv) in x's dtype, "ssm": (b, h, p, n)
    f32}."""
    b, s, _ = x.shape
    zxbcdt = x @ params["w_in"]
    z, xbc_raw, dt = _split_in_proj(zxbcdt, cfg)
    xbc = _conv_region(cfg.d_conv)(xbc_raw, params["conv_w"], params["conv_b"])
    # whole over 'model' before the x / B / C lanes are sliced off it
    xbc = shard_act(xbc, ("batch", None, None))
    xs, b_h, c_h = _heads(xbc, cfg)  # (b, s, h, p), (b, s, h, n) x2
    xs = shard_act(xs, ("batch", None, "ssm_heads", None))
    dt, a = _dt_decay(dt, params, cfg)  # (b, s, h), (h,)
    xs_f = xs.to(torch.float32)
    y, state = _ssd_region(cfg.chunk, cfg.d_state)(xs_f, b_h, c_h, dt, dt * a)
    y = y + xs_f * params["d_skip"].to(torch.float32)[None, None, :, None]
    y = y.reshape(b, s, cfg.d_inner).to(x.dtype)
    out = rms_norm(y * swish(z), params["norm_w"]) @ params["w_out"]
    if not return_state:
        return out
    keep = cfg.d_conv - 1
    conv = xbc_raw[:, s - keep:] if s >= keep else F.pad(xbc_raw, (0, 0, keep - s, 0))
    return out, {"conv": conv.to(x.dtype), "ssm": state}


def mamba2_state_layout(cfg: Mamba2Config, batch: int, dtype) -> Dict[str, Leaf]:
    """The decode state's leaves: the conv window (b, d_conv − 1,
    conv_dim) in ``dtype`` and the SSM state (b, h, p, n) in f32."""
    return {"conv": Leaf((batch, cfg.d_conv - 1, cfg.conv_dim), dtype),
            "ssm": Leaf((batch, cfg.n_heads, cfg.head_dim, cfg.d_state), torch.float32)}


def mamba2_state_init(cfg: Mamba2Config, batch: int, dtype, device=None) -> Dict:
    """A zero decode state (``mamba2_state_layout``)."""
    return {k: leaf.new(device) for k, leaf in mamba2_state_layout(cfg, batch, dtype).items()}


def mamba2_decode_step(x: torch.Tensor, state: Dict[str, torch.Tensor],
                       params: Dict[str, torch.Tensor], cfg: Mamba2Config):
    """One recurrent step: x (b, 1, d) → (out (b, 1, d), the new state). On
    a data-split serve mesh it runs at the whole batch's row count
    (``whole_rows``: x gathered, the state this rank's rows padded)."""
    return serve_mesh.whole_rows(functools.partial(_decode_step, params=params, cfg=cfg), x,
                                 local=(state["conv"], state["ssm"]))


def _decode_step(x: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor,
                 params: Dict[str, torch.Tensor], cfg: Mamba2Config):
    b = x.shape[0]
    z, xbc, dt = _split_in_proj(x[:, 0] @ params["w_in"], cfg)
    conv_win = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # (b, d_conv, c)
    conv = torch.einsum("bkc,kc->bc", conv_win.to(torch.float32),
                        params["conv_w"].to(torch.float32)).to(conv_win.dtype)
    xbc = swish(conv + params["conv_b"])
    xs, b_h, c_h = _heads(xbc, cfg)  # (b, h, p), (b, h, n) x2
    dt, a = _dt_decay(dt, params, cfg)  # (b, h)
    xs_f = xs.to(torch.float32)
    ssm = ssm_state * torch.exp(dt * a)[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xs_f * dt[..., None], b_h.to(torch.float32))
    y = torch.einsum("bhpn,bhn->bhp", ssm, c_h.to(torch.float32))
    y = y + xs_f * params["d_skip"].to(torch.float32)[None, :, None]
    y = y.reshape(b, cfg.d_inner).to(x.dtype)
    out = (rms_norm(y * swish(z), params["norm_w"]) @ params["w_out"])[:, None, :]
    return out, {"conv": conv_win[:, 1:], "ssm": ssm}
