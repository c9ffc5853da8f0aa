"""The dense decoders' MLPs, dense and planned-sparse (the port's copy of
the swiglu and gelu parts of ``repro.models.mlp``).

The planned decode path routes the SwiGLU MLP through
``swiglu_mlp_planned``: one execution-backend call for gate/up/down off the
decode plan's (2, K) chunk-table lanes — the kernel schedule twin
(``reference``) or kernel K2 (``kernel``), bitwise identical on one device.
The non-gated gelu MLP (StarCoder2's c_fc/c_proj, with biases) takes
``gelu_mlp_planned``: two single-site ``backend.project`` calls (K1 each on
the kernel backend) with the f32 bias adds and the gelu between them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels.quantize import QUANT_SUFFIX_CHECKSUM, QUANT_SUFFIX_PAYLOAD, QUANT_SUFFIX_SCALE
from .common import gelu, swish


def _stored(params, name: str, quantized: bool):
    """One matrix in the planned path's storage form: (int8 payload,
    per-block scales) at wbits=8, (bf16 weight, None) otherwise."""
    if quantized:
        return params[name + QUANT_SUFFIX_PAYLOAD], params[name + QUANT_SUFFIX_SCALE]
    return params[name], None


def _stored_checksum(params, name: str):
    """The matrix's per-block checksum lane (the engine packs it when
    corruption injection is on), or None."""
    return params.get(name + QUANT_SUFFIX_CHECKSUM)


def swiglu_mlp(x: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dense SwiGLU (prefill)."""
    return (swish(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]


def swiglu_mlp_planned(x: torch.Tensor, params: Dict[str, torch.Tensor], backend,
                       hidden_mask: torch.Tensor, ffn_mask: torch.Tensor,
                       starts: torch.Tensor, sizes: torch.Tensor,
                       quantized: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planned-decode sparse SwiGLU. Returns (y (b, s, d) in x.dtype,
    h (b·s, d_ff) f32 — the UNMASKED intermediate whose |·| is the next
    refresh's ffn-site importance). The checksum lanes, where the params
    carry them, ride along to the kernel."""
    b, s, d = x.shape
    wg, sg = _stored(params, "w_gate", quantized)
    wu, su = _stored(params, "w_up", quantized)
    wd, sd = _stored(params, "w_down", quantized)
    cks = tuple(_stored_checksum(params, nm) for nm in ("w_gate", "w_up", "w_down"))
    y, h = backend.swiglu_mlp(wg, wu, wd, x.reshape(b * s, d), hidden_mask, ffn_mask,
                              starts, sizes, (sg, su, sd) if quantized else None,
                              cks if all(c is not None for c in cks) else None)
    return y.to(x.dtype).reshape(b, s, -1), h


def gelu_mlp(x: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dense non-gated gelu MLP with biases (prefill), in x's dtype."""
    h = gelu(x @ params["w_fc"] + params["b_fc"])
    return h @ params["w_proj"] + params["b_proj"]


def gelu_mlp_planned(x: torch.Tensor, params: Dict[str, torch.Tensor], backend,
                     hidden_mask: torch.Tensor, ffn_mask: torch.Tensor,
                     hidden_table: Tuple[torch.Tensor, torch.Tensor],
                     ffn_table: Tuple[torch.Tensor, torch.Tensor],
                     quantized: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planned-decode sparse gelu MLP: two single-site projections off the
    hidden_mlp and ffn tables, each f32 bias added after its call and the
    gelu in f32 between them (the same ops on both backends, so their
    parity rests on ``project`` alone). Returns (y (b, s, d) in x.dtype,
    mid (b·s, d_ff) f32 — post-gelu, before the ffn mask: the next
    refresh's ffn-site importance)."""
    b, s, d = x.shape
    w_fc, s_fc = _stored(params, "w_fc", quantized)
    w_proj, s_proj = _stored(params, "w_proj", quantized)
    mid = backend.project(w_fc, x.reshape(b * s, d), hidden_mask, *hidden_table, s_fc,
                          _stored_checksum(params, "w_fc")) + params["b_fc"].to(torch.float32)
    mid = gelu(mid)
    y = backend.project(w_proj, mid, ffn_mask, *ffn_table, s_proj,
                        _stored_checksum(params, "w_proj")) + params["b_proj"].to(torch.float32)
    return y.to(x.dtype).reshape(b, s, -1), mid
