"""SwiGLU MLP, dense and planned-sparse (the port's copy of the swiglu
parts of ``repro.models.mlp``).

The planned decode path routes through ``swiglu_mlp_planned``: one
execution-backend call for gate/up/down off the decode plan's (2, K)
chunk-table lanes — the kernel schedule twin (``reference``) or kernel K2
(``kernel``), bitwise identical on one device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels.quantize import QUANT_SUFFIX_CHECKSUM, QUANT_SUFFIX_PAYLOAD, QUANT_SUFFIX_SCALE
from .common import swish


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
