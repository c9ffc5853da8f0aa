"""Per-block int8 quantization of offloaded weight rows (the reference's
``kernels/quantize.py``, without the checksum lane).

Storage per (N, D) matrix: an int8 payload ``q = clip(round(w / scale),
-127, 127)`` and one f32 scale per ``block_rows`` rows,
``scale_b = max|w_block| / 127`` (a zero block gets scale 0 and payload 0).
Dequantization is ``q.float() * scale``, performed inside the gather
kernels and, elementwise identically, by the reference backend's twin.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

INT8_QMAX = 127.0
QUANT_BLOCK_ROWS = 8
QUANT_SUFFIX_PAYLOAD = "_q8"
QUANT_SUFFIX_SCALE = "_sc"


def quantize_rows(w: torch.Tensor, block_rows: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., N, D) → (int8 payload (..., N, D), f32 scales (..., N // block_rows));
    leading axes (stacked layers) are carried through."""
    *lead, n, d = w.shape
    if n % block_rows != 0:
        raise ValueError(f"rows ({n}) must be a multiple of block_rows ({block_rows})")
    nb = n // block_rows
    blocks = w.to(torch.float32).reshape(*lead, nb, block_rows, d)
    scales = blocks.abs().amax(dim=(-2, -1)) / INT8_QMAX
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.round(blocks / safe[..., None, None]).clamp(-INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8).reshape(*lead, n, d), scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor, block_rows: int = 8) -> torch.Tensor:
    """Inverse of ``quantize_rows``: f32 (N, D), exact ``q * scale``."""
    n, d = q.shape
    blocks = q.to(torch.float32).reshape(n // block_rows, block_rows, d)
    return (blocks * scales[:, None, None]).reshape(n, d)


def quantize_params(layers: Dict[str, torch.Tensor], names, block_rows: int = 8
                    ) -> Dict[str, torch.Tensor]:
    """The ``<name>_q8`` / ``<name>_sc`` leaves of the named stacked
    (L, N, D) weights (leading L kept); missing names are skipped. Layer by
    layer, so the f32 transient is one layer's (a whole (8, 8192, 28672)
    leaf of InternVL2-76B would take 7.5 GB at once); the result is the
    same as one ``quantize_rows`` over the stack."""
    out: Dict[str, torch.Tensor] = {}
    for name in names:
        if name not in layers:
            continue
        w = layers[name]
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty((*w.shape[:-2], w.shape[-2] // block_rows), dtype=torch.float32,
                        device=w.device)
        for layer in range(w.shape[0]):
            q[layer], s[layer] = quantize_rows(w[layer], block_rows)
        out[name + QUANT_SUFFIX_PAYLOAD] = q
        out[name + QUANT_SUFFIX_SCALE] = s
    return out
