"""Per-block int8 quantization of offloaded weight rows and the pack-time
checksum lane (the reference's ``kernels/quantize.py``).

Storage per (N, D) matrix: an int8 payload ``q = clip(round(w / scale),
-127, 127)`` and one f32 scale per ``block_rows`` rows,
``scale_b = max|w_block| / 127`` (a zero block gets scale 0 and payload 0).
Dequantization is ``q.float() * scale``, performed inside the gather
kernels and, elementwise identically, by the reference backend's twin.

The integrity lane ``<name>_ck``: one checksum word per ``block_rows`` rows
of the STORED payload (the int8 leaf at wbits 8, the bf16 leaf at 16; the
bf16 twin is ``core/offload.pack_checksums``), verified against the fetched
bytes at the refresh (``serving/sparse_exec.py``). The words are the
reference's uint32 values, held as int32 with the same bits: the kernels
take them as raw 4-byte words.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

INT8_QMAX = 127.0
CHECKSUM_BYTES = 4.0  # one checksum word per block_rows rows
QUANT_BLOCK_ROWS = 8
QUANT_SUFFIX_PAYLOAD = "_q8"
QUANT_SUFFIX_SCALE = "_sc"
QUANT_SUFFIX_CHECKSUM = "_ck"
_U32 = 0xFFFFFFFF
# blocks checksummed at once: bounds the int64 transient (a 28672-column
# bf16 matrix takes 64 · 8 · 28672 · 8 bytes = 117 MB a pass)
_CK_CHUNK_BLOCKS = 64


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


def _payload_words(w: torch.Tensor) -> torch.Tensor:
    """The payload's elements as unsigned words in int64, bit for bit (no
    value conversion): int8 → its byte, 16-bit floats → their 16 bits, f32
    → its 32 bits. The checksum runs over exactly the bits the kernels
    stream."""
    size = w.element_size()
    if size == 1:
        return w.view(torch.uint8).to(torch.int64)
    if size == 2:
        return w.view(torch.int16).to(torch.int64) & 0xFFFF
    if size == 4:
        return w.view(torch.int32).to(torch.int64) & _U32
    raise ValueError(f"unsupported payload dtype {w.dtype}")


def _to_i32(words: torch.Tensor) -> torch.Tensor:
    """Words in [0, 2^32) (int64) → int32 with the same 32 bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def checksum_words(blocks: torch.Tensor) -> torch.Tensor:
    """(..., block_rows, D) payload blocks → (...,) checksums as int64 in
    [0, 2^32): Σ over the block's words in row-major order of
    word · (2·pos + 1) mod 2^32. Each product is reduced mod 2^32 before
    the sum, so nothing overflows int64: a word < 2^32 times a weight
    below 2^31 fits, and so does the sum of a block's (< 2^31) terms of
    < 2^32 each while the block holds under 2^31 words."""
    *lead, rows, d = blocks.shape
    u = _payload_words(blocks).reshape(*lead, rows * d)
    pos = torch.arange(rows * d, dtype=torch.int64, device=blocks.device)
    return ((u * (2 * pos + 1)) & _U32).sum(dim=-1) & _U32


def block_checksums(w: torch.Tensor, block_rows: int = 8) -> torch.Tensor:
    """Per-``block_rows``-block payload checksum of (..., N, D) → (..., N //
    block_rows) int32 holding the reference's uint32 words: each block's
    bytes as unsigned words, folded as a position-weighted sum mod 2^32
    with odd weights ``2·pos + 1`` (a single changed element moves the sum
    by an odd multiple of a nonzero delta, never 0 mod 2^32; the weights
    also catch reorderings inside a block). Leading axes are carried; the
    blocks go ``_CK_CHUNK_BLOCKS`` at a time."""
    *lead, n, d = w.shape
    if n % block_rows != 0:
        raise ValueError(f"rows ({n}) must be a multiple of block_rows ({block_rows})")
    nb = n // block_rows
    blocks = w.reshape(-1, nb, block_rows, d)
    out = torch.empty(blocks.shape[:2], dtype=torch.int32, device=w.device)
    for b0 in range(0, nb, _CK_CHUNK_BLOCKS):
        out[:, b0:b0 + _CK_CHUNK_BLOCKS] = _to_i32(
            checksum_words(blocks[:, b0:b0 + _CK_CHUNK_BLOCKS]))
    return out.reshape(*lead, nb)


def quantize_params(layers: Dict[str, torch.Tensor], names, block_rows: int = 8,
                    checksums: bool = False) -> Dict[str, torch.Tensor]:
    """The ``<name>_q8`` / ``<name>_sc`` leaves of the named stacked
    (L, N, D) weights (leading L kept); missing names are skipped. Layer by
    layer, so the f32 transient is one layer's (a whole (8, 8192, 28672)
    leaf of InternVL2-76B would take 7.5 GB at once); the result is the
    same as one ``quantize_rows`` over the stack. ``checksums=True`` adds
    the ``<name>_ck`` lane over the int8 payload — the bytes the kernels
    stream at wbits 8."""
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
        if checksums:
            out[name + QUANT_SUFFIX_CHECKSUM] = block_checksums(q, block_rows)
    return out
