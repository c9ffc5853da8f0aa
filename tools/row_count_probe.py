#!/usr/bin/env python3
"""How a product's rounding follows its row count, on this host's CPU: for
each product of the serve paths, at a model's full widths, the largest
absolute difference between a data rank's rows computed alone and the
same rows of the whole batch's product, and between those rows computed
padded with zeros to the whole batch's row count (what
``ServeMesh.whole_rows`` does with a rank's cache) and the whole batch's.

    PYTHONPATH=src python3 tools/row_count_probe.py [--trials 3] [--threads 1]

Inputs are standard normals from a numpy seed (weights scaled by 1/√fan-in,
a head by 0.02, the init scales of ``Model.init``); the rank's rows are the
last ``rows`` of ``whole``. Prints one line a product and, last, a JSON
object of the same numbers. Imports only the port.
"""
import argparse
import json
import math

import numpy as np
import torch

from repro_torch.models.attention import _direct_attention, attend_appended, decode_attention


def _matmul(d_in, d_out, dtype, std=None):
    """A product x (b, d_in) @ W (d_in, d_out), W drawn once a trial."""
    def make(rng, b):
        w = rng.normal(0, std or 1 / math.sqrt(d_in), (d_in, d_out))
        return (rng.normal(0, 1, (b, d_in)),), (w,)
    return make, lambda x, w: x @ w, dtype


def _einsum(eq, row_shapes, fixed_shapes, dtype):
    """``torch.einsum(eq, *rows, *fixed)``: ``rows`` carry the batch (dim 0)."""
    def make(rng, b):
        return (tuple(rng.normal(0, 1, (b,) + s) for s in row_shapes),
                tuple(rng.normal(0, 0.02, s) for s in fixed_shapes))
    return make, lambda *t: torch.einsum(eq, *t), dtype


def _cross_attention(frames, heads=12, head_dim=64):
    """Whisper's decode cross-attention core: one query over the encoder's
    keys and values (``_direct_attention``, no mask)."""
    def make(rng, b):
        return tuple(rng.normal(0, 1, (b, n, heads, head_dim))
                     for n in (1, frames, frames)), ()
    return make, lambda q, k, v: _direct_attention(q, k, v, None), torch.bfloat16


def _frame_attention(tokens, heads=32, kv_heads=4, head_dim=64, phys=64, length=32):
    """A frame append's attention core (``attend_appended``) at TinyLlama's
    heads: ``tokens`` new positions against a cache of ``phys``."""
    def make(rng, b):
        return tuple(rng.normal(0, 1, s) for s in (
            (b, tokens, heads * head_dim), (b, tokens, kv_heads * head_dim),
            (b, tokens, kv_heads * head_dim), (b, phys, kv_heads, head_dim),
            (b, phys, kv_heads, head_dim))), ()

    def run(q, k, v, lk, lv):
        return attend_appended(q, k, v, lk.clone(), lv.clone(), length, heads, kv_heads,
                               head_dim, 10000.0)
    return make, run, torch.bfloat16


def _decode_attention(heads=32, kv_heads=4, head_dim=64, phys=64, length=32):
    """The decode attention over the KV cache (``decode_attention``)."""
    def make(rng, b):
        return tuple(rng.normal(0, 1, s) for s in (
            (b, 1, heads * head_dim), (b, phys, kv_heads, head_dim),
            (b, phys, kv_heads, head_dim))), ()

    def run(q, lk, lv):
        return decode_attention(q, lk, lv, length, heads, kv_heads, head_dim, 10000.0,
                                torch.bfloat16)
    return make, run, torch.bfloat16


BF16, F32 = torch.bfloat16, torch.float32
# (name, whose, rows alone, rows whole, the product)
PRODUCTS = [
    ("2048 -> 5632", "TinyLlama MLP, a frame of 8 tokens x batch 2", 8, 16,
     _matmul(2048, 5632, BF16)),
    ("2048 -> 5632", "TinyLlama MLP, a frame of 64 tokens x batch 2", 64, 128,
     _matmul(2048, 5632, BF16)),
    ("2048 -> 5632", "TinyLlama MLP, decode", 1, 2, _matmul(2048, 5632, BF16)),
    ("2048 -> 32000", "TinyLlama LM head", 1, 2, _matmul(2048, 32000, BF16, 0.02)),
    ("8192 -> 1024", "InternVL2-76B k/v", 1, 2, _matmul(8192, 1024, BF16)),
    ("4608 -> 49152", "StarCoder2-7B LM head", 1, 2, _matmul(4608, 49152, BF16, 0.02)),
    ("3072 -> 49152", "StarCoder2-3B LM head", 1, 2, _matmul(3072, 49152, BF16, 0.02)),
    ("3584 -> 32000", "Zamba2-7B LM head", 1, 2, _matmul(3584, 32000, BF16, 0.02)),
    ("768 -> 1536", "xLSTM-125M mLSTM w_up half, f32", 1, 2, _matmul(768, 1536, F32)),
    ("768 -> 50304", "xLSTM-125M LM head, f32", 1, 2, _matmul(768, 50304, F32, 0.02)),
    ("bhpn,bhn->bhp (112, 64, 64)", "Zamba2-7B Mamba2 state readout, f32", 1, 2,
     _einsum("bhpn,bhn->bhp", [(112, 64, 64), (112, 64)], [], F32)),
    ("bhvk,bhk->bhv (4, 384, 384)", "xLSTM-125M mLSTM C . q, f32", 1, 2,
     _einsum("bhvk,bhk->bhv", [(4, 384, 384), (4, 384)], [], F32)),
    ("bhk,hkj->bhj (4, 192, 768)", "xLSTM-125M sLSTM recurrent mix, f32", 1, 2,
     _einsum("bhk,hkj->bhj", [(4, 192)], [(4, 192, 768)], F32)),
    ("attention, 1 query x 16 keys", "Whisper-small cross-attention, 16 frames", 1, 2,
     _cross_attention(16)),
    ("attention, 1 query x 1500 keys", "Whisper-small cross-attention, 1500 frames", 1, 2,
     _cross_attention(1500)),
    ("frame attention, 1 token", "TinyLlama frame append core", 1, 2, _frame_attention(1)),
    ("frame attention, 8 tokens", "TinyLlama frame append core", 1, 2, _frame_attention(8)),
    ("decode attention", "TinyLlama decode, over the KV cache", 1, 2, _decode_attention()),
]


def probe(make, run, dtype, rows, whole, trials, seed):
    """(largest |alone − whole|, largest |padded − whole|) over the trials,
    on the whole batch's last ``rows`` rows."""
    alone_d = padded_d = 0.0
    rng = np.random.default_rng(seed)
    for _ in range(trials):
        row_in, fixed = make(rng, whole)
        row_in = [torch.from_numpy(a).to(dtype) for a in row_in]
        fixed = [torch.from_numpy(a).to(dtype) for a in fixed]
        full = run(*row_in, *fixed)[whole - rows:].float()
        alone = run(*(t[whole - rows:] for t in row_in), *fixed).float()
        pads = []
        for t in row_in:
            p = torch.zeros_like(t)
            p[whole - rows:] = t[whole - rows:]
            pads.append(p)
        padded = run(*pads, *fixed)[whole - rows:].float()
        alone_d = max(alone_d, float((alone - full).abs().max()))
        padded_d = max(padded_d, float((padded - full).abs().max()))
    return alone_d, padded_d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    print(f"torch {torch.__version__}, {args.threads} thread(s), {args.trials} trials")
    out = []
    for i, (name, whose, rows, whole, (make, run, dtype)) in enumerate(PRODUCTS):
        alone, padded = probe(make, run, dtype, rows, whole, args.trials, args.seed + i)
        out.append({"product": name, "whose": whose, "rows": rows, "whole": whole,
                    "alone_max_abs": alone, "padded_max_abs": padded})
        print(f"{name:32s} {rows:3d} / {whole:3d} rows  alone {alone:.3g}  padded {padded:.3g}"
              f"  ({whose})", flush=True)
    print(json.dumps({"torch": torch.__version__, "threads": args.threads, "products": out}))


if __name__ == "__main__":
    main()
