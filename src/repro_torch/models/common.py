"""Shared model building blocks: norms, RoPE, activations, sinusoidal
positions and the causal mask (the port's copy of ``repro.models.common``;
params are plain dicts of tensors); the per-layer views of stacked leaves
the per-layer rematerialisation of the training forward; and the flat
view of the nested param dict (paths ``top`` or ``top/sub``); ``Leaf``, a
cache leaf described before it is made.

A parameter table maps each leaf's name to (shape, init std or
'ones'/'zeros', logical axes): the reference's ``ParamDef``, so the axes
that shard a leaf come from the table that makes it."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint


# the logical axes of a decoder block's leaves (the reference's ParamDefs
# of ``attention_param_defs``, the norms, ``mlp_param_defs`` and
# ``gelu_mlp_param_defs``)
BLOCK_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "ln1_w": ("embed",), "ln1_b": ("embed",), "ln2_w": ("embed",), "ln2_b": ("embed",),
    "wq": ("embed", "heads"), "wk": ("embed", "kv_heads"), "wv": ("embed", "kv_heads"),
    "wo": ("heads", "embed"),
    "w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"), "w_down": ("ffn", "embed"),
    "w_fc": ("embed", "ffn"), "b_fc": ("ffn",), "w_proj": ("ffn", "embed"),
    "b_proj": ("embed",),
}


def with_axes(shapes: Dict[str, tuple], axes: Dict[str, tuple]) -> Dict[str, tuple]:
    """{name: (shape, std)} → {name: (shape, std, axes[name])}."""
    return {name: (shape, std, axes[name]) for name, (shape, std) in shapes.items()}


def unstack(stacked: Dict[str, torch.Tensor], lead: int = 1) -> List[Dict[str, torch.Tensor]]:
    """Every layer's params of leaves stacked over ``lead`` leading dims, in
    order (row-major over those dims): one ``torch.unbind`` a leaf. Under
    autograd the backward of an unbind stacks the layers' gradients once,
    where indexing the leaf layer by layer writes a zero tensor the size of
    the whole leaf for each layer."""
    names = list(stacked)
    per_leaf = [stacked[n].flatten(0, lead - 1).unbind(0) for n in names]
    return [dict(zip(names, leaves)) for leaves in zip(*per_leaf)]


def rematerialised(fn: Callable, remat: bool) -> Callable:
    """``fn`` as it is, or with ``remat`` under ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint``): the backward recomputes its
    activations instead of keeping them. The forward draws no random
    numbers, so no RNG state is kept for the recomputation."""
    if not remat:
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def tree_leaves(tree) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path "top" or "top/sub", leaf) of a nested dict, keys sorted at
    every level: the order of ``jax.tree.leaves`` over the reference's
    tree."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            for sub, leaf in tree_leaves(val):
                yield f"{key}/{sub}", leaf
        else:
            yield key, val


def tree_map(fn, tree):
    """``fn`` over every leaf of a nested dict, the nesting kept."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def tree_unflatten(pairs) -> Dict[str, Any]:
    """The nested dict of (path, leaf) pairs (``tree_leaves``' inverse)."""
    tree: Dict[str, Any] = {}
    for path, leaf in pairs:
        *tops, last = path.split("/")
        node = tree
        for top in tops:
            node = node.setdefault(top, {})
        node[last] = leaf
    return tree


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A tensor not made yet: its whole shape, dtype and fill value. A
    cache is described as a tree of these (``Model``'s ``cache_layout``),
    so that under mesh rules each rank can make only its block."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    fill: float = 0.0

    def new(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device``."""
        return torch.full(self.shape, self.fill, dtype=self.dtype, device=device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with a bias, in f32 and cast back (the reference's
    biased variance)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of gelu (``jax.nn.gelu``'s default)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def sinusoidal_positions(n_pos: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (n_pos, dim), f32: computed in
    numpy float64 and rounded once, as the reference does."""
    pos = np.arange(n_pos)[:, None]
    idx = np.arange(dim // 2)[None, :]
    angles = pos / np.power(10000.0, 2 * idx / dim)
    emb = np.concatenate([np.sin(angles), np.cos(angles)], axis=-1)
    return torch.tensor(emb, dtype=torch.float32, device=device)


def causal_mask(q_len: int, kv_len: int, q_offset, device=None) -> torch.Tensor:
    """(q_len, kv_len) bool mask: query i attends key j iff j <= i + offset."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    return kj <= qi


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
