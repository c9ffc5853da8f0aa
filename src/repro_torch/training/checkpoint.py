"""Checkpoints (the port's copy of ``repro.training.checkpoint``): the param
dict ⇄ ``params.npz`` + ``manifest.json``, in the reference's format, so a
checkpoint written by either package loads in the other; and the hot-cold
reorderings applied at load time.

Keys are the leaves' paths (``top`` or ``top/sub``). numpy's ``.npz`` has
no bf16, so a bf16 leaf is stored as f32 (lossless) and cast back to the
target leaf's dtype at load; the manifest records the stored dtypes.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.common import tree_leaves, tree_unflatten

# torch dtypes numpy stores as they are; the others (bf16) go as f32
_NATIVE = {torch.float32, torch.float64, torch.int32, torch.int64, torch.int8, torch.uint8,
           torch.float16, torch.bool}


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    leaf = leaf.detach().cpu()
    if leaf.dtype not in _NATIVE:
        leaf = leaf.to(torch.float32)
    return leaf.numpy()


def save_checkpoint(path: str, params, step: int = 0, extra: Optional[dict] = None):
    os.makedirs(path, exist_ok=True)
    flat = {key: _to_numpy(leaf) for key, leaf in tree_leaves(params)}
    np.savez(os.path.join(path, "params.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_checkpoint(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a param dict): each leaf
    takes the dtype and device of ``like``'s. Returns (params, step)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    with np.load(os.path.join(path, "params.npz")) as data:
        for key, leaf in tree_leaves(like):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(leaf.shape)}")
            out.append((key, torch.from_numpy(arr).to(leaf.dtype).to(leaf.device)))
    return tree_unflatten(out), manifest["step"]


def apply_row_permutations(params, perms: Dict[str, np.ndarray]):
    """Apply hot-cold reorderings at load time: ``perms`` maps a param path
    substring to a row permutation of dim 0 of the matching leaves of 2 or
    more dims whose dim 0 has the permutation's length. As in the
    reference, on the stacked tree dim 0 of a layer leaf is the layer axis:
    a permutation over d_model or d_ff rows leaves every stacked leaf as it
    was."""
    def visit(key, leaf):
        for pat, perm in perms.items():
            if pat in key and leaf.ndim >= 2 and leaf.shape[0] == perm.shape[0]:
                return leaf[torch.as_tensor(perm, device=leaf.device)]
        return leaf

    return tree_unflatten((key, visit(key, leaf)) for key, leaf in tree_leaves(params))
