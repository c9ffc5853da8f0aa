"""AdamW and its schedule (the port's copy of ``repro.training.optimizer``):
plain functions over the port's param dict, no ``torch.optim``.

The state holds f32 moments ("master" moments) shaped like the params and
a 0-d int32 step on the params' device. Weight decay is decoupled, the
gradients are clipped by their global norm (in f32), and each param is
updated in f32 and rounded to its dtype once — ``torch.optim.AdamW``
would update a bf16 param in bf16, which rounds differently. The update
writes into the params and moments in place, under ``torch.no_grad()``,
with the values of the reference's functional update; nothing here syncs
with the host.

On a mesh the params are DTensors: each moment takes its param's
placements (the dry-run's ``OptState(m=params_sh, v=params_sh)``), each
gradient is brought to them, and the update runs on every rank's local
block, which it writes in place. The global norm is the norm of the whole
tensors: each leaf's sum of squares is reduced over the mesh before the
leaves are added.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``: a 0-d f32
    tensor (``step``: an int or an integer tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any  # a dict like params, f32
    v: Any  # a dict like params, f32


def init_opt_state(params) -> OptState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    device = next(tree_leaves(params))[1].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value, the same plain tensor on every rank (a
    collective); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32, leaf by leaf in
    the reference's order; a plain 0-d tensor (a DTensor leaf's sum is
    reduced over its mesh first)."""
    total = 0
    for _, leaf in tree_leaves(tree):
        total = total + whole(torch.sum(torch.square(leaf.to(torch.float32))))
    return torch.sqrt(total)


def _local(p: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``p`` laid out as the DTensor ``like`` (the
    tensor itself, under no_grad, so writes reach the DTensor); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return p
    if p.placements != like.placements:
        p = p.redistribute(like.device_mesh, like.placements)
    return p.to_local()


def _decays(p: torch.Tensor) -> bool:
    """Weight decay for leaves of 2 or more dims (the reference's mask): on
    the stacked tree that takes in the (L, d) norm weights and biases,
    though not the top-level ``final_norm_w``."""
    return p.ndim >= 2


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: (params, new state, {"grad_norm", "lr"}). The params
    and the state's moments are updated in place and returned."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    g_leaves = dict(tree_leaves(grads))
    m_leaves, v_leaves = dict(tree_leaves(state.m)), dict(tree_leaves(state.v))
    for path, leaf in tree_leaves(params):
        p = _local(leaf, leaf)
        g = _local(g_leaves[path], leaf).to(torch.float32) * scale
        m, v = _local(m_leaves[path], leaf), _local(v_leaves[path], leaf)
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.to(torch.float32)
        if _decays(leaf):
            update = update + cfg.weight_decay * pf
        p.copy_(pf - lr * update)
    return params, OptState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}
