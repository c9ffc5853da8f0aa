"""Training step (the port's copy of ``repro.training.train_step``): the
chunked cross-entropy LM loss plus the MoE auxiliary loss, gradients by
``torch.autograd.grad`` over the param leaves, then AdamW.

The loss walks the sequence in chunks of ``loss_chunk`` positions, so the
f32 logits of one chunk exist at a time; each chunk's loss is
rematerialised (``torch.utils.checkpoint``), so the backward too keeps one
chunk's logits at a time instead of every chunk's. The recomputation
repeats the same products on the same inputs, so the values are those of
the plain loss.

Alignment (``text_offset``): an early-fusion VLM prepends ``n_front``
visual positions to the residual stream; token t is predicted from hidden
position ``n_front + t - 1``. For a plain LM and the encoder-decoder
(offset 0) this is the shift by one.

On a mesh (``MeshRules`` installed with ``sharding.use_rules``) the params
are DTensors placed by ``Model.param_axes()`` (``Trainer.init_state``
with ``rules``), the batch enters sharded over the batch axis, and the
forward and backward run under ``sharding.sharded_compute``; the loss is
reduced to its whole value before the backward, and the metrics come out
as plain tensors, the same on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor

from .. import resolve_device
from ..models.common import tree_leaves, tree_map, tree_unflatten
from ..models.model import Model
from ..sharding.specs import current_rules, shard_act, sharded_compute
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state, whole

# the logical axes of a batch's tensors (the dry-run's ``batch_axes``)
BATCH_AXES = {"tokens": ("batch", None), "frontend": ("batch", None, None)}


def _chunk_nll(h: torch.Tensor, t: torch.Tensor, ok: torch.Tensor,
               head: torch.Tensor) -> torch.Tensor:
    """One chunk's summed negative log-likelihood over its valid positions:
    logits as a product in the hidden dtype, cast to f32."""
    logits = (h @ head.to(h.dtype)).to(torch.float32)  # (b, chunk, V)
    logits = shard_act(logits, ("batch", None, "vocab"))
    lse = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # the gold logit as a masked sum over the (sharded) vocab: one
        # non-zero term, so the value is the gather's
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(vocab == t[..., None].to(torch.int64), logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, t[..., None].to(torch.int64))[..., 0]
    return ((lse - gold) * ok).sum()


def _chunked_softmax_xent(hidden: torch.Tensor, targets: torch.Tensor, head: torch.Tensor,
                          loss_chunk: int) -> torch.Tensor:
    """Mean next-token cross entropy of hidden (b, s, d) against targets
    (b, s) under ``head`` (d, V): the sequence padded to a multiple of
    ``loss_chunk``, the padded positions masked out, the sum divided by the
    unpadded b·s. A 0-d f32 tensor."""
    b, s, d = hidden.shape
    pad = (-s) % loss_chunk
    if pad:  # zero rows and targets (a concatenation: DTensor's pad is unreliable)
        hidden = torch.cat([hidden, hidden.new_zeros((b, pad, d))], dim=1)
        targets = torch.cat([targets, targets.new_zeros((b, pad))], dim=1)
    valid = torch.arange(s + pad, device=hidden.device) < s
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, s + pad, loss_chunk):
        piece = slice(c, c + loss_chunk)
        total = total + torch.utils.checkpoint.checkpoint(
            _chunk_nll, hidden[:, piece], targets[:, piece], valid[None, piece], head,
            use_reentrant=False, preserve_rng_state=False)
    return total / (b * s)


def lm_loss(model: Model, params, batch: Dict[str, torch.Tensor], loss_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy over the token positions plus the MoE aux
    loss: (loss, {"ce", "moe_aux"}), 0-d f32 tensors. The head is
    ``embed.T`` when the embeddings are tied."""
    hidden, aux = model.forward(params, batch)
    hidden = shard_act(hidden, ("batch", None, "act_embed"))  # the loss chunks the sequence
    tokens = batch["tokens"]
    offset = 0
    if not model.cfg.is_encdec and "frontend" in batch:
        offset = batch["frontend"].shape[1]
    if offset > 0:
        # predict tokens[t] from hidden[offset + t - 1], every t
        hid = hidden[:, offset - 1: offset - 1 + tokens.shape[1]]
        tgt = tokens
    else:
        hid = hidden[:, :-1]
        tgt = tokens[:, 1:]
    head = params["embed"].T if model.cfg.tie_embeddings else params["head"]
    ce = _chunked_softmax_xent(hid, tgt, head, loss_chunk)
    return ce + aux, {"ce": ce, "moe_aux": aux}


@dataclasses.dataclass(frozen=True, eq=False)
class Trainer:
    """A model, its optimizer config and the loss chunk: ``train_step``."""

    model: Model
    opt: AdamWConfig = AdamWConfig()
    loss_chunk: int = 512

    def init_state(self, seed: int = 0, device=None, rules=None) -> Tuple[Any, OptState]:
        """Seeded random params on ``device`` (default ``cuda``; no card
        raises) and a fresh optimizer state. With ``rules`` every rank
        makes the whole seeded params and keeps its blocks of them, placed
        by ``Model.param_axes()``: the values are the unsharded init's."""
        params = self.model.init(seed=seed, device=resolve_device(device))
        if rules is not None:
            params = rules.place(params, self.model.param_axes())
        return params, init_opt_state(params)

    def train_step(self, params, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        """(params, opt_state, batch) → (params, opt_state, {"loss", "ce",
        "moe_aux", "grad_norm", "lr"}, 0-d f32 tensors on the device). The
        params and the moments are updated in place; nothing syncs with the
        host. Under installed rules a whole (plain) batch tensor is laid
        out over the batch axis first, each rank keeping its rows."""
        rules = current_rules()
        if rules is not None:
            batch = {k: v if isinstance(v, DTensor) else rules.distribute(v, BATCH_AXES[k])
                     for k, v in batch.items()}
        tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
        paths, leaves = zip(*tree_leaves(tree))
        with torch.enable_grad(), sharded_compute():
            loss, parts = lm_loss(self.model, tree, batch, self.loss_chunk)
            loss = whole(loss)
            grads = tree_unflatten(zip(paths, torch.autograd.grad(loss, leaves)))
        del tree, leaves
        params, opt_state, opt_metrics = adamw_update(self.opt, params, grads, opt_state)
        metrics = {"loss": loss.detach(), "ce": whole(parts["ce"]).detach(),
                   "moe_aux": whole(parts["moe_aux"]).detach(), **opt_metrics}
        return params, opt_state, metrics
