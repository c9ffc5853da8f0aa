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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.utils.checkpoint

from .. import resolve_device
from ..models.common import tree_leaves, tree_map, tree_unflatten
from ..models.model import Model
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state


def _chunk_nll(h: torch.Tensor, t: torch.Tensor, ok: torch.Tensor,
               head: torch.Tensor) -> torch.Tensor:
    """One chunk's summed negative log-likelihood over its valid positions:
    logits as a product in the hidden dtype, cast to f32."""
    logits = (h @ head.to(h.dtype)).to(torch.float32)  # (b, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t[..., None].to(torch.int64))[..., 0]
    return ((lse - gold) * ok).sum()


def _chunked_softmax_xent(hidden: torch.Tensor, targets: torch.Tensor, head: torch.Tensor,
                          loss_chunk: int) -> torch.Tensor:
    """Mean next-token cross entropy of hidden (b, s, d) against targets
    (b, s) under ``head`` (d, V): the sequence padded to a multiple of
    ``loss_chunk``, the padded positions masked out, the sum divided by the
    unpadded b·s. A 0-d f32 tensor."""
    b, s, _ = hidden.shape
    pad = (-s) % loss_chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
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

    def init_state(self, seed: int = 0, device=None) -> Tuple[Any, OptState]:
        """Seeded random params on ``device`` (default ``cuda``; no card
        raises) and a fresh optimizer state."""
        params = self.model.init(seed=seed, device=resolve_device(device))
        return params, init_opt_state(params)

    def train_step(self, params, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        """(params, opt_state, batch) → (params, opt_state, {"loss", "ce",
        "moe_aux", "grad_norm", "lr"}, 0-d f32 tensors on the device). The
        params and the moments are updated in place; nothing syncs with the
        host."""
        tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
        paths, leaves = zip(*tree_leaves(tree))
        with torch.enable_grad():
            loss, parts = lm_loss(self.model, tree, batch, self.loss_chunk)
            grads = tree_unflatten(zip(paths, torch.autograd.grad(loss, leaves)))
        del tree, leaves
        params, opt_state, opt_metrics = adamw_update(self.opt, params, grads, opt_state)
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "moe_aux": parts["moe_aux"].detach(), **opt_metrics}
        return params, opt_state, metrics
