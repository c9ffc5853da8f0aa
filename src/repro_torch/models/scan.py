"""A recurrence run chunk by chunk with the chunk boundaries checkpointed
(the port's counterpart of the reference's ``lax.scan`` over
``jax.checkpoint``ed chunks, ``repro.models.xlstm``).

``chunked_scan(step, xs, ws, state, chunk, y_shape)`` runs ``step`` over
dim 1 of the sequence inputs ``xs``. The forward keeps only the state at
each chunk's start. The backward walks the chunks from the last to the
first: it recomputes a chunk's steps from its start state and takes their
gradients, so one chunk's activations are alive at a time, not every
step's. A tail chunk (s not a multiple of ``chunk``) runs only its own
steps, and a sequence shorter than a chunk is one short chunk: a decode
step is one step.

The chunking changes no value: every step is the same ops on the same
inputs, and the backward adds each gradient in the order the whole
sequence's graph would. Each step's inputs and weights are leaves of their
own, so no gradient passes through a slice of a longer tensor; a state
crossing a chunk boundary arrives as the seed of the earlier chunk's
backward, ahead of the chunk's own terms, as the later steps' terms
arrive first in one graph; the weights' gradients are summed step by step
from the last step back across chunks. So any ``chunk`` gives bitwise the
outputs, states and gradients of one chunk as long as the sequence
(``tests/test_torch_xlstm_chunks.py``).

The dry run (``launch/dryrun.py``) installs its ``CostCounter`` with
``counting_chunks``. Under it a scan runs its first full chunk and any
tail chunk, and adds the first full chunk's FLOPs, bytes and collectives
once for every other full chunk, in the forward and in the backward: the
reference's ``analyze_hlo`` counts a ``while`` body once times its trip
count. It still allocates every output and boundary state at full size,
so the live-memory high-water mark sees them. Every full chunk runs the
same ops, the first included (its start state is a leaf of the backward
like any other), so the counts equal those of a trace of every step.
Outside ``counting_chunks`` every step runs.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import torch

# the dry run's counter while it counts one chunk for all (None: run every
# step). Process-wide, not per thread, like the installed mesh rules: a
# backward may run in autograd's device thread
_counter = None


def chunk_counter():
    """The installed ``CostCounter``, or None."""
    return _counter


@contextlib.contextmanager
def counting_chunks(counter):
    """Within it, chunked scans count one full chunk for all (the module
    doc)."""
    global _counter
    prev, _counter = _counter, counter
    try:
        yield counter
    finally:
        _counter = prev


def _bounds(s: int, chunk: int):
    return [(t0, min(t0 + chunk, s)) for t0 in range(0, s, chunk)]


def _plan(bounds, chunk: int, counter) -> Tuple[Optional[int], set]:
    """(the full chunk that is counted for all, the full chunks skipped)
    under ``counter``; (None, no chunk) without one."""
    full = [i for i, (t0, t1) in enumerate(bounds) if t1 - t0 == chunk]
    if counter is None or len(full) < 2:
        return None, set()
    return full[0], set(full[1:])


def _measured(counter, traced: bool):
    return counter.measured() if traced else contextlib.nullcontext({})


class _ChunkedScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, step, chunk, y_shape, nx, nw, *tensors):
        xs, ws, state = tensors[:nx], tensors[nx: nx + nw], tuple(tensors[nx + nw:])
        b, s = xs[0].shape[:2]
        bounds = _bounds(s, chunk)
        counter = chunk_counter()
        traced, skipped = _plan(bounds, chunk, counter)
        keep = any(ctx.needs_input_grad)
        y = xs[0].new_empty((b, s, *y_shape))
        starts, delta = [], {}
        for ci, (t0, t1) in enumerate(bounds):
            if ci in skipped:
                if keep:
                    with counter.uncounted():
                        starts.append(tuple(torch.empty_like(t) for t in state))
                continue
            if keep:
                starts.append(state)
            with _measured(counter, ci == traced) as d:
                for t in range(t0, t1):
                    state, yt = step(state, *(x[:, t] for x in xs), *ws)
                    y[:, t].copy_(yt)
            delta = d or delta
        if skipped:
            counter.add(delta, len(skipped))
        ctx.step, ctx.chunk, ctx.nx, ctx.nw, ctx.ns = step, chunk, nx, nw, len(state)
        if keep:
            ctx.save_for_backward(*xs, *ws, *(t for st in starts for t in st))
        return (y, *state)

    @staticmethod
    def backward(ctx, gy, *g_state):
        nx, nw, ns = ctx.nx, ctx.nw, ctx.ns
        saved = ctx.saved_tensors
        xs, ws = saved[:nx], saved[nx: nx + nw]
        flat = saved[nx + nw:]
        starts = [flat[i: i + ns] for i in range(0, len(flat), ns)]
        s = xs[0].shape[1]
        bounds = _bounds(s, ctx.chunk)
        counter = chunk_counter()
        traced, skipped = _plan(bounds, ctx.chunk, counter)
        gxs = [torch.empty_like(x) for x in xs]
        gws = [torch.zeros_like(w) for w in ws]
        g_state, delta = tuple(g_state), {}
        for ci in reversed(range(len(bounds))):
            if ci in skipped:
                continue
            t0, t1 = bounds[ci]
            with _measured(counter, ci == traced) as d:
                g_state = _chunk_grads(ctx.step, xs, ws, starts[ci], t0, t1, gy, g_state,
                                       gxs, gws)
            delta = d or delta
        if skipped:
            counter.add(delta, len(skipped))
        return (None, None, None, None, None, *gxs, *gws, *g_state)


def _chunk_grads(step, xs, ws, start, t0, t1, gy, g_state, gxs, gws):
    """Recompute steps t0..t1-1 from ``start`` and take their gradients:
    each step's input gradients go to its slot of ``gxs``, the weights'
    are added into ``gws`` from the last step back; returns the gradient
    of ``start``."""
    with torch.enable_grad():
        st = tuple(t.detach().requires_grad_() for t in start)
        state, outs, leaves = st, [], []
        for t in range(t0, t1):
            xt = [x[:, t].detach().requires_grad_() for x in xs]
            wt = [w.detach().requires_grad_() for w in ws]
            state, yt = step(state, *xt, *wt)
            outs.append(yt)
            leaves.append(xt + wt)
        grads = torch.autograd.grad(
            outs + list(state), list(st) + [leaf for step_leaves in leaves for leaf in step_leaves],
            [gy[:, t] for t in range(t0, t1)] + list(g_state), allow_unused=True)
    n, per = len(st), len(xs) + len(ws)
    g_start = tuple(torch.zeros_like(a) if g is None else g for g, a in zip(grads[:n], st))
    for j in reversed(range(t1 - t0)):
        g_step = grads[n + j * per: n + (j + 1) * per]
        for i, g in enumerate(g_step[: len(xs)]):
            if g is not None:
                gxs[i][:, t0 + j].copy_(g)
        for i, g in enumerate(g_step[len(xs):]):
            if g is not None:
                gws[i] = gws[i] + g
    return g_start


def chunked_scan(step: Callable, xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                 state: Tuple[torch.Tensor, ...], chunk: int, y_shape: Tuple[int, ...]):
    """``step(state, *x_t, *ws) → (state, y_t)`` over t of the (b, s, ...)
    sequence inputs ``xs`` (``x_t = x[:, t]``), with weights ``ws`` used at
    every step, from ``state``; y_t is (b, *y_shape) in ``xs[0]``'s dtype.
    Returns (y (b, s, *y_shape), the state after the last step). Chunked
    and checkpointed as the module doc says."""
    out = _ChunkedScan.apply(step, chunk, tuple(y_shape), len(xs), len(ws), *xs, *ws, *state)
    return out[0], tuple(out[1:])
