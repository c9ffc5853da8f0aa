"""Decode execution backends: the selection → plan → kernel chain's last hop.

The planned decode path (``models/transformer.block_decode``) routes its
sparse projections through one of two implementations, chosen by
``ServeEngine(backend=...)`` / ``--backend``:

  * ``reference`` — the kernels' schedule twin in plain PyTorch
    (``blocked_masked_matmul``): the input is pre-masked by the exact mask
    and every 8-row block is contracted with the kernels' exact arithmetic,
    blocks added in ascending order. Blocks a chunk table skips see zeroed
    inputs and add an exact ±0, so the twin equals the kernel bitwise on
    any table covering the mask.
  * ``kernel`` — K1 (``chunk_gather_matmul_dma``) serves q/k/v and o off the
    plan's chunk tables, K2 (``chunk_gather_mlp_dma``) the fused SwiGLU MLP.

Both realize the same masked-matmul semantics (paper App. B.2); on one
device their decode tokens are byte-identical.

On a sharded serve mesh (``mesh``, sharding/serve.py) the decode-streamed
weights, scales and checksum lanes live model-sharded (DTensor slices);
``_gather`` all-gathers each operand over the model group at the compute
boundary, so the f32 accumulation runs over the whole table in the
single-device block order and the tokens equal the 1×1 mesh's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from .chunk_gather_dma import (
    BLOCK_ROWS,
    block_parts,
    chunk_gather_matmul_dma,
    chunk_gather_mlp_dma,
    swiglu_h,
)

BACKENDS = ("reference", "kernel")


def validate_backend(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(f"unknown execution backend {name!r}; expected one of {BACKENDS}")
    return name


def pick_tile(dim: int, cap: int = 128) -> int:
    """Largest power-of-two tile ≤ ``cap`` dividing ``dim`` (raises when no
    tile ≥ 8 divides — the kernel backend needs dims divisible by 8)."""
    t = cap
    while t >= 8:
        if dim % t == 0:
            return t
        t //= 2
    raise ValueError(f"dim {dim} has no power-of-two tile divisor >= 8 — the kernel "
                     "backend needs dims divisible by 8")


def blocked_masked_matmul(xm: torch.Tensor, w: torch.Tensor, block_rows: int = 8,
                          scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gather kernels' schedule twin: y (B, D) f32 = Σ over ascending
    8-row blocks of the exact block partial product of the pre-masked input
    ``xm`` (B, N) and ``w`` (N, D) (dequantized ``q.float() * scale`` per
    block when ``scales`` is given). The block partials are independent and
    computed together; only the order-sensitive f32 additions run one by
    one."""
    b, n = xm.shape
    if n % block_rows:
        raise ValueError(f"N={n} must be a multiple of block_rows={block_rows}")
    nb = n // block_rows
    xb = xm.to(torch.float32).reshape(b, nb, block_rows).permute(1, 0, 2)
    wb = w.to(torch.float32).reshape(nb, block_rows, w.shape[1])
    if scales is not None:
        wb = wb * scales.to(torch.float32)[:, None, None]
    parts = block_parts(xb, wb)
    acc = torch.zeros((b, w.shape[1]), dtype=torch.float32, device=xm.device)
    for k in range(nb):
        acc = acc + parts[k]
    return acc


@dataclasses.dataclass(frozen=True)
class ExecutionBackend:
    """Dispatch object carried by ``SparseExecution`` into the model blocks.
    ``prefetch_depth``: how far the kernels' ring may run ahead — any depth
    ≥ 0, as in the reference; on the card the ring runs at
    ``min(depth, MAX_PREFETCH_DEPTH)`` (numerics are depth-invariant).
    ``mesh``: the serve mesh's ``DeviceMesh`` (None unsharded), whose
    sharded operands ``_gather`` makes whole."""

    name: str = "reference"
    prefetch_depth: int = 1
    block_rows: int = BLOCK_ROWS
    max_chunk_rows: int = 512
    mesh: Any = None

    @staticmethod
    def create(name: str = "reference", prefetch_depth: int = 1,
               block_rows: int = BLOCK_ROWS, max_chunk_rows: int = 512,
               mesh: Any = None) -> "ExecutionBackend":
        validate_backend(name)
        if prefetch_depth < 0:
            raise ValueError(f"prefetch_depth must be >= 0, got {prefetch_depth}")
        return ExecutionBackend(name=name, prefetch_depth=prefetch_depth,
                                block_rows=block_rows, max_chunk_rows=max_chunk_rows, mesh=mesh)

    @property
    def is_kernel(self) -> bool:
        return self.name == "kernel"

    def _gather(self, w):
        """A (possibly model-sharded) weight, scales or checksum operand made
        whole at the compute boundary: its slices all-gathered over the
        model group in rank order (row order for the row-sharded matrices,
        column order for the rest). The identity without a mesh, and on a
        tensor that is whole already."""
        if self.mesh is None or w is None:
            return w
        from ..sharding.serve import gather_shards

        return gather_shards(w)

    def project(self, w: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                starts: torch.Tensor, sizes: torch.Tensor,
                scales: Optional[torch.Tensor] = None,
                checksums: Optional[torch.Tensor] = None) -> torch.Tensor:
        """y (B, D) f32 = (x · mask) @ w, the input pre-masked by the exact
        mask on both backends. ``checksums``: the kernel fetches each
        block's integrity word through its ring (verified at the refresh,
        not here); the twin, whose operands never leave device memory,
        ignores it. Bit-identical either way."""
        xm = (x * mask.to(x.dtype)).to(torch.float32)
        w, scales, checksums = self._gather(w), self._gather(scales), self._gather(checksums)
        if self.is_kernel:
            return chunk_gather_matmul_dma(
                w, xm, starts, sizes, scales, checksums, block_rows=self.block_rows,
                max_chunk_rows=self.max_chunk_rows, prefetch_depth=self.prefetch_depth,
            )
        return blocked_masked_matmul(xm, w, self.block_rows, scales)

    def swiglu_mlp(self, w_gate, w_up, w_down, x, hidden_mask, ffn_mask, starts, sizes,
                   scales: Optional[Tuple] = None,
                   checksums: Optional[Tuple] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (y (B, D) f32, h (B, F) f32) where h is the UNMASKED
        SwiGLU intermediate — the next refresh's ffn-site importance.
        ``checksums`` (cg, cu, cd): the kernel's integrity lanes, fetched
        only (see ``project``)."""
        xm = (x * hidden_mask.to(x.dtype)).to(torch.float32)
        fm = ffn_mask.to(torch.float32)
        w_gate, w_up, w_down = self._gather(w_gate), self._gather(w_up), self._gather(w_down)
        if scales is not None:
            scales = tuple(self._gather(t) for t in scales)
        if checksums is not None:
            checksums = tuple(self._gather(t) for t in checksums)
        if self.is_kernel:
            return chunk_gather_mlp_dma(
                w_gate, w_up, w_down, xm, starts, sizes, fm, scales, checksums,
                block_rows=self.block_rows, max_chunk_rows=self.max_chunk_rows,
                prefetch_depth=self.prefetch_depth, return_h=True,
            )
        sg, su, sd = scales if scales is not None else (None, None, None)
        h = swiglu_h(blocked_masked_matmul(xm, w_gate, self.block_rows, sg),
                     blocked_masked_matmul(xm, w_up, self.block_rows, su))
        y = blocked_masked_matmul(h * fm[None, :], w_down, self.block_rows, sd)
        return y, h
