"""ServeMesh: the serve stack's (data, model) mesh (the port's copy of
``repro.sharding.serve``) on a ``torch.distributed`` ``DeviceMesh``.

The reference is SPMD under GSPMD: one process, global arrays. The port is
SPMD over ranks: one process per device, each holding its share, with the
collectives written out. Sharding moves where bytes live and stream, never
what arithmetic runs: greedy tokens on any (data, model) mesh are
byte-identical to the 1×1 mesh at wbits 16 and 8, by the reference's three
rules.

  * **Selection is replicated.** Before any cross-batch reduction (a site's
    importance, the mean over the batch) the activations are gathered over
    the ``data`` group in data-rank order (``replicate``), so every rank sums
    the full batch in the 1×1 order and selects the same chunks.
  * **Only decode-streamed leaves shard over ``model``.** At wbits 8 these
    are the ``_q8``/``_sc`` leaves; at wbits 16 ``<name>_dec`` copies, while
    the originals stay whole for prefill and frame append. Each rank holds
    its slice at rest as a DTensor ``Shard(dim)`` (its local tensor is the
    slice); ``ExecutionBackend._gather`` all-gathers the slices over the
    ``model`` group at the compute boundary, in row order for
    ``wo``/``w_down``/``w_proj`` and in column order for the rest, and
    K1/K2 or their twin then run over the whole table in the single-device
    block order.
  * **Row slices own whole 8-row quantization blocks.** A row-sharded
    matrix needs rows % (model × QUANT_BLOCK_ROWS) == 0 (``weight_spec``,
    ``row_shard_count``, ``validate_serve_mesh``'s d_ff check), so the
    per-shard block tables and byte counters align with storage.

Serve slots partition over ``data``: each data rank holds batch / data rows
of the tokens and the KV cache (``put_batch``, ``place_cache``), and the
engine's outputs are gathered back to the full batch in row order
(``gather_batch``), as the reference returns its global arrays. Weight
specs come from ``MeshRules`` over the matrices' logical axes, so the serve
mesh uses the training side's vocabulary.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..kernels.quantize import (
    DECODE_COPY_SUFFIX,
    QUANT_BLOCK_ROWS,
    QUANT_SUFFIX_PAYLOAD,
    QUANT_SUFFIX_SCALE,
)
from ..launch.mesh import TORCHRUN_HINT, make_mesh, world_size
from ..models.common import BLOCK_AXES
from .specs import MeshRules, Spec

MESH_AXES = ("data", "model")

# logical axes of the offloaded per-layer matrices, from the decoder
# block's parameter table (the leading dim is the stacked layer axis).
# MeshRules maps heads/kv_heads/ffn → 'model' and embed → replicated, so
# matrices whose STREAMED row dim carries a model axis shard by rows (wo,
# w_down, w_proj) and the rest by output columns.
DECODE_WEIGHT_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    name: ("layer",) + BLOCK_AXES[name]
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_fc", "w_down", "w_proj")
}

# weights whose ROW (streamed) dim shards over 'model': their sites
# ('attn_out' streams wo rows, 'ffn' streams w_down/w_proj rows) carry the
# per-shard block tables and miss counters
ROW_SHARDED_WEIGHTS = ("wo", "w_down", "w_proj")


def validate_serve_mesh(data: int, model: int, *, batch: int = 0, streams: int = 0,
                        d_ff: int = 0, n_devices: Optional[int] = None) -> None:
    """The sharded serve path's static preconditions, with the reference's
    messages (``n_devices`` is the world size: the hint names torchrun where
    the reference names XLA_FLAGS). Zero-valued optional dims skip their
    check."""
    if data < 1 or model < 1:
        raise ValueError(f"--mesh axes must be >= 1, got data={data} model={model}")
    if n_devices is not None and data * model > n_devices:
        raise ValueError(
            f"--mesh {data},{model} needs {data * model} devices but only {n_devices} are "
            f"visible; shrink the mesh or {TORCHRUN_HINT.format(n=data * model)}")
    if batch and batch % data != 0:
        raise ValueError(
            f"--batch {batch} must be divisible by the mesh data axis ({data}) — each data "
            f"shard serves batch/data slot rows; use --batch "
            f"{((batch + data - 1) // data) * data} or shrink data")
    if streams and streams % data != 0:
        raise ValueError(
            f"--streams {streams} must be divisible by the mesh data axis ({data}) so every "
            f"data shard serves the same number of streams; use --streams "
            f"{((streams + data - 1) // data) * data} or shrink data")
    if d_ff and d_ff % (model * QUANT_BLOCK_ROWS) != 0:
        raise ValueError(
            f"ffn rows ({d_ff}) must be divisible by model × the {QUANT_BLOCK_ROWS}-row quant "
            f"block ({model} × {QUANT_BLOCK_ROWS} = {model * QUANT_BLOCK_ROWS}) so each model "
            "shard owns whole quantization blocks of w_down; pick a mesh whose model axis "
            "divides d_ff/8")


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in group-
    rank order: one collective into one preallocated buffer. Along dim 0
    the buffer is the result; along another dim the ranks' slices are
    viewed on a new leading dim and moved into place (a view on one rank,
    one copy on more). A failed collective raises."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    # all_gather_single is the name since torch 2.13 (all_gather_into_tensor,
    # the same collective, is deprecated there and the only one before)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    gather(out, x, group=group)
    if dim == 0:
        return out
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).flatten(dim, dim + 1)


def gather_shards(w):
    """A DTensor leaf's whole tensor: its local slice all-gathered over the
    mesh group of every dim it is ``Shard``ed on, in rank order; a plain
    tensor (replicated, or no mesh) comes back as it is."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(w, DTensor):
        return w
    out = w.to_local()
    for mesh_dim, placement in enumerate(w.placements):
        if isinstance(placement, Shard):
            out = _all_gather(out, w.device_mesh.get_group(mesh_dim), placement.dim)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class ServeMesh:
    """The serve engine's mesh. ``mesh is None`` ⇔ the unsharded 1×1 path:
    every method is the identity there, so one-device code pays nothing. A
    ``ServeMesh(1, 1, mesh, rules)`` built on a one-rank ``DeviceMesh`` runs
    the sharded code path with lanes of width 1."""

    data: int
    model: int
    mesh: Any = None  # a torch.distributed DeviceMesh over ("data", "model")
    rules: Optional[MeshRules] = None

    @staticmethod
    def single() -> "ServeMesh":
        return ServeMesh(1, 1, None, None)

    @staticmethod
    def create(data: int = 1, model: int = 1, device: str = "cuda") -> "ServeMesh":
        """The (data, model) mesh over the process group's ranks (joining
        the one torchrun set up); the inert single mesh at 1×1."""
        validate_serve_mesh(data, model, n_devices=world_size())
        if data * model == 1:
            return ServeMesh.single()
        mesh = make_mesh((data, model), MESH_AXES, torch.device(device).type)
        return ServeMesh(data, model, mesh, MeshRules.for_mesh(mesh))

    @staticmethod
    def from_spec(spec: str, device: str = "cuda") -> "ServeMesh":
        """Parse a ``--mesh data,model`` string (e.g. "2,2")."""
        data, model = parse_mesh_spec(spec)
        return ServeMesh.create(data, model, device)

    @property
    def is_sharded(self) -> bool:
        return self.mesh is not None

    @property
    def size(self) -> int:
        return self.data * self.model

    def rank(self, axis: str) -> int:
        """This process's coordinate on ``axis`` (0 unsharded)."""
        return self.mesh.get_local_rank(axis) if self.is_sharded else 0

    # -- batch rows over 'data' ------------------------------------------------
    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's batch rows (dim 0) → every data rank's, in data-rank
        order: the whole batch the 1×1 mesh holds. Applied to activations
        before any cross-batch reduction, so its f32 summation order does
        not depend on the mesh."""
        if not self.is_sharded:
            return x
        return _all_gather(x, self.mesh.get_group("data"), 0)

    def put_replicated(self, tree: Any) -> Any:
        """Every rank holds the whole tree already (each process builds or
        loads the same params): replicated placement is the tree itself."""
        return tree

    def batch_spec(self, shape: Tuple[int, ...], axis: int = 0) -> Spec:
        spec: list = [None] * len(shape)
        if self.is_sharded and shape[axis] % self.data == 0:
            spec[axis] = "data"
        return tuple(spec)

    def _rows(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        n = x.shape[axis] // self.data
        return x.narrow(axis, self.rank("data") * n, n)

    def put_batch(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This data rank's rows of ``x``'s batch dim (the whole ``x`` when
        it does not divide)."""
        if not self.is_sharded or x.shape[axis] % self.data:
            return x
        return self._rows(x, axis)

    def gather_batch(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The inverse of ``put_batch``: every data rank's rows along
        ``axis``, in row order."""
        if not self.is_sharded:
            return x
        return _all_gather(x, self.mesh.get_group("data"), axis)

    def place_cache(self, cache: Any, axes: Any) -> Any:
        """This rank's share of a KV/state cache: dims named "batch" (and a
        paged pool's "kv_page") keep this data rank's rows (a copy, so the
        whole cache is not kept alive), where they divide; every other dim
        and leaf stays whole. ``axes``: the model's ``cache_axes()`` /
        ``paged_cache_axes()`` tree."""
        if not self.is_sharded:
            return cache

        def rec(c, a):
            if isinstance(c, dict):
                return {k: rec(v, a.get(k) if isinstance(a, dict) else None)
                        for k, v in c.items()}
            if isinstance(c, (tuple, list)):
                sub = a if isinstance(a, (tuple, list)) and len(a) == len(c) else (None,) * len(c)
                return type(c)(rec(v, sa) for v, sa in zip(c, sub))
            if not isinstance(c, torch.Tensor):
                return c
            names = tuple(a) if isinstance(a, (tuple, list)) else ()
            for i, name in enumerate(names[: c.ndim]):
                if name in ("batch", "kv_page") and c.shape[i] % self.data == 0:
                    c = self._rows(c, i)
            return c.clone()

        return rec(cache, axes)

    # -- decode-weight sharding -----------------------------------------------
    def weight_spec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        """The spec of one stacked (L, N, D) decode-streamed leaf from its
        logical axes, with the serve rule that a row-sharded slice is whole
        8-row blocks; () (replicate) for other names or indivisible dims."""
        axes = DECODE_WEIGHT_AXES.get(name)
        if axes is None or self.rules is None:
            return ()
        spec = self.rules.spec(axes, shape)
        if name in ROW_SHARDED_WEIGHTS and shape[1] % (self.model * QUANT_BLOCK_ROWS) != 0:
            return ()
        return spec

    def scale_spec(self, weight_spec: Spec) -> Spec:
        """The spec of a weight's (L, N / 8) scale lane: rows shard with the
        payload's rows (whole blocks per shard), otherwise replicated."""
        if len(weight_spec) >= 2 and weight_spec[1] is not None:
            return (None, weight_spec[1])
        return ()

    def _distribute(self, full: torch.Tensor, spec: Spec):
        """``full`` as a DTensor holding this rank's slice of each dim the
        spec names a mesh axis for."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        local = full
        placements = []
        for axis in MESH_AXES:
            dims = [d for d, s in enumerate(spec) if s == axis]
            if dims:
                d = dims[0]
                n = full.shape[d] // self.data if axis == "data" else full.shape[d] // self.model
                local = local.narrow(d, self.rank(axis) * n, n)
                placements.append(Shard(d))
            else:
                placements.append(Replicate())
        return DTensor.from_local(local.clone(), self.mesh, placements, run_check=False,
                                  shape=full.shape, stride=full.stride())

    def place_params(self, params: Dict[str, Any], wbits: int,
                     sparse_names: Tuple[str, ...]) -> Dict[str, Any]:
        """Decode-streamed leaves of the stacked layers shard over ``model``
        (the ``_q8``/``_sc`` leaves at wbits 8, in place of the whole ones;
        fresh ``<name>_dec`` copies at 16, the originals staying whole for
        prefill and frame append); every other leaf stays as it is. The
        identity when unsharded."""
        if not self.is_sharded:
            return params
        layers = dict(params["layers"])
        for name in sparse_names:
            if name not in layers:
                continue
            if wbits == 8:
                qn, sn = name + QUANT_SUFFIX_PAYLOAD, name + QUANT_SUFFIX_SCALE
                if qn not in layers:
                    continue
                wspec = self.weight_spec(name, tuple(layers[qn].shape))
                layers[qn] = self._distribute(layers[qn], wspec)
                layers[sn] = self._distribute(layers[sn], self.scale_spec(wspec))
            else:
                wspec = self.weight_spec(name, tuple(layers[name].shape))
                if wspec:  # only a copy that shards is made
                    layers[name + DECODE_COPY_SUFFIX] = self._distribute(layers[name], wspec)
        return {**params, "layers": layers}

    # -- per-shard accounting geometry ------------------------------------------
    def row_shard_count(self, n_rows: int) -> int:
        """How many model-axis row slices an ``n_rows``-row site splits into:
        ``model`` when each slice is whole 8-row blocks, else 1 (its bytes
        then split evenly)."""
        if not self.is_sharded or n_rows % (self.model * QUANT_BLOCK_ROWS) != 0:
            return 1
        return self.model


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """``"data,model"`` → (data, model), with the reference's messages."""
    parts = spec.split(",")
    if len(parts) != 2:
        raise ValueError(f"--mesh must be 'data,model' (e.g. 2,2), got {spec!r}")
    try:
        data, model = (int(p) for p in parts)
    except ValueError:
        raise ValueError(f"--mesh axes must be integers, got {spec!r}") from None
    return data, model


def shard_block_tables(starts, sizes, n_rows: int, n_shards: int):
    """Intersect a site's chunk table (starts, sizes) with each model shard's
    contiguous row range ``[s·n_rows/n_shards, (s+1)·n_rows/n_shards)``:
    per-shard (starts, sizes) of shape (n_shards, K), the global table's K,
    entries outside a shard's range clipped to size 0. Per-shard sizes sum
    to the global sum, every surviving chunk lies inside its shard's range,
    and block-aligned starts stay aligned (n_rows divides into whole 8-row
    blocks per shard). Takes tensors or numpy arrays; returns int32 tensors
    on the input's device."""
    if n_rows % (n_shards * QUANT_BLOCK_ROWS) != 0:
        raise ValueError(f"n_rows={n_rows} must divide into {n_shards} shards of whole "
                         f"{QUANT_BLOCK_ROWS}-row blocks")
    starts = torch.as_tensor(starts).to(torch.int64)
    sizes = torch.as_tensor(sizes).to(device=starts.device, dtype=torch.int64)
    seg = n_rows // n_shards
    lo = torch.arange(n_shards, device=starts.device)[:, None] * seg  # (S, 1)
    hi = lo + seg
    s = starts[None, :]
    e = s + sizes[None, :]
    cs = torch.minimum(torch.maximum(s, lo), hi)
    ce = torch.minimum(torch.maximum(e, lo), hi)
    return cs.to(torch.int32), torch.clamp(ce - cs, min=0).to(torch.int32)
