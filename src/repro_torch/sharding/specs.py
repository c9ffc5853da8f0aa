"""Logical-axis sharding rules (the port's copy of ``repro.sharding.specs``).

Model code names the axes of its tensors *logically* ("batch", "heads",
"ffn", ...); a ``MeshRules`` object maps those names to the axes of a mesh
("pod", "data", "model"). A spec is a tuple with one entry per tensor dim:
the mesh axis (or tuple of axes) that dim is split over, or None; trailing
Nones are dropped, as ``PartitionSpec`` prints them in the reference.

Resolution is two-pass with divisibility and used-axis tracking:
  pass 1: each dim takes its primary mesh axis if the axis divides the dim
          and is not used already in this spec ("structure" dims — heads,
          ffn, vocab, experts — before batch dims, before the rest);
  pass 2: dims still unassigned may take a fallback axis (a KV cache whose
          kv heads cannot split over 'model' shards its sequence instead).

Logical axes:
  batch            → ('pod','data')      act_seq        → 'model'
  heads/kv_heads   → 'model'             ffn/vocab      → 'model'
  embed (weights)  → 'data' iff FSDP     expert         → 'model'
  expert_capacity  → ('pod','data')      ssm_heads      → 'model'
  cache_kv_heads   → 'model'             cache_seq      → fallback 'model'
  conv_dim         → 'model'             layer/state/…  → replicated

DTensor is the port's GSPMD: ``MeshRules.placements`` turns a spec into
DTensor placements (one per mesh dim), ``MeshRules.place`` distributes a
param tree by its logical axes (``Model.param_axes``), and ``shard_act``
— the reference's ``with_sharding_constraint`` — redistributes an
activation to its logical layout. Between those points DTensor's sharding
propagation places every intermediate, as XLA's does in the reference;
the values never depend on the layout, only the order of a cross-rank sum
does. With no rules installed ``shard_act`` is the identity: the serve
path (which reads the rules to place its decode weights,
``ServeMesh.weight_spec``, and never installs them), the tests and the
one-card runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from ..models.common import tree_leaves, tree_unflatten

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]


def mesh_axis_sizes(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of a ``torch.distributed`` ``DeviceMesh`` (its
    ``mesh_dim_names`` and ``size(dim)``) or of a mesh-like object with
    ``axis_names`` and a ``shape`` dict (the reference tests' fakes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {name: int(mesh.size(i)) for i, name in enumerate(names)}
    return {name: int(mesh.shape[name]) for name in mesh.axis_names}


@dataclasses.dataclass(frozen=True, eq=False)
class MeshRules:
    """Maps logical axis names → mesh axes (primary + optional fallback)."""

    mesh: Any
    rules: Dict[str, Axis]
    fallbacks: Dict[str, Axis]
    fsdp: bool = False
    seq_shard_attention: bool = False

    @staticmethod
    def for_mesh(mesh: Any, fsdp: bool = False) -> "MeshRules":
        names = tuple(mesh_axis_sizes(mesh))
        dp: Axis = tuple(a for a in ("pod", "data") if a in names) or None
        if isinstance(dp, tuple) and len(dp) == 1:
            dp = dp[0]
        tp: Axis = "model" if "model" in names else None
        rules: Dict[str, Axis] = {
            "batch": dp,
            "act_seq": tp,
            "act_embed": None,
            "heads": tp,
            "kv_heads": tp,
            "head_dim": None,
            "ffn": tp,
            "embed": ("data" if (fsdp and "data" in names) else None),
            "vocab": tp,
            "expert": tp,
            "expert_capacity": dp,
            "ssm_heads": tp,
            "conv_dim": tp,
            "state": None,
            "layer": None,
            "cache_seq": None,
            "cache_kv_heads": tp,
        }
        fallbacks: Dict[str, Axis] = {
            "cache_seq": tp,  # when the kv heads cannot take the model axis
            "expert": "data",  # tiny expert counts at decode time
            "act_seq": tp,  # attention's sequence when heads do not divide tp
        }
        return MeshRules(mesh=mesh, rules=rules, fallbacks=fallbacks, fsdp=fsdp)

    def axis_size(self, axis: Axis) -> int:
        if axis is None:
            return 1
        sizes = mesh_axis_sizes(self.mesh)
        if isinstance(axis, tuple):
            return int(math.prod(sizes[a] for a in axis))
        return int(sizes[axis])

    @staticmethod
    def _axis_names(axis: Axis) -> Tuple[str, ...]:
        if axis is None:
            return ()
        return axis if isinstance(axis, tuple) else (axis,)

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
        """The mesh axes of each dim of a tensor whose dims are named
        ``logical`` (and sized ``shape``, when given: an axis that does not
        divide its dim is not taken), trailing Nones dropped."""
        n = len(logical)
        out: list = [None] * n
        used: set = set()

        def fits(axis: Axis, dim: Optional[int]) -> bool:
            if axis is None:
                return False
            if any(a in used for a in self._axis_names(axis)):
                return False
            return dim is None or dim % self.axis_size(axis) == 0

        # model-parallel "structure" dims claim their axis before batch dims,
        # and those before the rest (a 36-head tensor must not lose 'model'
        # to its sequence dim because the sequence comes first)
        priority = {"heads": 0, "kv_heads": 0, "cache_kv_heads": 0, "ffn": 0,
                    "vocab": 0, "expert": 0, "ssm_heads": 0, "conv_dim": 0,
                    "batch": 1, "expert_capacity": 1}
        order = sorted(range(n), key=lambda i: priority.get(logical[i] or "", 2))
        for i in order:
            name = logical[i]
            axis = self.rules.get(name) if name else None
            dim = shape[i] if shape is not None else None
            if fits(axis, dim):
                out[i] = axis
                used.update(self._axis_names(axis))
        for i, name in enumerate(logical):
            if out[i] is not None or not name:
                continue
            axis = self.fallbacks.get(name)
            dim = shape[i] if shape is not None else None
            if fits(axis, dim):
                out[i] = axis
                used.update(self._axis_names(axis))
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def placements(self, logical: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None) -> tuple:
        """The DTensor placements of ``spec(logical, shape)`` on this
        rules' ``DeviceMesh``, one per mesh dim: ``Shard(i)`` where the spec
        puts that mesh axis on dim i (a dim on a tuple of axes, such as
        ("pod", "data"), shards over each of them, major to minor),
        ``Replicate()`` where it puts it nowhere."""
        from torch.distributed.tensor import Replicate, Shard

        spec = self.spec(logical, shape)
        on = {a: i for i, axis in enumerate(spec) for a in self._axis_names(axis)}
        return tuple(Shard(on[name]) if name in on else Replicate()
                     for name in mesh_axis_sizes(self.mesh))

    def block_shape(self, shape: Sequence[int], placements: tuple) -> Tuple[int, ...]:
        """This rank's block of a tensor of ``shape`` laid out as
        ``placements``: each sharded dim divided by the sizes of the mesh
        dims that shard it (``spec`` takes only axes that divide)."""
        from torch.distributed.tensor import Shard

        local = list(shape)
        for mesh_dim, p in enumerate(placements):
            if isinstance(p, Shard):
                local[p.dim] //= self.mesh.size(mesh_dim)
        return tuple(local)

    def full(self, shape: Sequence[int], logical: Sequence[Optional[str]],
             fill: Optional[float], dtype: torch.dtype, device=None):
        """A DTensor of ``shape`` filled with ``fill`` (left empty where it
        is None), laid out by its logical axes, of which this rank
        allocates only its block: nothing of the whole size is made."""
        pl = self.placements(logical, shape)
        block = self.block_shape(shape, pl)
        local = (torch.empty(block, dtype=dtype, device=device) if fill is None
                 else torch.full(block, fill, dtype=dtype, device=device))
        return wrap_local(local, self.mesh, pl, shape)

    def distribute(self, x: torch.Tensor, logical: Sequence[Optional[str]]):
        """A whole tensor (the same on every rank) as a DTensor laid out by
        its logical axes: each rank keeps its slice, nothing is sent."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x, self.mesh, self.placements(logical, x.shape),
                                 src_data_rank=None)

    def place(self, params, axes):
        """Every leaf of a param tree distributed by the same-structured
        tree of logical axes (``Model.param_axes()``): the reference
        dry-run's ``_shardings_for`` applied to the values."""
        ax = dict(tree_leaves(axes))
        return tree_unflatten((path, self.distribute(leaf, ax[path]))
                              for path, leaf in tree_leaves(params))


# the installed rules: process-wide, not per thread (the reference's are
# thread-local), because a rematerialised layer's forward runs again in the
# backward, which on a card runs in autograd's own device thread, and it
# must see the rules the forward saw
_installed: Optional[MeshRules] = None


def set_rules(rules: Optional[MeshRules]) -> None:
    global _installed
    _installed = rules


def current_rules() -> Optional[MeshRules]:
    return _installed


@contextlib.contextmanager
def use_rules(rules: Optional[MeshRules]):
    prev = current_rules()
    set_rules(rules)
    try:
        yield rules
    finally:
        set_rules(prev)


def logical_to_spec(logical: Sequence[Optional[str]], shape=None) -> Spec:
    """The installed rules' spec of ``logical`` (() with none installed)."""
    rules = current_rules()
    if rules is None:
        return ()
    return rules.spec(logical, shape)


def mesh_placements(mesh: Any, dims: Dict[Axis, int], partial: Axis = None) -> tuple:
    """DTensor placements on ``mesh`` from {mesh axis (or tuple of axes,
    or None): tensor dim}: ``Shard(dim)`` on each named axis, ``Partial()``
    on the ``partial`` axes, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    on = {a: dim for axis, dim in dims.items() for a in MeshRules._axis_names(axis)}
    summed = MeshRules._axis_names(partial)
    return tuple(Shard(on[name]) if name in on else Partial() if name in summed else Replicate()
                 for name in mesh_axis_sizes(mesh))


def local_shard(x, placements: tuple, grad_placements: Optional[tuple] = None) -> torch.Tensor:
    """This rank's block of the DTensor ``x`` laid out as ``placements``
    (differentiable). ``grad_placements`` declares the layout of the
    gradient that comes back (default: ``placements``): ``Partial`` on a
    mesh axis over which the ranks' local gradients are parts of a sum,
    as a replicated operand used on sharded data gets them."""
    x = x.redistribute(x.device_mesh, placements)
    return x.to_local(grad_placements=grad_placements)


def wrap_local(local: torch.Tensor, mesh: Any, placements: tuple, shape) -> Any:
    """The DTensor of ``shape`` whose block on this rank is ``local`` (made
    contiguous), laid out as ``placements`` (differentiable;
    ``local_shard``'s inverse)."""
    from torch.distributed.tensor import DTensor

    # the whole tensor's contiguous strides, computed: an empty tensor on the
    # meta device would be a whole-size allocation to the dry run's counter
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def replicated(fn):
    """``fn`` run on whole tensors on every rank where the installed rules
    leave DTensor no sharding strategy to follow (Whisper's lookup of its
    decoder positions by computed indices): each DTensor argument is
    gathered whole, ``fn`` runs on the local copies, each tensor it returns
    is a replicated DTensor. Every rank computes the same values, so the
    gradients that come back are replicated too. The identity with no
    rules installed."""
    @functools.wraps(fn)
    def run(*args):
        rules = current_rules()
        if rules is None:
            return fn(*args)
        from torch.distributed.tensor import DTensor

        whole = mesh_placements(rules.mesh, {})
        out = fn(*(local_shard(a, whole) if isinstance(a, DTensor) else a for a in args))

        def wrap(o):
            if isinstance(o, torch.Tensor) and o.is_floating_point():
                return DTensor.from_local(o, rules.mesh, whole, run_check=False)
            return o

        return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)

    return run


class _GradOnFirstModelRank(torch.autograd.Function):
    """The identity, whose gradient is kept on model rank 0 and zero on the
    others: the gradient of a value every model rank computed whole, fed
    into sums over the model ranks (``over_batch``'s partial gradients),
    so that it is counted once."""

    @staticmethod
    def forward(ctx, x, first: bool):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


class _SumGradOverModel(torch.autograd.Function):
    """The identity on a block laid out as ``placements`` (whole over
    'model'), whose gradient, each model rank's part of a sum, is summed
    over 'model' (one all-reduce): it leaves replicated, as a gradient of a
    whole operand does. Left partial, it would make DTensor run the
    products it flows back through whole on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial

        names = tuple(mesh_axis_sizes(ctx.mesh))
        parts = tuple(Partial() if name == "model" else p
                      for name, p in zip(names, ctx.placements))
        summed = DTensor.from_local(g, ctx.mesh, parts, run_check=False)
        return summed.redistribute(ctx.mesh, ctx.placements).to_local(), None, None


def over_batch(fn, weights: Tuple[int, ...] = (), model: Optional[Dict[int, int]] = None,
               out_model=None):
    """``fn`` run on local blocks where the installed rules leave DTensor no
    sharding strategy to follow (the xLSTM recurrences, chunked scans over
    time, ``models/scan.py``; Mamba2's causal conv and SSD scan). Every
    argument but the ``weights`` (their positions) has the batch as dim 0
    and is taken local over the batch axes (whole where they do not divide
    it); the weights are taken whole over them, their gradients partial
    sums over the batch axes. Each tensor ``fn`` returns, in nested tuples,
    has the batch as dim 0 too.

    Over 'model' every argument is taken whole, unless ``model`` = {position:
    dim} names some to be taken local along ``dim`` and a model axis over 1
    divides each of those dims: each model rank then runs its share of the
    work. The other arguments stay whole on every model rank, and each
    rank's share adds a part to their gradients, which are summed over
    'model' as they leave; ``out_model`` mirrors what ``fn`` returns: for
    each tensor the dim along which it comes back local over 'model', or
    None for one every model rank computed whole (its gradient is counted
    on model rank 0 only, so those sums stay exact). A plain tensor
    argument counts as replicated. The identity with no rules installed."""
    @functools.wraps(fn)
    def run(*args):
        rules = current_rules()
        if rules is None:
            return fn(*args)
        from torch.distributed.tensor import DTensor

        mesh = rules.mesh
        dp_axis = rules.rules.get("batch")
        dp, tp = rules.axis_size(dp_axis), rules.axis_size("model")
        b = next(a.shape[0] for i, a in enumerate(args) if i not in weights)
        rows = {dp_axis: 0} if b % dp == 0 else {}
        split = dict(model or {})
        if tp == 1 or any(args[i].shape[d] % tp for i, d in split.items()):
            split = {}
        first = mesh.get_local_rank("model") == 0 if split else True

        def take(i, a):
            if not isinstance(a, DTensor):
                a = DTensor.from_local(a, mesh, mesh_placements(mesh, {}), run_check=False)
            dims = {} if i in weights else dict(rows)
            if i in split:
                dims["model"] = split[i]
            pl = mesh_placements(mesh, dims)
            local = local_shard(a, pl, mesh_placements(mesh, dims, dp_axis)
                                if i in weights and rows else None)
            if split and i not in split:
                local = _SumGradOverModel.apply(local, mesh, pl)
            return local

        def give(o, dim):
            if isinstance(o, tuple):
                return tuple(give(x, d) for x, d in zip(o, dim or (None,) * len(o)))
            dims, shape = dict(rows), list(o.shape)
            shape[0] *= dp if rows else 1
            if split and dim is not None:
                dims["model"] = dim
                shape[dim] *= tp
            elif split:
                o = _GradOnFirstModelRank.apply(o, first)
            return wrap_local(o, mesh, mesh_placements(mesh, dims), tuple(shape))

        return give(fn(*(take(i, a) for i, a in enumerate(args))), out_model)

    return run


def add_residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` for a residual stream ``x`` and a sublayer's output ``y``:
    under installed rules ``y`` is first laid out as ``x`` (an explicit,
    differentiable redistribute), so its gradient comes back in its own
    layout. Left to the add's propagation, the gradient of a product's
    output would arrive sharded over the sequence, as the residual is
    ("act_seq"), and DTensor (torch 2.11) refuses the flatten of a sharded
    sequence that the product's backward does. Plain ``x + y`` otherwise."""
    if current_rules() is not None and x.placements != y.placements:
        y = y.redistribute(x.device_mesh, x.placements)
    return x + y


def sharded_compute():
    """The context of a forward and backward under installed rules: plain
    tensors made inside it (positions, masks, constants) take part as
    replicated DTensors (``implicit_replication``). A null context with no
    rules installed."""
    if current_rules() is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def shard_act(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """Lay an activation out by its logical axes: with rules installed,
    the DTensor ``x`` redistributed to ``rules.placements(logical,
    x.shape)`` (values unchanged; differentiable); with none, ``x`` as it
    is (the serve path, tests, one-card runs). Under rules a plain tensor
    is an error: the sharded forward's activations are DTensors."""
    rules = current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(f"shard_act{tuple(logical)} under installed MeshRules needs a DTensor, "
                        f"got a plain {type(x).__name__} of shape {tuple(x.shape)}")
    return x.redistribute(rules.mesh, rules.placements(logical, x.shape))
