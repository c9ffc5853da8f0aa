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

The serve path reads the rules to place its decode weights
(``ServeMesh.weight_spec``) and never installs them: with no rules
installed ``shard_act`` is the identity, as in the reference. The sharded
forward that installed rules drive (training's mesh) is not ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

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


_state = threading.local()


def set_rules(rules: Optional[MeshRules]) -> None:
    _state.rules = rules


def current_rules() -> Optional[MeshRules]:
    return getattr(_state, "rules", None)


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


def shard_act(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """Annotate an activation with logical axes: the identity with no rules
    installed (the serve path, tests, one-card runs). With rules installed
    it refuses: the sharded forward those rules drive is training's mesh,
    which is not ported yet (ROADMAP.md, queue 1, item 4)."""
    if current_rules() is None:
        return x
    raise NotImplementedError(
        "shard_act under installed MeshRules is the sharded forward of training's mesh, "
        "which repro_torch does not have yet (ROADMAP.md, queue 1, item 4); the serve "
        "mesh (ServeMesh) installs no rules")
