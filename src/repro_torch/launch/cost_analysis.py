"""Per-rank cost of one call of a step: FLOPs, bytes, collectives and live
memory (the port's counterpart of ``repro.launch.hlo_analysis``, which
parses XLA's optimized HLO; the port has no XLA, so it counts the ops a
call dispatches).

``CostCounter`` is a ``TorchDispatchMode``. It sees an op on DTensors first
and lets DTensor run it (``NotImplemented``), so what it counts is what one
rank runs: the local op on this rank's shards and the collectives DTensor
issues to move them. The shape-only copies that DTensor's sharding
propagation runs on whole-size fake tensors (``_sharding_prop.py``) are
skipped. Conventions, after the reference's:

  * **flops**: 2 · |out| · |contracting dims| for every product that
    ``torch.utils.flop_counter``'s registry prices (mm, addmm, bmm,
    baddbmm, convolution and their backward, the fused attention ops), the
    ops ``analyze_hlo`` prices as ``dot`` and ``convolution``;
  * **bytes**: output plus operand bytes of every op that is not a view or
    a metadata query, the reference's rule for a materialized op. In eager
    every op materializes, so this is an upper bound beside XLA's fusions;
  * **collectives**: the RESULT size of every collective, by the
    reference's kinds (all-gather, all-reduce, reduce-scatter, all-to-all,
    collective-permute), functional or in-place, with their counts;
  * **memory**: the bytes of live storages, the arguments (``track``)
    included; ``peak_bytes`` is their high-water mark over the call.

XLA's flat cost analysis counts a while-loop body once, which is why the
reference multiplies by trip counts. Eager torch runs every layer and every
loop iteration as it goes, so each is counted as it runs, with one
exception that counts as the reference does: a chunked scan
(``models/scan.py``) under ``counting_chunks`` runs one full chunk and adds
its counts (``measured``) once for each full chunk it skips (``add``),
allocating the skipped chunks' states uncounted (``uncounted``) so that
the memory high-water mark still sees them.
"""
from __future__ import annotations

import contextlib
import sys
import weakref
from typing import Any, Dict, Iterable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# metadata queries: they read no tensor data
_METADATA = {"device", "size", "sym_size", "stride", "sym_stride", "numel", "sym_numel",
             "dim", "is_contiguous", "sym_is_contiguous", "storage_offset",
             "sym_storage_offset", "layout", "is_strides_like_format",
             "is_non_overlapping_and_dense"}


def collective_kind(func) -> Optional[str]:
    """The reference's kind of a collective op (functional ``_c10d_functional``,
    in-place ``c10d`` or DTensor's ``shard_dim_alltoall``), or None."""
    ns = getattr(func, "namespace", "")
    name = func._overloadpacket.__name__
    if ns not in ("_c10d_functional", "c10d_functional", "c10d", "_dtensor"):
        return None
    flat = name.replace("_", "")
    for prefix, kind in (("allgather", "all-gather"), ("allreduce", "all-reduce"),
                         ("reducescatter", "reduce-scatter"), ("alltoall", "all-to-all"),
                         ("sharddimalltoall", "all-to-all"), ("permute", "collective-permute"),
                         ("send", "collective-permute"), ("recv", "collective-permute")):
        if flat.startswith(prefix):
            return kind
    return None


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _in_sharding_propagation() -> bool:
    """Whether the op being dispatched is one of DTensor's sharding
    propagation's whole-size shape copies, not a rank's own work."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("sharding_prop.py"):
            return True
        f = f.f_back
    return False


def local_tensors(tree) -> list:
    """The tensors a rank holds for a tree's leaves (a DTensor's local
    shard, a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t for t in _tensors(tree)]


class CostCounter(TorchDispatchMode):
    """Counts one rank's work while active (see the module doc). ``track``
    registers tensors that exist before the call (the arguments) as live."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective_bytes = {k: 0 for k in COLLECTIVES}
        self.collective_counts = {k: 0 for k in COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()
        self._silent = 0

    def _totals(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts)}

    @contextlib.contextmanager
    def measured(self):
        """Yields a dict that holds, once the block ends, what the block
        counted (FLOPs, bytes, collective bytes and counts by kind)."""
        before, delta = self._totals(), {}
        yield delta
        after = self._totals()
        delta.update({k: after[k] - before[k] for k in ("flops", "bytes")})
        for k in ("collective_bytes", "collective_counts"):
            delta[k] = {kind: after[k][kind] - before[k][kind] for kind in COLLECTIVES}

    def add(self, delta: Dict[str, Any], times: int) -> None:
        """Count ``times`` more what a ``measured`` block counted."""
        self.flops += delta["flops"] * times
        self.bytes += delta["bytes"] * times
        for kind in COLLECTIVES:
            self.collective_bytes[kind] += delta["collective_bytes"][kind] * times
            self.collective_counts[kind] += delta["collective_counts"][kind] * times

    @contextlib.contextmanager
    def uncounted(self):
        """Ops within it are not counted; the storages they make are live."""
        self._silent += 1
        try:
            yield
        finally:
            self._silent -= 1

    def _add_storage(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = weakref.ref(st, lambda _, n=n: self._release(n))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def track(self, tensors: Iterable[torch.Tensor]) -> int:
        """Register existing local tensors (the arguments) as live; returns
        their bytes, each tensor's elements once (a shard that views a
        larger storage counts as its own size)."""
        seen = {}
        for t in tensors:
            self._add_storage(t)
            seen[id(t)] = t.numel() * t.element_size()
        return sum(seen.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it: its local ops come back here
        name = func._overloadpacket.__name__
        if name == "wait_tensor" and func.namespace == "_c10d_functional":
            # eager's wait returns its input once the collective is done; the
            # fake kernel makes a new tensor. A real collective is waited:
            # unwaited, its output could be read, or freed, while the process
            # group still writes it (a gloo rank died at exit, "malloc():
            # unaligned tcache chunk detected")
            if not isinstance(args[0], FakeTensor):
                func(*args, **kwargs)
            return args[0]
        out = func(*args, **kwargs)
        if self._silent:
            for t in _tensors(out):
                self._add_storage(t)
            return out
        if name in _METADATA or _in_sharding_propagation():
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        kind = collective_kind(func)
        if kind is not None:
            # the result: a functional op's output, an in-place op's output buffer
            result = out if func.namespace != "c10d" else args[0]
            self.collective_bytes[kind] += _nbytes(result)
            self.collective_counts[kind] += 1
        elif not func.is_view:
            self.bytes += _nbytes(out) + _nbytes((args, kwargs))
        for t in _tensors(out):
            self._add_storage(t)
        return out

    def summary(self) -> Dict[str, Any]:
        """The reference's ``analyze_hlo`` keys, plus the memory high-water
        mark."""
        total = sum(self.collective_bytes.values())
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": total,
            "collective_per_kind": dict(self.collective_bytes),
            "collectives": {"per_kind_bytes": dict(self.collective_bytes),
                            "counts": dict(self.collective_counts), "total_bytes": total},
            "peak_bytes": self.peak_bytes,
        }
