"""Repo-root pytest hooks: keep the JAX reference importable on newer jax.

jax 0.9 dropped three Pallas names that ``repro.kernels.chunk_gather_dma``
uses. Each alias below maps a removed name to its documented replacement,
so the reference computes exactly what it always did; on a jax that still
has the name, the alias does nothing. This file runs before any test
module imports ``repro``.

  * ``pltpu.TPUMemorySpace`` → ``pltpu.MemorySpace`` (renamed);
  * ``pl.load(ref, idx)``    → ``ref[idx]``;
  * ``pl.store(ref, idx, v)`` → ``ref[idx] = v``.
"""
try:
    from jax.experimental import pallas as _pl
    from jax.experimental.pallas import tpu as _pltpu
except ImportError:  # no jax: nothing to alias
    _pl = _pltpu = None

if _pltpu is not None and not hasattr(_pltpu, "TPUMemorySpace"):
    _pltpu.TPUMemorySpace = _pltpu.MemorySpace

if _pl is not None and not hasattr(_pl, "load"):

    def _load(ref, idx, **_kwargs):
        return ref[idx]

    _pl.load = _load

if _pl is not None and not hasattr(_pl, "store"):

    def _store(ref, idx, val, **_kwargs):
        ref[idx] = val

    _pl.store = _store
