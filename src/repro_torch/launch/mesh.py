"""Mesh construction on ``torch.distributed`` (the port's copy of
``repro.launch.mesh``).

A mesh is a ``DeviceMesh`` over every rank of the process group, one rank
per device (SPMD over ranks, where the reference is SPMD over the devices
of one process): gloo on the CPU, NCCL on cards. The group is the one the
caller initialised, or the one ``torchrun`` describes in the environment
(``torchrun --nproc-per-node N``), which is joined here; a world whose size
is not the mesh's is refused. Defined as functions, never module-level
constants, so importing this module touches no process group.

Production topology of the reference (TPU v5e, 256 chips a pod):
  single-pod: (data=16, model=16)        multi-pod: (pod=2, data=16, model=16)

``make_dry_mesh`` builds that topology, or any other, over torch's fake
process group: one process standing for rank 0 of ``prod(shape)`` ranks,
whose collectives move nothing (the dry run's mesh; ``launch/dryrun.py``).
"""
from __future__ import annotations

import math
import os
from typing import Tuple

import torch
import torch.distributed as dist

TORCHRUN_HINT = "launch one process per device with torchrun --nproc-per-node {n}"


def world_size() -> int:
    """Ranks of the process group: the initialised group's, else the
    ``WORLD_SIZE`` torchrun sets, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def join_process_group(device_type: str = "cuda") -> None:
    """Join the process group torchrun describes (env://), unless the caller
    initialised one already: NCCL for ``cuda`` (each rank on its
    ``LOCAL_RANK``'s card), gloo for ``cpu``. No environment to join from is
    an error, never a quiet single-process run."""
    if dist.is_initialized():
        return
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"no process group to join: initialise one (torch.distributed."
            f"init_process_group) or {TORCHRUN_HINT.format(n='N')} (unset: "
            f"{', '.join(missing)})")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method="env://")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank (joining
    the process group first); refuses a world of another size."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    join_process_group(device_type)
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs {n} ranks, the process group has "
            f"{dist.get_world_size()}; {TORCHRUN_HINT.format(n=n)}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_test_mesh(n_data: int = 2, n_model: int = 2, device_type: str = "cuda"):
    """A small (data, model) mesh for tests (gloo ranks on the CPU)."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    return make_mesh(*production_shape(multi_pod), device_type)


def production_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_dry_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over torch's fake process
    group of ``prod(shape)`` ranks, this process rank 0: collectives are
    issued and complete at once, moving nothing. A process has one default
    group, so the dry run takes a process of its own: an initialised group
    (a real one, or an earlier dry run's) is refused, never reused."""
    from torch.distributed.device_mesh import init_device_mesh
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if dist.is_initialized():
        raise RuntimeError(
            f"a process group ({dist.get_backend()}, {dist.get_world_size()} ranks) is "
            "initialised already: the dry run needs a process of its own, with no group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
