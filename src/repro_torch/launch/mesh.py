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
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)
