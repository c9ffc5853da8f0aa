"""The port's side of tests/test_torch_dryrun.py, in processes of their own:
a dry run takes this process's one default process group (torch's fake
one), and the real 2×2 case spawns four gloo ranks. It imports nothing of
the JAX package.

``python tests/torch_dryrun_worker.py OUT`` writes a pickle of:
  * ``(shape, arch)`` → per-rank argument bytes of the train step (params,
    AdamW m, v and step) on the fake (16, 16) and (2, 16, 16) meshes;
  * ``("flops", arch, kind)`` → the dry run's FLOPs of a reduced step at 1×1;
  * ``"fake2x2"`` → the dry run's report of reduced TinyLlama's FSDP train
    step on a fake 2×2 mesh.
``real_2x2(rank, world, store, out_dir)`` is one gloo rank of the same
FSDP step on a real 2×2 mesh, under ``CostCounter``.
"""
import dataclasses
import datetime
import os
import pickle
import sys

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.cost_analysis import CostCounter, local_tensors
from repro_torch.launch.dryrun import fake_params, run_dryrun
from repro_torch.launch.mesh import make_dry_mesh
from repro_torch.models import build_model
from repro_torch.models.inputs import make_dummy_batch
from repro_torch.sharding import MeshRules, use_rules
from repro_torch.training import AdamWConfig, Trainer
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import BATCH_AXES

# the reduced steps' shapes: a 64-position prompt or cache, batch 2
SMALL = {kind: InputShape(f"{kind}_small", 64, 2, kind) for kind in ("train", "prefill", "decode")}
FLOP_ARCHS = ("tinyllama-1.1b", "olmoe-1b-7b", "internvl2-76b", "xlstm-125m")
MESHES = (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")))


def fsdp_tinyllama():
    return dataclasses.replace(get_config("tinyllama-1.1b").reduced(), fsdp=True)


def train_argument_bytes(arch: str, mesh) -> int:
    """One rank's bytes of the full-size params and AdamW state, placed by
    ``MeshRules.for_mesh(mesh, fsdp=cfg.fsdp)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch)
    rules = MeshRules.for_mesh(mesh, fsdp=cfg.fsdp)
    with FakeTensorMode():
        params = fake_params(build_model(cfg), rules, mesh.device_type)
        state = init_opt_state(params)
        return sum(t.numel() * t.element_size() for t in local_tensors((params, state)))


def fake_main(out_path: str) -> None:
    torch.set_num_threads(1)
    res = {}
    for shape, axes in MESHES:
        mesh = make_dry_mesh(shape, axes, "cpu")
        for arch in ARCH_IDS:
            res[(shape, arch)] = train_argument_bytes(arch, mesh)
        dist.destroy_process_group()
    mesh = make_dry_mesh((1, 1), ("data", "model"), "cpu")
    for arch in FLOP_ARCHS:
        for kind, shape in SMALL.items():
            rep = run_dryrun(get_config(arch).reduced(), shape, mesh=mesh, verbose=False,
                             device="cpu")
            res[("flops", arch, kind)] = rep["flops_per_device"]
    dist.destroy_process_group()
    mesh = make_dry_mesh((2, 2), ("data", "model"), "cpu")
    res["fake2x2"] = run_dryrun(fsdp_tinyllama(), SMALL["train"], mesh=mesh, verbose=False,
                                device="cpu")
    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def real_2x2(rank: int, world: int, store: str, out_dir: str) -> None:
    """Reduced TinyLlama's FSDP train step on four gloo ranks of a real 2×2
    mesh, seeded weights and prompt, under ``CostCounter``: rank 0 writes
    its summary and argument bytes."""
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = fsdp_tinyllama()
        rules = MeshRules.for_mesh(mesh, fsdp=cfg.fsdp)
        trainer = Trainer(build_model(cfg), AdamWConfig(), loss_chunk=512)
        params, state = trainer.init_state(seed=0, device="cpu", rules=rules)
        batch = {k: rules.distribute(v, BATCH_AXES[k])
                 for k, v in make_dummy_batch(cfg, SMALL["train"], device="cpu").items()}
        counter = CostCounter()
        args = counter.track(local_tensors((params, state, batch)))
        with use_rules(rules), counter:
            trainer.train_step(params, state, batch)
        if rank == 0:
            with open(os.path.join(out_dir, "real2x2.pkl"), "wb") as f:
                pickle.dump({"summary": counter.summary(), "argument_bytes": args}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    fake_main(sys.argv[1])
