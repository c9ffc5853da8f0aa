"""Training launcher of the port (the counterpart of ``repro.launch.train``):
the synthetic data pipeline → the model's forward with per-layer remat →
the chunked-CE loss (+ the MoE aux loss) → AdamW, with an optional
checkpoint at the end. Runs on the GPU unless asked otherwise:

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 50 --batch 8 --seq 512

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --reduced --steps 50 --batch 8 --seq 128 --torch-device cpu

``--mesh D,M`` (or ``P,D,M``) trains on a (data, model) (or (pod, data,
model)) mesh, one process per rank under torchrun: the reference's
``MeshRules.for_mesh(mesh, fsdp=cfg.fsdp)`` installed, the params placed
by ``Model.param_axes()``, the batch sharded over the data axes. Every rank
trains; rank 0 prints the log lines and writes the checkpoint (whole
tensors). A world of another size than the mesh's is refused:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --arch tinyllama-1.1b --reduced --mesh 2,2 --torch-device cpu
"""
from __future__ import annotations

import argparse
import math
import time

import torch
import torch.distributed as dist

from .. import resolve_device
from ..configs import ARCH_IDS, get_config
from ..data import DataConfig, lm_batches
from ..models import build_model
from ..sharding import MeshRules, use_rules
from ..training import AdamWConfig, Trainer, save_checkpoint
from .mesh import TORCHRUN_HINT, leaving_process_group, make_mesh, world_size


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2,2 → (data, model), or P,D,M → (pod, data, model); one "
                         "process per rank (torchrun)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--torch-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default: the GPU)")
    return ap


def parse_mesh(spec: str):
    """``"D,M"`` or ``"P,D,M"`` → (shape, axis names), as the reference
    parses it."""
    try:
        shape = tuple(int(x) for x in spec.split(","))
    except ValueError:
        raise ValueError(f"--mesh axes must be integers, got {spec!r}") from None
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"--mesh must be 'data,model' or 'pod,data,model' (e.g. 2,2), "
                         f"got {spec!r}")
    return shape, ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def parse_args(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mesh is not None:
        try:
            parse_mesh(args.mesh)
        except ValueError as err:
            ap.error(str(err))
    return args


def resolve_mesh(spec: str, device_type: str):
    """The ``--mesh`` DeviceMesh over the process group (joining the one
    torchrun set up); refuses a world of another size before joining."""
    shape, axes = parse_mesh(spec)
    n = math.prod(shape)
    if world_size() != n:
        raise ValueError(f"--mesh {spec} needs {n} ranks, the world has {world_size()}; "
                         f"{TORCHRUN_HINT.format(n=n)}")
    return make_mesh(shape, axes, device_type)


def log_line(i: int, m, t0: float) -> str:
    """The reference CLI's line for step i (this reads the metrics, one host
    sync)."""
    return (f"step {i:5d} loss {float(m['loss']):.4f} ce {float(m['ce']):.4f} "
            f"gnorm {float(m['grad_norm']):.2f} lr {float(m['lr']):.2e} "
            f"{(time.time() - t0) / (i + 1):.2f}s/step")


def main(argv=None):
    """The CLI. A process group its ``--mesh`` joins (the one torchrun set
    up) is left when it ends, drained and destroyed
    (``launch.mesh.leaving_process_group``); a caller's group stays."""
    with leaving_process_group():
        return _main(argv)


def _main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.torch_device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rules = None
    if args.mesh is not None:
        rules = MeshRules.for_mesh(resolve_mesh(args.mesh, dev.type), fsdp=cfg.fsdp)
    lead = rules is None or dist.get_rank() == 0
    trainer = Trainer(build_model(cfg),
                      AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                                  total_steps=args.steps),
                      loss_chunk=min(512, args.seq))
    with use_rules(rules):
        params, opt = trainer.init_state(seed=0, device=dev, rules=rules)
        it = lm_batches(cfg, DataConfig(batch=args.batch, seq_len=args.seq))
        t0 = time.time()
        for i in range(args.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
            params, opt, m = trainer.train_step(params, opt, batch)
            if lead and (i % args.log_every == 0 or i == args.steps - 1):
                print(log_line(i, m, t0), flush=True)
        if args.ckpt_dir:
            save_checkpoint(args.ckpt_dir, params, step=args.steps)
            if lead:
                print(f"saved checkpoint to {args.ckpt_dir}")
    return params


if __name__ == "__main__":
    main()
