"""Training launcher of the port (the counterpart of ``repro.launch.train``):
the synthetic data pipeline → the model's forward with per-layer remat →
the chunked-CE loss (+ the MoE aux loss) → AdamW, with an optional
checkpoint at the end. Runs on the GPU unless asked otherwise:

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 50 --batch 8 --seq 512

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --reduced --steps 50 --batch 8 --seq 128 --torch-device cpu

The reference CLI's ``--mesh`` (data × model sharding) is not ported yet
and is refused with a pointer to ROADMAP.md.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..configs import ARCH_IDS, get_config
from ..data import DataConfig, lm_batches
from ..models import build_model
from ..training import AdamWConfig, Trainer, save_checkpoint

# flags of the reference CLI (repro/launch/train.py) the port does not take
NOT_PORTED_FLAGS = ("--mesh",)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--torch-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default: the GPU)")
    return ap


def parse_args(argv=None):
    ap = build_parser()
    args, unknown = ap.parse_known_args(argv)
    for tok in unknown:
        flag = tok.split("=", 1)[0]
        if flag in NOT_PORTED_FLAGS:
            ap.error(f"{flag} is not ported to repro_torch yet; see ROADMAP.md, queue 1, "
                     "item 4 (the JAX CLI, python -m repro.launch.train, still has it)")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    return args


def log_line(i: int, m, t0: float) -> str:
    """The reference CLI's line for step i (this reads the metrics, one host
    sync)."""
    return (f"step {i:5d} loss {float(m['loss']):.4f} ce {float(m['ce']):.4f} "
            f"gnorm {float(m['grad_norm']):.2f} lr {float(m['lr']):.2e} "
            f"{(time.time() - t0) / (i + 1):.2f}s/step")


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.torch_device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    trainer = Trainer(build_model(cfg),
                      AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                                  total_steps=args.steps),
                      loss_chunk=min(512, args.seq))
    params, opt = trainer.init_state(seed=0, device=dev)
    it = lm_batches(cfg, DataConfig(batch=args.batch, seq_len=args.seq))
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        params, opt, m = trainer.train_step(params, opt, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(log_line(i, m, t0), flush=True)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, params, step=args.steps)
        print(f"saved checkpoint to {args.ckpt_dir}")
    return params


if __name__ == "__main__":
    main()
