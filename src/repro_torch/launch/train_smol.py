"""Train a small LM end to end on the port's training path (the
counterpart of ``examples/train_smol.py``): the data pipeline → the layer
loop with per-layer remat → the chunked-CE train step → AdamW →
checkpoint. The default is ~10M params for 200 steps (``smol-10m``);
``--full`` takes a ~100M-param config (``smol-100m``), sized for the card.
Runs on the GPU unless asked otherwise:

  PYTHONPATH=src python -m repro_torch.launch.train_smol [--steps 200] [--full]
  PYTHONPATH=src python -m repro_torch.launch.train_smol --steps 20 --torch-device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from .. import resolve_device
from ..configs import get_config
from ..data import DataConfig, lm_batches
from ..models import build_model
from ..training import AdamWConfig, Trainer, save_checkpoint


def smol_config(full: bool):
    """(config, batch, seq): TinyLlama's shape at ~100M params (12 layers ×
    d_model 768 × d_ff 2048, vocab 32000) with ``full``, else ~10M (4 × 256
    × 1024, vocab 512)."""
    base = get_config("tinyllama-1.1b")
    if full:
        cfg = dataclasses.replace(base, name="smol-100m", n_layers=12, d_model=768,
                                  n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048,
                                  vocab_size=32000)
        return cfg, 16, 512
    cfg = dataclasses.replace(base, name="smol-10m", n_layers=4, d_model=256, n_heads=4,
                              n_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=512)
    return cfg, 16, 128


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train_smol")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true", help="~100M params")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--torch-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.torch_device)

    cfg, batch, seq = smol_config(args.full)
    model = build_model(cfg)
    n_params = sum(math.prod(shape) for shape, _ in model.param_shapes().values())
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params")

    trainer = Trainer(model, AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps),
                      loss_chunk=128)
    params, opt = trainer.init_state(seed=0, device=dev)
    it = lm_batches(cfg, DataConfig(batch=batch, seq_len=seq, seed=0))
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        params, opt, m = trainer.train_step(params, opt, b)
        if i % 20 == 0 or i == args.steps - 1:
            losses.append(float(m["loss"]))
            print(f"step {i:4d}  loss {losses[-1]:.4f}  lr {float(m['lr']):.2e}  "
                  f"{(time.time() - t0) / (i + 1):.2f}s/step", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        print("checkpoint saved:", args.ckpt)
    return losses


if __name__ == "__main__":
    main()
