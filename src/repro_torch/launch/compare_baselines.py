"""Accuracy–latency trade-off sweep (the paper's Fig. 6 protocol) on real
reduced-model activations: run the reduced VLM forward, take the final
hidden states as one matrix's input, and sweep sparsity × {top-k,
threshold (CATS), neuron chunking}, reporting importance retention, the
output error against the dense product and the simulated I/O latency. The
counterpart of ``examples/compare_baselines.py`` (same sizes, seed and
printed table). Runs on the GPU unless asked otherwise:

  PYTHONPATH=src python -m repro_torch.launch.compare_baselines
  PYTHONPATH=src python -m repro_torch.launch.compare_baselines --torch-device cpu
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..configs.base import InputShape
from ..core import (
    ChunkConfig,
    ChunkSelector,
    calibrate_threshold,
    retention,
    threshold_mask,
    topk_mask_np,
)
from ..models import build_model
from ..models.inputs import make_dummy_batch

SPARSITIES = (0.2, 0.4, 0.6)


def sweep(hidden: torch.Tensor, w_down: torch.Tensor) -> List[dict]:
    """hidden (b, s, n) activations entering a matrix W (n, cols): per
    sparsity and method, the retained importance, ‖(x·m) W − x W‖ / ‖x W‖
    and the mask's simulated I/O (ms). The chunk selection runs on
    ``hidden``'s device (the walk is K5 on the card)."""
    dev = hidden.device
    n, cols = w_down.shape
    v = hidden.to(torch.float32).abs().reshape(-1, n).mean(0)
    sel = ChunkSelector.build(n, cols * 2, device="nano", cfg=ChunkConfig(2, 348, 2, 2))
    _, table = sel.lane(dev)
    x_ref = hidden.to(torch.float32).reshape(-1, n).cpu().numpy()
    w = w_down.to(torch.float32).cpu().numpy()
    y_dense = x_ref @ w
    rows = []
    for sp in SPARSITIES:
        budget = int((1 - sp) * n)
        masks = {"topk": torch.from_numpy(topk_mask_np(v.cpu().numpy(), budget)).to(dev),
                 "cats": threshold_mask(v, calibrate_threshold(v.cpu().numpy()[None], sp)),
                 "chunk": sel.select(v, budget)[0]}
        for name, mask in masks.items():
            y = (x_ref * mask.cpu().numpy().astype(np.float32)) @ w
            rows.append({"sparsity": sp, "method": name,
                         "retention": float(retention(v, mask)),
                         "out_rel_err": float(np.linalg.norm(y - y_dense)
                                              / np.linalg.norm(y_dense)),
                         "io_ms": float(table.mask_latency(mask)) * 1e3})
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.compare_baselines")
    ap.add_argument("--torch-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model and the selection run (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.torch_device)

    cfg = get_config("internvl2-76b").reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    batch = make_dummy_batch(cfg, InputShape("s", 64, 2, "train"), device=dev)
    hidden = model.forward(params, batch)[0]
    # layer 0's down projection transposed, (d, d_ff): an (n, cols) matrix
    # whose input is the hidden state
    rows = sweep(hidden, params["layers"]["w_down"][0].T)
    print(f"{'sparsity':>8s} {'method':>10s} {'retention':>10s} "
          f"{'out_rel_err':>12s} {'io_ms':>8s}")
    for r in rows:
        print(f"{r['sparsity']:8.1f} {r['method']:>10s} {r['retention']:10.3f} "
              f"{r['out_rel_err']:12.3f} {r['io_ms']:8.3f}")
    return rows


if __name__ == "__main__":
    main()
