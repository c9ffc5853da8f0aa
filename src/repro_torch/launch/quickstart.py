"""Quickstart of the port: NEURON CHUNKING on one offloaded weight matrix.

The per-matrix runtime path: importance → utility-guided chunk selection
(the greedy walk is kernel K5) → latency estimate → the chunk-gather kernel
K3 computing y = Σ x_i W_i over only the selected chunks. Same sizes, seed
and printed lines as ``examples/quickstart.py``. Runs on the GPU unless
asked otherwise:

  PYTHONPATH=src python -m repro_torch.launch.quickstart
  PYTHONPATH=src python -m repro_torch.launch.quickstart --torch-device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..core import NeuronChunkingPlanner, chunk_stats_np, contiguity_distribution_np
from ..kernels import chunk_gather_matmul_ref, plan_to_kernel_table, sparse_matmul

N, D = 4096, 1024  # one down-projection-like matrix (rows = input neurons)
SPARSITY = 0.4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.quickstart")
    ap.add_argument("--torch-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the planner and the kernel run (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.torch_device)
    rng = np.random.default_rng(0)

    # 1. a planner per offloaded matrix (device latency table baked in)
    planner = NeuronChunkingPlanner.build(N, D, device="nano", dtype_bytes=2)

    # 2. runtime: activations arrive → plan at 40% sparsity
    acts = np.abs(rng.normal(0, 1, (16, N))) * rng.lognormal(0, 1, N)
    acts = torch.from_numpy(acts.astype(np.float32)).to(dev)
    plan = planner.plan(acts, sparsity=SPARSITY)
    topk = planner.plan_topk(acts, sparsity=SPARSITY)

    print(f"selected rows      : {int(plan.n_selected)} / {N}")
    print(f"importance retained: ours {float(plan.importance_retention):.3f} "
          f"vs top-k {float(topk.importance_retention):.3f}")
    print(f"est. I/O latency   : ours {float(plan.est_latency_s)*1e3:.3f} ms "
          f"vs top-k {float(topk.est_latency_s)*1e3:.3f} ms "
          f"({float(topk.est_latency_s)/float(plan.est_latency_s):.1f}x)")
    mask = plan.mask.cpu().numpy()
    print(f"contiguity         : avg chunk {chunk_stats_np(mask)[0]:.1f} rows "
          f"(top-k: {chunk_stats_np(topk.mask.cpu().numpy())[0]:.1f}); "
          f"distribution {dict(sorted(contiguity_distribution_np(mask).items())[:5])}...")

    # 3. execute with K3: only selected chunks are ever read. The kernel
    #    table is the plan rounded outward to the 8-row grid (a slight
    #    superset), so the oracle uses the same table.
    w = torch.from_numpy(rng.normal(0, 1, (N, D))).to(dev, torch.bfloat16)
    starts, sizes = plan_to_kernel_table(mask, block_rows=8, max_chunk_rows=512)
    starts, sizes = torch.from_numpy(starts).to(dev), torch.from_numpy(sizes).to(dev)
    x1 = acts[:1].to(torch.bfloat16)
    y = sparse_matmul(w, x1, starts, sizes)
    y_ref = chunk_gather_matmul_ref(w, x1, starts, sizes)
    err = float((y - y_ref).abs().max())
    print(f"kernel vs oracle max err: {err:.2e}")
    return {"plan": plan, "topk": topk, "w": w, "x": x1, "starts": starts, "sizes": sizes,
            "y": y, "max_err": err}


if __name__ == "__main__":
    main()
