"""Streaming-video VLM serving, the paper's workload: prefill → per-frame
append → fused decode, comparing dense loads, top-k sparsification and
NEURON CHUNKING on the simulated Jetson Orin Nano flash, then the effect of
reusing the chunk plan over k decode steps. The counterpart of
``examples/serve_video_stream.py``: same arguments, sizes, seeds and
printed table, on the reduced config. Runs on the GPU unless asked
otherwise:

  PYTHONPATH=src python -m repro_torch.launch.video_stream
  PYTHONPATH=src python -m repro_torch.launch.video_stream --torch-device cpu

``--arch`` takes any early-fusion arch: the VLM (the default) or
Llama-4-Scout, whose MoE layers plan only their attention sites; the
others, which take no frames, are refused.
"""
from __future__ import annotations

import argparse
from typing import Dict, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..configs.base import InputShape
from ..models import build_model
from ..models.inputs import FRONT_DTYPE, make_dummy_batch
from ..serving import ServeEngine

POLICIES = ("dense", "topk", "chunk")
MAX_SEQ = 512
REUSE_INTERVALS = (1, 2, 4)


def policy_io(model, params, prompt, frames: Sequence[torch.Tensor], decode_tokens: int,
              sparsity: float, plan_refresh_interval: int, torch_device,
              **engine_kw) -> Dict[str, dict]:
    """Per policy: mean simulated I/O of a frame and of a decode token, and
    the total past the prefill (seconds), each engine serving the same
    prompt, frames and decode length (``engine_kw``: e.g. backend, wbits)."""
    out = {}
    for method in POLICIES:
        eng = ServeEngine(model, params, max_seq=MAX_SEQ,
                          batch_size=prompt["tokens"].shape[0], device="nano",
                          sparsity=sparsity, method=method, seed=1,
                          plan_refresh_interval=plan_refresh_interval,
                          torch_device=torch_device, **engine_kw)
        last = eng.prefill(prompt)
        for f in frames:
            eng.append_frame(f)
        eng.decode(torch.argmax(last, dim=-1)[:, None], decode_tokens)
        fr = [s.io_sim_s for s in eng.stats if s.kind == "frame"]
        de = [s.io_sim_s for s in eng.stats if s.kind == "decode"]
        out[method] = {"frame_io_s": float(np.mean(fr)), "decode_io_s": float(np.mean(de)),
                       "total_io_s": sum(s.io_sim_s for s in eng.stats if s.kind != "prefill")}
    return out


def reuse_io(model, params, prompt, decode_tokens: int, sparsity: float,
             torch_device) -> Dict[int, float]:
    """Mean simulated decode I/O per token of ``chunk`` with the plan
    recomputed every k steps, per k."""
    out = {}
    for k in REUSE_INTERVALS:
        eng = ServeEngine(model, params, max_seq=MAX_SEQ, batch_size=prompt["tokens"].shape[0],
                          device="nano", sparsity=sparsity, method="chunk", seed=1,
                          plan_refresh_interval=k, torch_device=torch_device)
        last = eng.prefill(prompt)
        eng.decode(torch.argmax(last, dim=-1)[:, None], decode_tokens)
        out[k] = float(np.mean([s.io_sim_s for s in eng.stats if s.kind == "decode"]))
    return out


def print_policy_table(rows: Dict[str, dict]) -> None:
    print(f"{'policy':8s} {'frame io (ms)':>14s} {'decode io (ms/tok)':>20s} "
          f"{'total io (ms)':>14s}")
    for method, r in rows.items():
        print(f"{method:8s} {r['frame_io_s'] * 1e3:14.2f} {r['decode_io_s'] * 1e3:20.2f} "
              f"{r['total_io_s'] * 1e3:14.2f}")
    print(f"\nneuron chunking vs top-k I/O speedup at EQUAL sparsity: "
              f"{rows['topk']['total_io_s'] / rows['chunk']['total_io_s']:.2f}x")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.video_stream")
    ap.add_argument("--arch", default="internvl2-76b")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--decode-tokens", type=int, default=12)
    ap.add_argument("--sparsity", type=float, default=0.4)
    ap.add_argument("--plan-refresh-interval", type=int, default=1)
    ap.add_argument("--torch-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.torch_device)

    cfg = get_config(args.arch).reduced()
    if not cfg.d_frontend or cfg.is_encdec:
        ap.error(f"--arch {args.arch} takes no frames (append_frame serves the early-fusion "
                 "archs: internvl2-76b, llama4-scout-17b-a16e)")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    prompt = make_dummy_batch(cfg, InputShape("s", 32, 2, "train"), device=dev)
    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(rng.normal(0, 1, (2, 8, cfg.d_frontend))).to(FRONT_DTYPE)
              for _ in range(args.frames)]

    rows = policy_io(model, params, prompt, frames, args.decode_tokens, args.sparsity,
                     args.plan_refresh_interval, dev)
    print_policy_table(rows)
    reuse = reuse_io(model, params, prompt, args.decode_tokens, args.sparsity, dev)
    print(f"\n{'refresh k':>9s} {'decode io (ms/tok)':>20s}")
    for k, io in reuse.items():
        print(f"{k:9d} {io * 1e3:20.3f}")
    print("\n(reduced-model rows are tiny → fragmentation is extreme; the paper's "
          "matched-accuracy full-scale protocol gives 2.19x avg on Nano)")
    return {"policies": rows, "reuse": reuse}


if __name__ == "__main__":
    main()
