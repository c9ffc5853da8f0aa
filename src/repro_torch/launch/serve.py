"""Serving launcher of the port: one stream of lockstep requests — prefill,
then (for a VLM) ``--frames`` video frames appended to the cache, then the
fused sparse decode loop — with the neuron-chunking policy and the
flash-offload simulation. Runs on the GPU unless asked otherwise:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --method chunk --backend kernel --decode-tokens 16

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --torch-device cpu --decode-tokens 8 --max-seq 64

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-76b \
      --reduced --frames 2 --torch-device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --torch-device cpu --cache-mb 1 --per-token

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --torch-device cpu --corruption-profile bit_rot \
      --fault-profile thermal_throttle --degrade

``--device`` names the simulated flash profile (nano / agx), as in the
reference CLI; ``--torch-device`` picks where the model runs. The
reference CLI's other flags belong to features not ported yet and are
refused with a pointer to ROADMAP.md.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import resolve_device
from ..configs import ARCH_IDS, get_config
from ..configs.base import InputShape
from ..core.faults import CORRUPTION_PROFILES, FAULT_PROFILES
from ..kernels.backend import BACKENDS
from ..models import build_model
from ..models.inputs import FRONT_DTYPE, make_dummy_batch
from ..serving import SERVE_METHODS, ServeEngine

# flags of the reference CLI (repro/launch/serve.py) the port does not serve
NOT_PORTED_FLAGS = (
    "--kv-page-tokens", "--mesh", "--streams",
    "--arrival-rate", "--round-tokens", "--deadline-s",
)


def _nonneg(kind, name: str):
    """An argparse type: ``kind(text)``, refused below 0."""
    def parse(text: str):
        try:
            v = kind(text)
        except ValueError:
            raise argparse.ArgumentTypeError(f"{name} must be a number, got {text!r}") from None
        if v < 0:
            raise argparse.ArgumentTypeError(f"{name} must be >= 0, got {text!r}")
        return v
    return parse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--method", choices=SERVE_METHODS, default="chunk",
                    help="chunk | topk | dense stream weights from the simulated flash; "
                         "dense_free keeps them resident (zero I/O)")
    ap.add_argument("--backend", choices=BACKENDS, default="reference",
                    help="decode execution backend: 'reference' computes the planned "
                         "sparse projections as the kernels' plain PyTorch schedule "
                         "twin; 'kernel' launches the CUDA chunk-gather kernels off the "
                         "decode plan's chunk tables. Tokens are byte-identical.")
    ap.add_argument("--wbits", type=int, choices=(16, 8), default=16,
                    help="offloaded chunk storage width: 16 = bf16 payload, 8 = int8 "
                         "payload + one f32 scale per 8-row block")
    ap.add_argument("--sparsity", type=float, default=0.4)
    ap.add_argument("--device", choices=("nano", "agx"), default="nano",
                    help="simulated flash device profile")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=8)
    ap.add_argument("--frames", type=int, default=2,
                    help="video frames appended after the prompt (VLM archs only), "
                         "frontend_tokens // 4 tokens each (at least 4)")
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--plan-refresh-interval", type=int, default=1,
                    help="recompute chunk selection every k decode steps")
    ap.add_argument("--cache-mb", type=_nonneg(float, "--cache-mb"), default=None,
                    help="DRAM budget (MB) of the dynamic chunk residency cache (paper "
                         "§5); resident rows cost no flash I/O. Default: the device "
                         "profile's dram_cache_mb (0 = off)")
    ap.add_argument("--per-token", action="store_true",
                    help="decode with one host sync per token (the baseline loop) "
                         "instead of the fused loop; tokens are byte-identical")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction, default=True,
                    help="charge decode steps through the overlapped I/O–compute "
                         "prefetch pipeline (--no-overlap: the serial charge)")
    ap.add_argument("--prefetch-depth", type=_nonneg(int, "--prefetch-depth"), default=1,
                    help="how many layers the pipeline's fetch engine may run ahead of "
                         "compute (>= 0); the kernels' ring runs at most 3 ahead. Tokens "
                         "are byte-identical at every depth")
    ap.add_argument("--torch-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: the GPU)")
    ap.add_argument("--seed", type=int, default=0, help="weight and prompt seed")
    ap.add_argument("--fault-profile", choices=tuple(FAULT_PROFILES), default="none",
                    help="storage-turbulence profile at the simulator's measurement "
                         "boundary: tail-latency spikes, transient read failures with "
                         "retry + backoff, thermal-throttle trajectories. Time only: "
                         "tokens never change; 'none' is bit-identical to no faults")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault model's own RNG stream (needs a profile)")
    ap.add_argument("--corruption-profile", choices=tuple(CORRUPTION_PROFILES),
                    default="none",
                    help="data-plane corruption of fetched 8-row blocks: 'bit_rot' flips "
                         "one bit, 'torn_read' zeroes blocks, 'degraded_nand' flips often "
                         "and persistently. Every fetched block is checksum-verified; "
                         "detections climb the ladder (re-read, resident copy, substitute, "
                         "drop). 'none' is bit-identical to no corruption")
    ap.add_argument("--corruption-seed", type=int, default=0,
                    help="seed of the corruption draws (needs a profile)")
    ap.add_argument("--max-reread", type=_nonneg(int, "--max-reread"), default=2,
                    help="re-reads of a checksum-mismatched block before the ladder "
                         "escalates (>= 0)")
    ap.add_argument("--recover", action=argparse.BooleanOptionalAction, default=True,
                    help="run the recovery ladder (default); --no-recover counts the "
                         "corruption but lets the damage flow into compute")
    ap.add_argument("--degrade", action=argparse.BooleanOptionalAction, default=False,
                    help="adaptive degradation: tighten the selection budgets while the "
                         "measured-vs-estimated I/O ratio (or the corruption rate) says "
                         "the device is degraded, relax them once it recovers")
    return ap


def validate_seed_flags(ap: argparse.ArgumentParser, args) -> None:
    """A nonzero seed whose profile is off does nothing, and is refused, as
    in the reference."""
    if args.fault_seed != 0 and args.fault_profile == "none":
        ap.error(f"--fault-seed {args.fault_seed} has no effect with --fault-profile none; "
                 f"pick a profile ({', '.join(p for p in FAULT_PROFILES if p != 'none')}) "
                 "or drop the seed")
    if args.corruption_seed != 0 and args.corruption_profile == "none":
        ap.error(f"--corruption-seed {args.corruption_seed} has no effect with "
                 "--corruption-profile none; pick a profile "
                 f"({', '.join(p for p in CORRUPTION_PROFILES if p != 'none')}) "
                 "or drop the seed")


def parse_args(argv=None):
    ap = build_parser()
    args, unknown = ap.parse_known_args(argv)
    for tok in unknown:
        flag = tok.split("=", 1)[0]
        if flag in NOT_PORTED_FLAGS:
            ap.error(f"{flag} is not ported to repro_torch yet; see ROADMAP.md, queue 1 "
                     "(the JAX CLI, python -m repro.launch.serve, still has it)")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    validate_seed_flags(ap, args)
    return args


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.torch_device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(seed=args.seed, device=dev)
    eng = ServeEngine(model, params, max_seq=args.max_seq, batch_size=args.batch,
                      device=args.device, sparsity=args.sparsity, method=args.method,
                      plan_refresh_interval=args.plan_refresh_interval,
                      cache_mb=args.cache_mb, overlap=args.overlap,
                      prefetch_depth=args.prefetch_depth, backend=args.backend,
                      wbits=args.wbits, torch_device=dev,
                      fault_profile=args.fault_profile, fault_seed=args.fault_seed,
                      degrade=args.degrade, corruption_profile=args.corruption_profile,
                      corruption_seed=args.corruption_seed, max_reread=args.max_reread,
                      recover=args.recover)
    batch = make_dummy_batch(cfg, InputShape("cli", args.prompt_len, args.batch, "train"),
                             seed=args.seed, device=dev)
    last = eng.prefill(batch)
    print(f"[prefill] {args.prompt_len} tokens")
    if cfg.d_frontend:
        rng = np.random.default_rng(args.seed)
        n_tok = max(cfg.frontend_tokens // 4, 4)
        for i in range(args.frames):
            frame = torch.from_numpy(rng.normal(0, 1, (args.batch, n_tok, cfg.d_frontend)))
            eng.append_frame(frame.to(FRONT_DTYPE))
            st = eng.stats[-1]
            print(f"[frame {i}] {n_tok} tokens  io_est {st.io_est_s * 1e3:.2f} ms  "
                  f"io_sim {st.io_sim_s * 1e3:.2f} ms")
    tok0 = torch.argmax(last, dim=-1)[:, None]
    decode = eng.decode_per_token if args.per_token else eng.decode
    out = decode(tok0, args.decode_tokens)
    dsteps = [s for s in eng.stats if s.kind == "decode"]
    mode = "per-token" if args.per_token else "fused"
    print(f"[decode:{mode}] {args.decode_tokens} tokens  "
          f"mean io_sim {np.mean([s.io_sim_s for s in dsteps]) * 1e3:.2f} ms/token  "
          f"wall {sum(s.wall_s for s in dsteps) * 1e3:.1f} ms  device={dev}")
    s = eng.io_summary()
    print(f"[pipeline] charged={'overlap' if args.overlap else 'serial'} "
          f"depth={args.prefetch_depth}  serial {s['decode_serial_s'] * 1e3:.2f} ms  "
          f"overlapped {s['decode_overlap_s'] * 1e3:.2f} ms  "
          f"stall {s['decode_stall_s'] * 1e3:.2f} ms  "
          f"overlap_efficiency {s['overlap_efficiency']:.3f}  "
          f"select_overhead {s['select_overhead_s'] * 1e3:.2f} ms")
    print(f"[total] method={args.method} backend={args.backend} wbits={args.wbits} "
          f"sparsity={args.sparsity} refresh_interval={args.plan_refresh_interval} "
          f"cache_mb={eng.cache_mb:g} "
          f"io_est {s['io_est_s'] * 1e3:.1f} ms  io_sim {s['io_sim_s'] * 1e3:.1f} ms  "
          f"io_bytes {s['io_bytes'] / 1e6:.1f} MB  "
          f"cache_hit_rate {s['cache_hit_rate']:.3f}")
    fs = eng.fault_summary()
    if fs["fault_enabled"] or fs["degrade_enabled"]:
        print(f"[faults] profile={fs['fault_profile']} seed={fs['fault_seed']}  "
              f"events {fs['fault_events']}  spikes {fs['fault_spikes']}  "
              f"retries {fs['fault_retries']}  extra {fs['fault_extra_s'] * 1e3:.2f} ms  "
              f"min_throttle {fs['min_throttle_scale']:.2f}  "
              f"degrade_scale {fs['degrade_scale']:.2f}")
    if args.corruption_profile != "none":
        print(f"[integrity] profile={args.corruption_profile} seed={args.corruption_seed} "
              f"recover={args.recover} max_reread={args.max_reread}  "
              f"detected {s['corruptions_detected']:.0f}  "
              f"recovered {s['corruptions_recovered']:.0f}  "
              f"substituted {s['corruptions_substituted']:.0f}  "
              f"dropped {s['corruptions_dropped']:.0f}  "
              f"reread {s['integrity_reread_s'] * 1e3:.2f} ms")
    print(f"[tokens] {out[0].tolist()}")
    return eng, out


if __name__ == "__main__":
    main(sys.argv[1:])
