"""Serving launcher of the port: one stream of lockstep requests — prefill,
then (for a VLM) ``--frames`` video frames appended to the cache, then the
fused sparse decode loop — or, with ``--streams N``, N Poisson-arriving
requests served through ``--batch`` request slots by the continuous-batching
scheduler (``--kv-page-tokens`` pages their KV, ``--deadline-s`` gives each
an SLO); with the neuron-chunking policy and the flash-offload simulation.
Runs on the GPU unless asked otherwise:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --method chunk --backend kernel --decode-tokens 16

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --torch-device cpu --decode-tokens 8 --max-seq 64

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-76b \
      --reduced --frames 2 --torch-device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e \
      --reduced --frames 2 --torch-device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
      --reduced --torch-device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --torch-device cpu --cache-mb 1 --per-token

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --torch-device cpu --corruption-profile bit_rot \
      --fault-profile thermal_throttle --degrade

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --torch-device cpu --streams 5 --arrival-rate 300 \
      --decode-tokens 6 --max-seq 64 --prompt-len 16 --kv-page-tokens 8

``--mesh DATA,MODEL`` serves on a sharded (data, model) mesh, one process
per rank: launch it with torchrun (gloo ranks on the CPU, NCCL ranks on
cards), or from processes that initialised a process group already; the
tokens equal the 1,1 mesh's, with ``--streams`` and ``--kv-page-tokens`` (the
page pool split over the data ranks) and for the MoE archs at any data
axis. A bad ``--mesh`` fails at parse time, before a model is built:

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch internvl2-76b --reduced --torch-device cpu --mesh 2,2

``--device`` names the simulated flash profile (nano / agx), as in the
reference CLI; ``--torch-device`` picks where the model runs. ``--arch``
takes every family: the hybrid (zamba2-7b), recurrent (xlstm-125m) and
audio (whisper-small, whose prompt carries its encoder's frames) archs
serve one stream with no frames, at wbits 16, without corruption injection
or ``--streams``.
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
from ..serving import SERVE_METHODS, PoissonArrivalDriver, Request, Scheduler, ServeEngine
from ..sharding.serve import ServeMesh, parse_mesh_spec, validate_serve_mesh
from .mesh import world_size


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


def _positive_int(name: str):
    """An argparse type: an integer, refused below 1."""
    def parse(text: str) -> int:
        try:
            v = int(text)
        except ValueError:
            raise argparse.ArgumentTypeError(f"{name} must be an integer, got {text!r}") from None
        if v < 1:
            raise argparse.ArgumentTypeError(f"{name} must be >= 1, got {text!r}")
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
    ap.add_argument("--kv-page-tokens", type=_positive_int("--kv-page-tokens"), default=None,
                    help="paged KV cache: page size in tokens (must divide --max-seq); "
                         "per-slot page tables with prefix sharing, the pool's bytes carved "
                         "out of --cache-mb. Requires --streams; tokens equal the dense "
                         "cache's. Default: dense per-slot KV")
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
    ap.add_argument("--mesh", type=str, default="1,1", metavar="DATA,MODEL",
                    help="serve-mesh shape 'data,model' (default 1,1 = unsharded), one "
                         "process per rank (torchrun --nproc-per-node DATA*MODEL): serve "
                         "slots partition over the data axis (--batch and --streams must "
                         "divide it), the offloaded decode weights over the model axis (ffn "
                         "rows must divide model x 8). Greedy tokens are byte-identical to "
                         "the 1,1 mesh at both --wbits")
    ap.add_argument("--torch-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: the GPU)")
    ap.add_argument("--seed", type=int, default=0, help="weight and prompt seed")
    ap.add_argument("--streams", type=int, default=0,
                    help=">0: continuous-batching mode — serve this many Poisson-arriving "
                         "requests through --batch slots")
    ap.add_argument("--arrival-rate", type=float, default=50.0,
                    help="request arrival rate (requests/s, simulated clock)")
    ap.add_argument("--round-tokens", type=_positive_int("--round-tokens"), default=4,
                    help="decode tokens per scheduler round (one fused decode call per "
                         "round for every slot); >= 1")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request SLO deadline (seconds from arrival, simulated clock) "
                         "in --streams mode: earliest-deadline-first admission, blown "
                         "requests may be preempted; stats gain p99 and SLO attainment")
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


def resolve_mesh(spec: str, cfg, batch: int, streams: int,
                 device: str = "cuda") -> ServeMesh:
    """Parse and validate ``--mesh`` against ``--batch`` / ``--streams``, the
    config and the process group's world size before any model is built,
    then build the mesh (joining the group torchrun set up, or the caller's)."""
    data, model = parse_mesh_spec(spec)
    validate_serve_mesh(data, model, batch=batch, streams=streams,
                        d_ff=(cfg.d_ff if (model > 1 and cfg.d_ff and not cfg.has_moe) else 0),
                        n_devices=world_size())
    return ServeMesh.create(data, model, device)


def parse_args(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    validate_seed_flags(ap, args)
    try:
        parse_mesh_spec(args.mesh)
    except ValueError as err:
        ap.error(str(err))
    if args.kv_page_tokens is not None and args.streams <= 0:
        ap.error("--kv-page-tokens requires --streams (paged KV is slot-mode only: requests "
                 "are admitted through the page allocator)")
    return args


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.torch_device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = resolve_mesh(args.mesh, cfg, args.batch, args.streams, dev.type)
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
                      recover=args.recover, kv_page_tokens=args.kv_page_tokens, mesh=mesh)
    if args.streams > 0:
        return eng, serve_streams(args, cfg, eng)
    batch = make_dummy_batch(cfg, InputShape("cli", args.prompt_len, args.batch, "train"),
                             seed=args.seed, device=dev)
    last = eng.prefill(batch)
    print(f"[prefill] {args.prompt_len} tokens")
    if cfg.d_frontend and not cfg.is_encdec:
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
    print_mesh(eng)
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
    print_integrity(args, s)
    print(f"[tokens] {out[0].tolist()}")
    return eng, out


def print_mesh(eng) -> None:
    """The [mesh] line (sharded meshes only)."""
    if not eng.mesh.is_sharded:
        return
    ss = eng.shard_summary()
    per = ", ".join(f"{b / 1e6:.1f}" for b in ss["io_bytes_per_shard"])
    pages = (f"  kv_pages/data_shard={ss['kv_pages_per_shard']}"
             if eng.kv_pool is not None else "")
    print(f"[mesh] data={eng.mesh.data} model={eng.mesh.model}  "
          f"slots/data_shard={ss['slots_per_data_shard']}  "
          f"cache_mb/shard={ss['cache_mb_per_shard']:g}  io_bytes/shard MB=[{per}]{pages}")


def print_integrity(args, s) -> None:
    """The [integrity] line (corruption injection runs only)."""
    if args.corruption_profile == "none":
        return
    print(f"[integrity] profile={args.corruption_profile} seed={args.corruption_seed} "
          f"recover={args.recover} max_reread={args.max_reread}  "
          f"detected {s['corruptions_detected']:.0f}  "
          f"recovered {s['corruptions_recovered']:.0f}  "
          f"substituted {s['corruptions_substituted']:.0f}  "
          f"dropped {s['corruptions_dropped']:.0f}  "
          f"reread {s['integrity_reread_s'] * 1e3:.2f} ms")


def serve_streams(args, cfg, eng):
    """Continuous-batching mode: ``--streams`` Poisson arrivals into the
    engine's request slots (the reference's ``_serve_streams``: each prompt
    the seeded dummy batch at batch 1 with its tokens drawn anew, on the
    host). Returns the ``SchedulerStats``."""
    rng = np.random.default_rng(args.seed)
    base = make_dummy_batch(cfg, InputShape("req", args.prompt_len, 1, "train"),
                            seed=args.seed, device="cpu")

    def make_request(rid: int) -> Request:
        prompt = dict(base)
        prompt["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, tuple(base["tokens"].shape)))
        return Request(rid=rid, prompt=prompt, max_new_tokens=args.decode_tokens,
                       deadline_s=args.deadline_s)

    driver = PoissonArrivalDriver(args.arrival_rate, make_request, seed=1)
    sched = Scheduler(eng, round_tokens=args.round_tokens)
    sched.submit(driver.generate(args.streams))
    stats = sched.run()
    print(f"[serve] method={args.method} backend={args.backend} slots={args.batch} "
          f"rate={args.arrival_rate}/s refresh={args.plan_refresh_interval} "
          f"cache_mb={eng.cache_mb:g}")
    print(f"[serve] {stats.row()}")
    s = eng.io_summary()
    print(f"[serve] ttft p50 {stats.ttft_p50_s * 1e3:.2f} ms  "
          f"sim time {stats.sim_time_s * 1e3:.1f} ms  "
          f"overlap_efficiency {s['overlap_efficiency']:.3f}  "
          f"cache_hit_rate {s['cache_hit_rate']:.3f}")
    print(f"[serve] admitted_during_stall {s['admitted_during_stall']}  "
          f"stall_hidden {s['stall_hidden_s'] * 1e3:.2f} ms  "
          f"bubble_utilization {s['bubble_utilization']:.3f}")
    if eng.kv_pool is not None:
        ps = eng.kv_pool.summary()
        print(f"[paged-kv] page_tokens {eng.kv_page_tokens}  pages {eng.kv_pages} "
              f"(kv {s['kv_cache_mb']:.2f} MB / weights {s['weight_cache_mb']:.2f} MB)  "
              f"shared_hits {ps['shared_hits']}  cow {ps['cow_copies']}  "
              f"evictions {ps['evictions']}")
    print_mesh(eng)
    if args.deadline_s is not None:
        print(f"[slo] deadline {args.deadline_s * 1e3:.1f} ms  "
              f"attainment {stats.slo_attainment:.3f} ({stats.deadlines_met}/{stats.deadlines})  "
              f"p99 {stats.latency_p99_s * 1e3:.2f} ms  preempted {stats.preempted}")
    fs = eng.fault_summary()
    if fs["fault_enabled"] or fs["degrade_enabled"]:
        print(f"[faults] profile={fs['fault_profile']} seed={fs['fault_seed']}  "
              f"events {fs['fault_events']}  spikes {fs['fault_spikes']}  "
              f"retries {fs['fault_retries']}  extra {fs['fault_extra_s'] * 1e3:.2f} ms  "
              f"min_throttle {fs['min_throttle_scale']:.2f}")
        print(f"[degrade] on={fs['degrade_enabled']}  scale {fs['degrade_scale']:.2f}  "
              f"ewma {fs['degrade_ewma_ratio']:.2f}  tighten {fs['degrade_tighten_steps']}  "
              f"relax {fs['degrade_relax_steps']}")
    print_integrity(args, s)
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
