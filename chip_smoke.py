#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``; without a card it exits non-zero and prints no result.
Phases, each of which fails the run on error:

  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. the build: every kernel source of ``kernels/csrc`` compiled from this
     checkout (one nvcc per source, in parallel), ptxas's register /
     shared-memory / spill report per kernel;
  3. kernel vs plain, bitwise: K5 over a refresh step's 88 lanes (every
     site of every layer) against its plain walk; K1 and K2 against their
     plain PyTorch versions (and against the reference backend's twin) at
     the full TinyLlama-1.1B shapes, on tables from real selections at
     sparsity 0.4, bf16 and int8, prefetch depths 0/1/2, plus the edge
     cases of the reference's kernel suite (all-padded table, one 512-row
     chunk, K >> real chunks, ±127 int8 saturation); the body of K1-K4 on
     shapes that stress its partition of the work (batch 1, 8 and 9, D =
     256 and a ragged D, fewer blocks than a CTA's lane groups, the empty
     table, one 512-row chunk, K >> chunks, blocks outside [0, N), a block
     list longer than its window, x too large to hold whole), over one
     weight stream (K1, K3) and two (K2's phase 1, K4; plus ±127 int8
     saturation), bf16/f32/int8 at depths 0-3, and the C and Python
     shared-memory layouts against each other; at InternVL2-76B's widths,
     K1 with an input mask at N = 8192 (the per-block input records) and
     K2's phase 1 at F = 28672 with a serve-width table (near the
     shared-memory limit), bf16 and int8 at depths 0-3; and the reduced
     model on the card against the same model on the CPU;
  4. the serve run: full-width tinyllama-1.1b, all 22 layers, random
     weights from a seed, ``--method chunk --backend kernel``, batch 2,
     prompt 32, 16 decode tokens, at wbits 16 and 8 — the launch counters
     must equal the per-step counts (K5 once per refresh step), and the
     same settings on the reference backend must give byte-identical
     tokens;
  5. the timings: each kernel over the serve run's own tables and weights
     (device time, from replays of a CUDA graph of the calls), beside its
     plain version (host clock), the dense library product where there is
     one, and its bound (the larger of the bytes the call must move over
     3.35 TB/s and its flops over the fp32 peak); K1 also per site (q, k,
     v, o), since k/v's narrow grid hides in the mean; K2's phase 1 alone
     beside the whole of K2; K5 over the run's own refresh-step input (all
     88 lanes in one launch), with each lane's candidates walked,
     survivors of the batch test and picks;
  6. the per-matrix library path on phase 4's weights: every offloaded
     matrix of every layer planned with ``NeuronChunkingPlanner`` (the walk
     is K5) at sparsity 0.4, K3 on q/k/v/o/down and K4 on gate/up off the
     plans' tables, then the quickstart entry point — exact launch counts;
     K3/K4 bitwise against their plain versions, K3 against K1 at depth 1,
     K4 against K2's h, the tables against ``masks_to_block_tables``, the
     one-lane walk against the plain walk; planning statistics against
     top-k; K3/K4 timed as in phase 5, K3 also per site (q, k, v, o, down),
     and K5's one-lane walks of the planner.
  7. the paper's VLM workload: internvl2-76b at full width (d_model 8192,
     d_ff 28672, vocab 128256), depth cut to 8 of 80 layers (the full
     model's 137 GB of bf16 layers do not fit one card), random weights
     from a seed: prefill of a 32-token prompt (16 vision, 16 text), 4
     frames of 64 tokens appended, 16 decode tokens, ``--method chunk
     --backend kernel``, batch 2, max_seq 512, at wbits 16 and 8 — exact
     launch counts (K5 once per refresh step and once per site and layer
     of each frame), tokens byte-identical to the reference backend; K1
     (every site of every layer), K2 (every layer) and K5 (the 32-lane
     refresh and each site's one-lane walk) bitwise against their plain
     versions on the run's own tables, the calls that are timed;
     the timings as in phase 5 plus K5's one-lane walks; the rows the
     kernels read against the rows selected; decode wall, the profiled
     device busy share and peak memory; the video-stream policy table
     (dense / top-k / chunk) at wbits 16. Phases 4-6's engines are freed
     first.
  8. the residency cache (paper §5), per-token decode and the blockwise
     prefill: full-width tinyllama-1.1b, all 22 layers, prompt 32, 16
     decode tokens, chunk at sparsity 0.4, wbits 16 and 8, with the cache
     at 0, 10 and 50 % of the offloaded bytes — exact launch counts on the
     kernel backend, tokens, hit and miss rows and io_est equal to the
     reference backend's, every (layer, site) within its row cap; simulated
     I/O, hit rate and wall per step by budget; ``decode_per_token``
     against ``decode`` at 10 % and refresh interval 2 (tokens equal, wall
     per token of each); ``reprice_timeline`` at depths 0-4; depth 7
     against depth 1 (tokens equal); K1, K2 and K5 (on the resident-aware
     refresh input) bitwise against their plain versions on the 10 % run's
     tables, and timed. Then internvl2-76b as in phase 7 at a 25 % budget:
     chunk at wbits 16 and 8 and top-k at 16, kernel against reference
     backend (launches exact, tokens equal), and the simulated I/O per
     token of chunk and top-k with and without the cache. Last, a prompt of
     16 frames x 256 vision tokens + 32 text tokens (4128 positions)
     through the blockwise prefill against the direct path: last-position
     logits within 5 % of their largest magnitude, and each path's peak
     device memory.
  9. storage faults, chunk integrity and adaptive degradation: K1 and K2
     with their checksum lanes on phase 5's and phase 7's own calls, at
     wbits 16 and 8 and depths 0, 1 and 3 — each launch bitwise against the
     launch without the lane and against the plain version, both timed;
     then full-width tinyllama-1.1b (22 layers, kernel backend, 16 decode
     tokens): every fault profile (tokens equal to the fault-off run's,
     charged time moved), ``thermal_throttle`` with and without the
     degradation controller (the scale below 1.0, fewer bytes per token),
     ``bit_rot`` with recovery at wbits 16 and 8 (tokens equal, detected ==
     recovered > 0, re-read seconds charged; the K1/K2 launches with their
     lanes counted from 0), ``degraded_nand`` and recovery off twice each
     (exact replays), the corruption draws on the card against the CPU's,
     and the refresh step's time with integrity on and off; at 4 of the 22
     layers, the kernel backend against the reference backend's twin on
     corrupted tokens; and internvl2-76b as in phase 7 at wbits 8 with
     ``bit_rot`` recovered (tokens equal to the corruption-off run's).

Prints the kernel table as one JSON line (K1-K5 from phases 4-6, phase
7's K1, K2 and K5 rows, phase 8's and phase 9's checksum-lane rows), then,
as the last line,
``{"ok": true, "device": {...}}``. A fuller report goes to
``chiprun_out/chip_smoke_report.json``.
"""
import gc
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and fp32 outside
# the tensor cores (the kernels contract in fp32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

BATCH, PROMPT, DECODE, REF_DECODE, PROFILE_TOKENS = 2, 32, 16, 4, 4
# phase 6: rows of activations a plan sees, the sparsity, and the output
# tile the kernels are asked for (the CUDA kernels tile by 64 columns)
LIB_ROWS, LIB_SPARSITY, LIB_TILE = 16, 0.4, 64
DEPTHS = (0, 1, 2)
# SparseExecution.time_selection: 1 warm-up + 5 timed refresh steps, one K5
# launch each
TIME_SELECTION_LAUNCHES = 6
# phase 7: the VLM at full width, depth cut to VLM_LAYERS; a prompt of
# VLM_PROMPT tokens (half vision, half text), VLM_FRAMES frames of
# frontend_tokens // 4 tokens, VLM_DECODE decode tokens
VLM_ARCH, VLM_LAYERS, VLM_PROMPT, VLM_FRAMES, VLM_DECODE, VLM_MAX_SEQ = (
    "internvl2-76b", 8, 32, 4, 16, 512)


# phase 8: the residency cache's budgets as fractions of the offloaded
# bytes (TinyLlama, full depth), the VLM's, and the long prompt (frames of
# frontend_tokens vision tokens, then text) with the blockwise-vs-direct
# tolerance on its logits, a fraction of their largest magnitude, and on
# layer 0's f32 attention (the reference suite's, tests/test_attention.py)
CACHE_FRACS, VLM_CACHE_FRAC = (0.0, 0.1, 0.5), 0.25
LONG_FRAMES, LONG_TEXT, LONG_TOL, LONG_ATOL = 16, 32, 0.05, 2e-5


# phase 9: the ring depths the checksum lanes are checked and timed at, the
# fault profiles' seed (the CLI's default), the corruption seeds, and the
# depth of the kernel-vs-twin runs on corrupted tokens
LANE_DEPTHS = (0, 1, 3)
FAULT_SEED, CORRUPTION_SEED, NAND_SEED, TWIN_LAYERS = 0, 7, 3, 4
REFRESH_REPS = 8


# the K1 body's edge cases of phase 3 (see k1_case)
K1_CASES = ("b1", "b8", "b9", "d256", "ragged", "few", "empty", "one512", "k_far", "outside",
            "windows", "records")


def k1_case(case, wname, randn, dev):
    """(w, x, starts, sizes, scales) for one K1-body edge case, on dev."""
    import torch

    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.kernels.quantize import quantize_rows

    n, d, b = {"b1": (512, 256, 1), "b8": (512, 256, 8), "b9": (512, 256, 9),
               "d256": (2048, 256, 2), "ragged": (512, 208 if wname == "int8" else 200, 2),
               "records": (4096, 256, 8)}.get(case, (1024, 256, 2))
    k = n // 8
    st = torch.zeros(k, dtype=torch.int32, device=dev)
    sz = torch.zeros_like(st)
    few = {"few": ((64,), (16,)), "one512": ((512,), (512,)), "k_far": ((64, 512), (16, 40)),
           "outside": ((-24, n - 16, 96), (48, 64, 8)), "windows": ((0,) * 40, (512,) * 40)}
    if case in few:
        s0, z0 = few[case]
        st[: len(s0)] = torch.tensor(s0, dtype=torch.int32, device=dev)
        sz[: len(z0)] = torch.tensor(z0, dtype=torch.int32, device=dev)
    elif case != "empty":
        st, sz = cg.masks_to_block_tables((randn(1, n) > 0.0), 8, 512)
        st, sz = st[0], sz[0]
    w = randn(n, d)
    sc = None
    if wname == "bf16":
        w = w.to(torch.bfloat16)
    elif wname == "int8":
        w, sc = quantize_rows(w, 8)
    return w, randn(b, n), st, sz, sc


def k2_case(case, wname, randn, dev):
    """(w_gate, x, starts, sizes, gate scales, w_up, up scales) for one edge
    case of the body over two weight streams: K1's cases with a second
    matrix of the same shape, and "sat", int8 blocks saturated at ±127 in
    one 512-row chunk."""
    import torch

    from repro_torch.kernels.quantize import quantize_rows

    if case == "sat":
        n, d = 512, 256
        sat = torch.zeros(n, d, device=dev)
        sat[:8], sat[8:16], sat[16:24, 0] = 4.0, -4.0, 1e-3
        wg, sg = quantize_rows(sat, 8)
        wu, su = quantize_rows(-sat, 8)
        st = torch.zeros(n // 8, dtype=torch.int32, device=dev)
        sz = st.clone()
        sz[0] = n
        return wg, randn(2, n), st, sz, sg, wu, su
    wg, x, st, sz, sg = k1_case(case, wname, randn, dev)
    wu, su = randn(*wg.shape), None
    if wname == "bf16":
        wu = wu.to(torch.bfloat16)
    elif wname == "int8":
        wu, su = quantize_rows(wu, 8)
    return wg, x, st, sz, sg, wu, su


def gate_up(wg, wu, x, starts, sizes, sg, su, depth):
    """K2's phase 1 alone (``k2_gate_up``: h off one table) at ring depth
    ``depth``; its plain version on the CPU."""
    from repro_torch.kernels import chunk_gather_dma as cg

    if x.device.type == "cpu":
        return cg.chunk_gather_swiglu_plain(wg, wu, x, starts, sizes,
                                            None if sg is None else (sg, su))
    return cg._launch_k2_gate_up(wg, wu, x, starts, sizes, sg, su, 512, depth)


def decode_timings(eng, wbits, randn, cuda_ms, host_ms, card, tag):
    """Each decode kernel of one served engine, over that engine's own
    tables, weights and last refresh input: K1 (in all and per site q, k,
    v, o, beside the dense library product), K2 and its phase 1 alone, K5
    over one refresh step's lanes with what each lane's walk meets. Device
    time per launch from CUDA-graph replays, the plain versions on the
    host clock, the bound from the bytes and flops of the call. Returns
    (timing, calls): the calls timed, {"k1": [(w, xm, starts, sizes,
    scales)], "k1_sites": [name], "k2": [(w_gate, w_up, w_down, xm,
    starts, sizes, ffn_mask, scales)], "k5": [greedy_select's arguments]},
    every layer's, layer by layer."""
    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg

    cfg = eng.model.cfg
    n_layers, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    hd_all = cfg.n_heads * cfg.resolved_head_dim
    plan, lp = eng._plan, eng.params["layers"]
    sp = eng.sparse_ctx
    el = 2 if wbits == 16 else 1
    k1_calls, k2_calls, k5_inputs = [], [], []
    k1_sites, k1_bounds = [], []
    k1_bytes = k1_ops = k2_bytes = k2_ops = g1_bytes = g1_ops = 0.0
    k1_bound = k2_bound = g1_bound = 0.0
    for layer in range(n_layers):
        for name, site, n_in in (("wq", "hidden_attn", d), ("wk", "hidden_attn", d),
                                 ("wv", "hidden_attn", d), ("wo", "attn_out", hd_all)):
            w = lp[name][layer] if wbits == 16 else lp[name + "_q8"][layer]
            sc = None if wbits == 16 else lp[name + "_sc"][layer]
            s, z = sp.kernel_tables(plan, site, layer)
            xm = randn(BATCH, n_in) * plan[site]["mask"][layer]
            k1_calls.append((w, xm, s, z, sc))
            rows = rows_of(z)
            byts = (rows * w.shape[1] * el + (rows // 8 * 4 if sc is not None else 0)
                    + BATCH * n_in * 4 + 2 * 4 * s.numel() + BATCH * w.shape[1] * 4)
            ops = 2.0 * BATCH * rows * w.shape[1]
            k1_bytes, k1_ops = k1_bytes + byts, k1_ops + ops
            k1_bound += max(byts / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
            k1_sites.append(name)
            k1_bounds.append(max(byts / HBM_BYTES_PER_S, ops / F32_OPS_PER_S))
        ws = [lp[n][layer] if wbits == 16 else lp[n + "_q8"][layer]
              for n in ("w_gate", "w_up", "w_down")]
        scs = None if wbits == 16 else tuple(lp[n + "_sc"][layer]
                                             for n in ("w_gate", "w_up", "w_down"))
        st, sz = sp.mlp_kernel_plan(plan, layer)
        fm = plan["ffn"]["mask"][layer]
        xm = randn(BATCH, d) * plan["hidden_mlp"]["mask"][layer]
        k2_calls.append((*ws, xm, st, sz, fm, scs))
        rh, rf = rows_of(sz[0]), rows_of(sz[1])
        byts = (2 * rh * f * el + rf * d * el
                + ((2 * rh + rf) // 8 * 4 if scs is not None else 0)
                + BATCH * d * 4 + f * 4 + 2 * 2 * 4 * st.shape[1]
                + BATCH * f * 4 + BATCH * d * 4)
        ops = 2.0 * BATCH * (2 * rh * f + rf * d)
        k2_bytes, k2_ops = k2_bytes + byts, k2_ops + ops
        k2_bound += max(byts / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
        # K2's phase 1 alone: gate and up in, h out
        byts = (2 * rh * f * el + (2 * rh // 8 * 4 if scs is not None else 0)
                + BATCH * d * 4 + 2 * 4 * st.shape[1] + BATCH * f * 4)
        ops = 2.0 * BATCH * 2 * rh * f
        g1_bytes, g1_ops = g1_bytes + byts, g1_ops + ops
        g1_bound += max(byts / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    # K5 over the run's own refresh-step input: every layer's sites from
    # the importances the last step recorded (and, with the residency
    # cache, at marginal cost against the resident sets), one launch
    b = sp.batched
    lanes = n_layers * b.n_sites
    k5_inputs.append(refresh_input(eng))
    n1, n2, n5 = len(k1_calls), len(k2_calls), len(k5_inputs)

    def run_k1(plain=False, calls=k1_calls):
        for w, xm, s, z, sc in calls:
            if plain:
                cg.chunk_gather_matmul_plain(w, xm, s, z, sc)
            else:
                cg.chunk_gather_matmul_dma(w, xm, s, z, sc)

    def run_k1_lib(calls=k1_calls):
        for w, xm, s, z, sc in calls:
            if sc is None:
                xm.to(w.dtype) @ w

    def run_k2(plain=False):
        for wg, wu, wd, xm, st, sz, fm, scs in k2_calls:
            if plain:
                cg.chunk_gather_mlp_plain(wg, wu, wd, xm, st, sz, fm, scs)
            else:
                cg.chunk_gather_mlp_dma(wg, wu, wd, xm, st, sz, fm, scs, return_h=True)

    def run_gate_up(plain=False):
        for wg, wu, _, xm, st, sz, _, scs in k2_calls:
            sg, su = (None, None) if scs is None else scs[:2]
            if plain:
                cg.chunk_gather_swiglu_plain(wg, wu, xm, st[0], sz[0],
                                             None if scs is None else (sg, su))
            else:
                gate_up(wg, wu, xm, st[0], sz[0], sg, su, 1)

    def run_k5(plain=False, walked=None):
        fn = chunking.greedy_select_plain if plain else chunking.greedy_select
        for args in k5_inputs:
            if plain:
                fn(*args, walked=walked)
            else:
                fn(*args)

    walked = []
    t_k5_plain = host_ms(lambda: run_k5(True, walked)) / n5
    k5_bytes = sum(walked) * 8 + n5 * lanes * (b.n_max + 12)
    k5_bound = k5_bytes / HBM_BYTES_PER_S / n5
    k5_lanes = walk_stats(*k5_inputs[0])
    if k5_lanes["selected"] != chunking.greedy_select(*k5_inputs[0])[1].tolist():
        fail(f"w{wbits}: the replayed K5 walk selects other rows than the kernel")
    timing = {
        "chunk_gather_matmul_dma": {
            "ms": cuda_ms(run_k1, 20) / n1, "plain_ms": host_ms(lambda: run_k1(True)) / n1,
            "library_ms": cuda_ms(run_k1_lib, 20) / n1 if wbits == 16 else None,
            "bound_ms": k1_bound / n1 * 1e3,
            "bound_by": "bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / F32_OPS_PER_S
            else "operations",
            "calls": n1, "bytes_per_call": k1_bytes / n1},
        "chunk_gather_mlp_dma": {
            "ms": cuda_ms(run_k2, 20) / n2, "plain_ms": host_ms(lambda: run_k2(True)) / n2,
            "library_ms": None, "bound_ms": k2_bound / n2 * 1e3,
            "bound_by": "bytes" if k2_bytes / HBM_BYTES_PER_S >= k2_ops / F32_OPS_PER_S
            else "operations",
            "calls": n2, "bytes_per_call": k2_bytes / n2},
        "greedy_select": {
            "ms": cuda_ms(run_k5, 5) / n5, "plain_ms": t_k5_plain, "library_ms": None,
            "bound_ms": k5_bound * 1e3, "bound_by": "bytes", "calls": n5, "lanes": lanes,
            "walked_per_lane": sum(walked) / max(len(walked), 1), "per_lane": k5_lanes},
    }
    phase1 = {"ms": cuda_ms(run_gate_up, 20) / n2,
              "plain_ms": host_ms(lambda: run_gate_up(True)) / n2,
              "bound_ms": g1_bound / n2 * 1e3,
              "bound_by": "bytes" if g1_bytes / HBM_BYTES_PER_S >= g1_ops / F32_OPS_PER_S
              else "operations"}
    timing["chunk_gather_mlp_dma"]["phase1"] = phase1
    log(f"{tag} chunk_gather_mlp_dma phase 1 alone (k2_gate_up): "
        f"{phase1['ms'] * 1e3:.1f} us/launch  bound {phase1['bound_ms'] * 1e3:.2f} us "
        f"({phase1['bound_by']})  plain {phase1['plain_ms'] * 1e3:.1f} us  ({card})")
    worst = max(range(lanes), key=lambda i: k5_lanes["walked"][i])
    log(f"{tag} greedy_select over {lanes} lanes: per lane walked mean "
        f"{sum(k5_lanes['walked']) / lanes:.0f} max {k5_lanes['walked'][worst]} (lane {worst}), "
        f"survivors mean {sum(k5_lanes['survivors']) / lanes:.0f} max "
        f"{max(k5_lanes['survivors'])}, picks mean {sum(k5_lanes['picks']) / lanes:.1f} max "
        f"{max(k5_lanes['picks'])}, batches with 2+ survivors "
        f"{sum(k5_lanes['crowded_batches'])}  ({card})")
    sites = per_site(k1_calls, k1_sites, k1_bounds, run_k1,
                     run_k1_lib if wbits == 16 else None, cuda_ms)
    timing["chunk_gather_matmul_dma"]["per_site"] = sites
    log(f"{tag} chunk_gather_matmul_dma per site: {site_line(sites)}  ({card})")
    return timing, {"k1": k1_calls, "k1_sites": k1_sites, "k2": k2_calls, "k5": k5_inputs}


def lane_timings(calls, wbits, check, cuda_ms, host_ms, card, tag):
    """Phase 9's kernel half, on one served engine's own calls (phase 5's
    or phase 7's): K1 at every site of every layer and K2 at every layer,
    each with its checksum lanes (the words of its weights, as the engine
    packs them) and without, at depths LANE_DEPTHS: each lane launch
    bitwise against the launch without the lane and against the plain
    version; the mean device time per launch of both (CUDA-graph replays);
    the plain version's host time; the bound with the lane's bytes (4 per
    block and stream read). Returns {kernel: {...}} at every depth."""
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.kernels.quantize import block_checksums

    el = 2 if wbits == 16 else 1
    k1 = [(w, xm, s, z, sc, block_checksums(w)) for w, xm, s, z, sc in calls["k1"]]
    k2 = [(wg, wu, wd, xm, st, sz, fm, scs,
           (block_checksums(wg), block_checksums(wu), block_checksums(wd)))
          for wg, wu, wd, xm, st, sz, fm, scs in calls["k2"]]
    k1_plain = [cg.chunk_gather_matmul_plain(w, xm, s, z, sc) for w, xm, s, z, sc, _ in k1]
    k2_plain = [cg.chunk_gather_mlp_plain(wg, wu, wd, xm, st, sz, fm, scs)
                for wg, wu, wd, xm, st, sz, fm, scs, _ in k2]
    k1_bound = k2_bound = 0.0
    k1_by = k2_by = 0.0  # bytes time minus operations time, summed
    for w, xm, s, z, sc, _ in k1:
        rows = rows_of(z)
        byts = (rows * w.shape[1] * el + rows // 8 * 4 * (2 if sc is not None else 1)
                + xm.numel() * 4 + 2 * 4 * s.numel() + xm.shape[0] * w.shape[1] * 4)
        ops = 2.0 * xm.shape[0] * rows * w.shape[1]
        k1_bound += max(byts / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
        k1_by += byts / HBM_BYTES_PER_S - ops / F32_OPS_PER_S
    for wg, wu, wd, xm, st, sz, fm, scs, _ in k2:
        rh, rf = rows_of(sz[0]), rows_of(sz[1])
        f, d = wg.shape[1], wd.shape[1]
        byts = (2 * rh * f * el + rf * d * el
                + (2 * rh + rf) // 8 * 4 * (2 if scs is not None else 1)
                + xm.numel() * 4 + f * 4 + 2 * 2 * 4 * st.shape[1]
                + xm.shape[0] * f * 4 + xm.shape[0] * d * 4)
        ops = 2.0 * xm.shape[0] * (2 * rh * f + rf * d)
        k2_bound += max(byts / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
        k2_by += byts / HBM_BYTES_PER_S - ops / F32_OPS_PER_S

    def run_k1(depth, lane, plain=False):
        for w, xm, s, z, sc, ck in k1:
            if plain:
                cg.chunk_gather_matmul_plain(w, xm, s, z, sc, checksums=ck)
            else:
                cg.chunk_gather_matmul_dma(w, xm, s, z, sc, ck if lane else None,
                                           prefetch_depth=depth)

    def run_k2(depth, lane, plain=False):
        for wg, wu, wd, xm, st, sz, fm, scs, cks in k2:
            if plain:
                cg.chunk_gather_mlp_plain(wg, wu, wd, xm, st, sz, fm, scs, checksums=cks)
            else:
                cg.chunk_gather_mlp_dma(wg, wu, wd, xm, st, sz, fm, scs, cks if lane else None,
                                        prefetch_depth=depth, return_h=True)

    out = {"chunk_gather_matmul_dma": {"plain_ms": host_ms(lambda: run_k1(1, True, True))
                                       / len(k1), "bound_ms": k1_bound / len(k1) * 1e3,
                                       "bound_by": "bytes" if k1_by >= 0 else "operations",
                                       "calls": len(k1)},
           "chunk_gather_mlp_dma": {"plain_ms": host_ms(lambda: run_k2(1, True, True))
                                    / len(k2), "bound_ms": k2_bound / len(k2) * 1e3,
                                    "bound_by": "bytes" if k2_by >= 0 else "operations",
                                    "calls": len(k2)}}
    for depth in LANE_DEPTHS:
        for i, (w, xm, s, z, sc, ck) in enumerate(k1):
            y0 = cg.chunk_gather_matmul_dma(w, xm, s, z, sc, prefetch_depth=depth)
            y1 = cg.chunk_gather_matmul_dma(w, xm, s, z, sc, ck, prefetch_depth=depth)
            check("chunk_gather_matmul_dma", f"{tag} d{depth} call {i} lane vs none", y1, y0)
            check("chunk_gather_matmul_dma", f"{tag} d{depth} call {i} lane vs plain", y1,
                  k1_plain[i])
        for i, (wg, wu, wd, xm, st, sz, fm, scs, cks) in enumerate(k2):
            a = cg.chunk_gather_mlp_dma(wg, wu, wd, xm, st, sz, fm, scs, prefetch_depth=depth,
                                        return_h=True)
            b = cg.chunk_gather_mlp_dma(wg, wu, wd, xm, st, sz, fm, scs, cks,
                                        prefetch_depth=depth, return_h=True)
            for what, got, none, plain in zip("yh", b, a, k2_plain[i]):
                check("chunk_gather_mlp_dma", f"{tag} d{depth} layer {i} {what} lane vs none",
                      got, none)
                check("chunk_gather_mlp_dma", f"{tag} d{depth} layer {i} {what} lane vs plain",
                      got, plain)
        for name, run, n in (("chunk_gather_matmul_dma", run_k1, len(k1)),
                             ("chunk_gather_mlp_dma", run_k2, len(k2))):
            # in turns: without, with, with, without
            t = [cuda_ms(lambda lane=lane: run(depth, lane), 20) / n
                 for lane in (False, True, True, False)]
            out[name][depth] = {"ms_lane": (t[1] + t[2]) / 2, "ms_none": (t[0] + t[3]) / 2}
    for name, v in out.items():
        log(f"{tag} {name} with / without the checksum lane: " + "  ".join(
            f"depth {dp} {v[dp]['ms_lane'] * 1e3:.1f} / {v[dp]['ms_none'] * 1e3:.1f} us"
            for dp in LANE_DEPTHS) + f"  bound {v['bound_ms'] * 1e3:.2f} us ({v['bound_by']}, "
            f"lane bytes included)  plain {v['plain_ms'] * 1e3:.1f} us  ({card})")
    return out


def refresh_input(eng):
    """K5's arguments for the next refresh step of a served engine: every
    layer's sites padded into one problem from the importances the last
    step recorded; with the residency cache, the resident sets derived
    from the plan's scores price each window at its miss rows, as
    ``SparseExecution.refresh_step`` does."""
    import torch

    from repro_torch.serving.sparse_exec import residency_from_score

    sp, plan = eng.sparse_ctx, eng._plan
    b = sp.batched
    n_layers = eng.model.cfg.n_layers
    lanes = n_layers * b.n_sites
    shape = (n_layers, b.n_sites, b.n_max)
    vs = torch.zeros(shape, device=eng.torch_device)
    scores = torch.zeros(shape, device=eng.torch_device)
    for i, kind in enumerate(sp.site_order):
        vs[:, i, : sp.sites[kind].n] = plan[kind]["pending"]
        if sp.cache_enabled:
            scores[:, i, : sp.sites[kind].n] = plan[kind]["score"]
    res = residency_from_score(scores, sp._caps()) if sp.cache_enabled else None
    return (*(t.reshape(lanes, -1) for t in b.sorted_candidates(vs, res)),
            sp.lane_budgets, sp.lane_min_sizes, b.n_max)


def walk_stats(starts_s, sizes_s, budgets, min_sizes, n_max):
    """What K5's walk meets in each lane of one launch, replayed on the host
    in the kernel's batches of 32: candidates walked (whole batches, to the
    early exit), survivors of the test against the selection at the batch's
    start, picks, batches with two or more survivors, and the rows
    selected."""
    out = {"walked": [], "survivors": [], "picks": [], "crowded_batches": [], "selected": []}
    for st, sz, budget, mn in zip(starts_s.cpu().tolist(), sizes_s.cpu().tolist(),
                                  budgets.cpu().tolist(), min_sizes.cpu().tolist()):
        m = bytearray(n_max)
        sel = walked = survivors = picks = crowded = 0
        done = sel + mn > budget
        for b0 in range(0, len(st), 32):
            if done:
                break
            batch = list(zip(st[b0:b0 + 32], sz[b0:b0 + 32]))
            walked += len(batch)
            live = [(s0, z0) for s0, z0 in batch if 0 < z0 <= budget - sel and s0 >= 0
                    and s0 + z0 <= n_max and 1 not in m[s0:s0 + z0]]
            survivors += len(live)
            crowded += len(live) > 1
            for s0, z0 in live:  # one by one, in order, against the batch's own picks
                if z0 > budget - sel or 1 in m[s0:s0 + z0]:
                    continue
                m[s0:s0 + z0] = b"\x01" * z0
                sel, picks = sel + z0, picks + 1
                if sel + mn > budget:
                    done = True
                    break
        for key, v in zip(out, (walked, survivors, picks, crowded, sel)):
            out[key].append(v)
    return out


def per_site(calls, sites, bounds_s, run, run_lib, cuda_ms):
    """Device time per launch of each site's calls (the mean over all sites
    hides a site's narrow grid), beside its mean bound and one library call
    per launch (None where there is none)."""
    out = {}
    for site in dict.fromkeys(sites):
        sub = [c for c, s in zip(calls, sites) if s == site]
        bnd = [b for b, s in zip(bounds_s, sites) if s == site]
        out[site] = {"calls": len(sub), "ms": cuda_ms(lambda: run(calls=sub), 20) / len(sub),
                     "library_ms": None if run_lib is None
                     else cuda_ms(lambda: run_lib(sub), 20) / len(sub),
                     "bound_ms": sum(bnd) / len(bnd) * 1e3}
    return out


def site_line(sites):
    return "  ".join(
        f"{k} {v['ms'] * 1e3:.1f} us (bound {v['bound_ms'] * 1e3:.2f}, "
        f"{v['bound_ms'] / v['ms']:.0%} of it"
        + ("" if v["library_ms"] is None else f"; (x·m) @ W {v['library_ms'] * 1e3:.1f}") + ")"
        for k, v in sites.items())


def timers(on_card):
    """(cuda_ms, host_ms): the device time of one fn() from replays of a
    CUDA graph of it (no host dispatch gaps between the launches; on the
    CPU its host time), and the host-clock time of one synchronised fn()."""
    import torch

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def cuda_ms(fn, reps):
        fn()
        if not on_card:
            return host_ms(fn)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def host_ms(fn):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t) * 1e3

    return cuda_ms, host_ms


def seeded(dev, seed):
    """(randn, sync) on dev: randn(*shape, std=1.0) draws from one generator
    seeded with ``seed``; sync waits for the card (nothing on the CPU)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    return randn, sync


class Checks:
    """``check(kernel, what, got, want)``: one bitwise check of a kernel
    against its plain version. Keeps the count, each kernel's largest abs
    error and the failures, in order."""

    def __init__(self, kernels):
        self.errs = dict.fromkeys(kernels, 0.0)
        self.failures = []
        self.n = 0

    def __call__(self, kernel, what, got, want):
        import torch

        self.n += 1
        if got.shape != want.shape:
            self.failures.append(f"{kernel} {what}: shape {tuple(got.shape)} != "
                                 f"{tuple(want.shape)}")
            return
        diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        self.errs[kernel] = max(self.errs[kernel], err)
        if not torch.equal(got, want):
            self.failures.append(f"{kernel} {what}: not bitwise equal (max abs err {err:.3e})")


def rows_of(sizes):
    """Rows a kernel reads for a table's sizes: whole 8-row blocks, at
    most 512 rows of a chunk."""
    import torch

    z = sizes.cpu().clamp(min=0)
    return int((torch.minimum((z + 7) // 8, torch.tensor(64)) * 8).sum())


def fail(msg):
    print(f"[FAIL] {msg}", flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def main():
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        fail("src/repro_torch is not beside chip_smoke.py: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    report = {"phase_end_s": {}}
    t_start = time.perf_counter()

    def done(name):
        """Free what the phase left and log the script's clock at its end."""
        gc.collect()
        torch.cuda.empty_cache()
        report["phase_end_s"][name] = time.perf_counter() - t_start
        log(f"[clock] {name} done at {report['phase_end_s'][name]:.1f} s")

    # -- 1. the card --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    report["card"] = card

    # -- 2. the build ---------------------------------------------------------
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(p.name for p in paths.values())})")
    OUT.mkdir(exist_ok=True)
    (OUT / "ptxas.txt").write_text("\n".join(f"== {k}\n{v}" for k, v in build.BUILD_LOG.items()))
    for src, text in build.BUILD_LOG.items():
        fn = spill = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
                for kernel in ("k1_kernel", "k2_gate_up_kernel", "k3_kernel", "k4_kernel",
                               "k5_kernel"):
                    if kernel in fn:  # kernel + its mangled template args
                        fn = kernel + fn.split(kernel, 1)[1].split("EEv")[0]
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line and fn:
                log(f"[ptxas] {src} {fn}: {line.split(':', 1)[-1].strip()}; {spill}")
    for src in paths:
        build.library(src)

    from repro_torch.configs import get_config

    done("phases 1-2 (card, build)")
    kernels = run(dev, get_config("tinyllama-1.1b"), card, report, get_config(VLM_ARCH))
    done("phases 3-6")  # phase 4-6's engines and weights go before phase 7's
    kernels += vlm_path(dev, get_config(VLM_ARCH), card, report)
    done("phase 7")
    kernels += cache_path(dev, get_config("tinyllama-1.1b"), card, report)
    done("phase 8, TinyLlama cache")
    vcfg, vmodel, vparams = vlm_model(dev, get_config(VLM_ARCH))
    vlm_cache(dev, vcfg, vmodel, vparams, card, report)
    done("phase 8, InternVL2 cache")
    long_prompt(dev, vcfg, vmodel, vparams, card, report)
    done("phase 8, long prompt")
    vlm_integrity(dev, vcfg, vmodel, vparams, card, report)
    del vparams
    done("phase 9, InternVL2 integrity")
    robust_path(dev, get_config("tinyllama-1.1b"), card, report)
    done("phase 9, TinyLlama faults and integrity")
    kernels += lane_rows(report)
    (OUT / "chip_smoke_report.json").write_text(json.dumps(report, indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def profile_decode(eng, token, card):
    """A profiled decode call of PROFILE_TOKENS steps: device time by
    kernel, the device's busy share of the call's wall, and the host ops
    that take the most time. The profiler's own overhead inflates the wall,
    so the shares are of the profiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.decode(token, PROFILE_TOKENS)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, cpu_ops = {}, {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # the device's own events (kernels, copies), each counted once:
            # an aten op's device time is its kernels', listed under them
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us
        elif ev.self_cpu_time_total > 0:
            cpu_ops[ev.key] = (ev.self_cpu_time_total, ev.count)
    busy = sum(kernels.values())
    if busy == 0:
        log("[profile] the profiler recorded no device time")
        return {"wall_us": wall_us}
    out = {"wall_us": wall_us, "device_busy_us": busy, "device_busy_share": busy / wall_us,
           "device_us": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15]),
           "host_ops": dict(sorted(cpu_ops.items(), key=lambda kv: -kv[1][0])[:15])}
    ours = {name: sum(v for k, v in kernels.items() if name in k)
            for name in ("k1_kernel", "k2_gate_up_kernel", "k5_kernel")}
    log(f"[profile] {PROFILE_TOKENS} steps, wall {wall_us / 1e3:.1f} ms (profiled): device busy "
        f"{busy / wall_us:.1%}, idle {1 - busy / wall_us:.1%}; "
        + ", ".join(f"{k} {v / wall_us:.1%}" for k, v in ours.items())
        + f"; other device work {(busy - sum(ours.values())) / wall_us:.1%}  ({card})")
    top = sorted(cpu_ops.items(), key=lambda kv: -kv[1][0])[:8]
    log("[profile] host self time: " + ", ".join(
        f"{k} {v[0] / 1e3:.1f} ms/{v[1]}" for k, v in top))
    return out


def run(dev, cfg, card, report, vcfg):
    """Phases 3-6 on ``dev`` for ``cfg`` (phase 3 also at the widths of the
    VLM config ``vcfg``); returns the kernel table. On a CPU device (a
    rehearsal of the script's own code at reduced configs) the wrappers take
    their plain versions, so the launch counts are not checked and times are
    host times."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.kernels.backend import ExecutionBackend
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.models import build_model
    from repro_torch.models.inputs import make_dummy_batch
    from repro_torch.serving import ServeEngine, SparseExecution

    on_card = dev.type == "cuda"
    n_layers = cfg.n_layers
    randn, sync = seeded(dev, 1234)

    # -- 3. kernel vs plain, bitwise ------------------------------------------
    check = Checks(("chunk_gather_matmul_dma", "chunk_gather_mlp_dma", "greedy_select",
                    "chunk_gather_matmul", "chunk_gather_swiglu"))
    errs, failures = check.errs, check.failures

    d, f = cfg.d_model, cfg.d_ff
    hd_all = cfg.n_heads * cfg.resolved_head_dim
    kv_all = cfg.n_kv_heads * cfg.resolved_head_dim
    w16 = {"wq": randn(d, hd_all, std=d ** -0.5), "wk": randn(d, kv_all, std=d ** -0.5),
           "wv": randn(d, kv_all, std=d ** -0.5), "wo": randn(hd_all, d, std=hd_all ** -0.5),
           "w_gate": randn(d, f, std=d ** -0.5), "w_up": randn(d, f, std=d ** -0.5),
           "w_down": randn(f, d, std=f ** -0.5)}
    w16 = {k: v.to(torch.bfloat16) for k, v in w16.items()}
    w8 = {k: quantize_rows(v, 8) for k, v in w16.items()}
    x_attn = randn(BATCH, d).to(torch.bfloat16)
    x_o = randn(BATCH, hd_all).to(torch.bfloat16)
    x_mlp = randn(BATCH, d).to(torch.bfloat16)
    walked_full = {}
    for wbits in (16, 8):
        # K5 over a refresh step's lanes: every site of every layer
        sp = SparseExecution(cfg, sparsity=0.4, wbits=wbits, torch_device=dev)
        b = sp.batched
        lanes = n_layers * b.n_sites
        vs = randn(n_layers, b.n_sites, b.n_max).abs()
        starts_s, sizes_s = (t.reshape(lanes, -1) for t in b.sorted_candidates(vs))
        k5_args = (starts_s, sizes_s, sp.lane_budgets, sp.lane_min_sizes,
                   b.n_max)
        masks_k, sel_k = chunking.greedy_select(*k5_args)
        walked = []
        masks_p, sel_p = chunking.greedy_select_plain(*k5_args, walked)
        walked_full[wbits] = walked
        check("greedy_select", f"w{wbits} {lanes} lanes masks", masks_k, masks_p)
        check("greedy_select", f"w{wbits} {lanes} lanes selected", sel_k, sel_p)
        masks = masks_k[: b.n_sites] & b.row_valid
        st, sz = cg.masks_to_block_tables(masks, 8, 512)
        lane = {k: i for i, k in enumerate(sp.site_order)}
        m = {k: masks[lane[k], : sp.sites[k].n] for k in sp.site_order}
        tab = {k: (st[lane[k]], sz[lane[k]]) for k in sp.site_order}
        mlp_st = torch.stack([st[lane["hidden_mlp"]], st[lane["ffn"]]])
        mlp_sz = torch.stack([sz[lane["hidden_mlp"]], sz[lane["ffn"]]])

        def weight(name):
            return (w16[name], None) if wbits == 16 else w8[name]

        proj = (("wq", x_attn, "hidden_attn"), ("wk", x_attn, "hidden_attn"),
                ("wv", x_attn, "hidden_attn"), ("wo", x_o, "attn_out"))
        ref_backend = ExecutionBackend.create("reference")
        twin = {name: ref_backend.project(weight(name)[0], x, m[site], *tab[site],
                                          weight(name)[1]) for name, x, site in proj}
        gu = [weight(n) for n in ("w_gate", "w_up", "w_down")]
        scales = None if wbits == 16 else tuple(s for _, s in gu)
        twin_mlp = ref_backend.swiglu_mlp(gu[0][0], gu[1][0], gu[2][0], x_mlp,
                                          m["hidden_mlp"], m["ffn"], mlp_st, mlp_sz, scales)
        for depth in DEPTHS:
            kern = ExecutionBackend.create("kernel", prefetch_depth=depth)
            for name, x, site in proj:
                w, sc = weight(name)
                y = kern.project(w, x, m[site], *tab[site], sc)
                check("chunk_gather_matmul_dma", f"w{wbits} d{depth} {name} vs twin", y,
                      twin[name])
                xm = (x * m[site].to(x.dtype)).float()
                check("chunk_gather_matmul_dma", f"w{wbits} d{depth} {name} vs plain", y,
                      cg.chunk_gather_matmul_plain(w, xm, *tab[site], sc))
            yk, hk = kern.swiglu_mlp(gu[0][0], gu[1][0], gu[2][0], x_mlp, m["hidden_mlp"],
                                     m["ffn"], mlp_st, mlp_sz, scales)
            check("chunk_gather_mlp_dma", f"w{wbits} d{depth} y vs twin", yk, twin_mlp[0])
            check("chunk_gather_mlp_dma", f"w{wbits} d{depth} h vs twin", hk, twin_mlp[1])
            xm = (x_mlp * m["hidden_mlp"].to(x_mlp.dtype)).float()
            yp, hp = cg.chunk_gather_mlp_plain(gu[0][0], gu[1][0], gu[2][0], xm, mlp_st,
                                               mlp_sz, m["ffn"].float(), scales)
            check("chunk_gather_mlp_dma", f"w{wbits} d{depth} y vs plain", yk, yp)
            check("chunk_gather_mlp_dma", f"w{wbits} d{depth} h vs plain", hk, hp)

    # edge cases of the reference's kernel suite, at the q-projection shape
    k_tab = d // 8
    xe = randn(BATCH, d)
    sat = torch.zeros(d, hd_all, device=dev)
    sat[:8], sat[8:16], sat[16:24, 0] = 4.0, -4.0, 1e-3
    q_sat, s_sat = quantize_rows(sat, 8)
    if int(q_sat.max()) != 127 or int(q_sat.min()) != -127:
        failures.append("quantize_rows: saturation blocks are not ±127")
    zeros = torch.zeros(k_tab, dtype=torch.int32, device=dev)
    one_st, one_sz = zeros.clone(), zeros.clone()
    one_st[0], one_sz[0] = 512, 512
    few_st, few_sz = zeros.clone(), zeros.clone()
    few_st[:2] = torch.tensor([64, 1024], device=dev)
    few_sz[:2] = torch.tensor([16, 40], device=dev)
    full_sz = zeros.clone()
    full_sz[: d // 512] = 512
    full_st = zeros.clone()
    full_st[: d // 512] = torch.arange(0, d, 512, device=dev, dtype=torch.int32)
    edge = [("all-padded", zeros, zeros), ("one 512-row chunk", one_st, one_sz),
            ("K >> real chunks", few_st, few_sz)]
    for depth in DEPTHS:
        for wname, (w, sc) in (("bf16", (w16["wq"], None)), ("int8", w8["wq"]),
                               ("int8 ±127", (q_sat, s_sat))):
            cases = edge + ([("±127 full table", full_st, full_sz)] if "±" in wname else [])
            for what, s, z in cases:
                y = cg.chunk_gather_matmul_dma(w, xe, s, z, sc, prefetch_depth=depth)
                check("chunk_gather_matmul_dma", f"edge {what} {wname} d{depth}", y,
                      cg.chunk_gather_matmul_plain(w, xe, s, z, sc))
                if what == "all-padded" and float(y.abs().max()) != 0.0:
                    failures.append(f"K1 all-padded table is not exact zero ({wname})")
        empty = torch.zeros((2, f // 8), dtype=torch.int32, device=dev)
        y = cg.chunk_gather_mlp_dma(w16["w_gate"], w16["w_up"], w16["w_down"], xe, empty,
                                    empty, prefetch_depth=depth)
        if float(y.abs().max()) != 0.0:
            failures.append(f"K2 empty lanes are not exact zero (d{depth})")

    # the K1 body's partition of the work (K1 and K3): batch 1, 8 and 9 (two
    # slabs), D = 256 and a ragged D, fewer blocks than a CTA's lane groups,
    # the empty table, one 512-row chunk, K >> real chunks, blocks partly
    # outside [0, N), overlapping chunks whose block list spans several
    # windows, and an x too large to hold whole; bf16, f32 and int8 at every
    # depth
    from repro_torch.kernels.build import library, sm_count

    k3 = importlib.import_module("repro_torch.kernels.chunk_gather_matmul")
    for case in K1_CASES:
        for wname in ("bf16", "f32", "int8"):
            w, xk, s, z, sc = k1_case(case, wname, randn, dev)
            want = cg.chunk_gather_matmul_plain(w, xk, s, z, sc)
            for depth in range(cg.MAX_PREFETCH_DEPTH + 1):
                y = cg.chunk_gather_matmul_dma(w, xk, s, z, sc, prefetch_depth=depth)
                check("chunk_gather_matmul_dma", f"case {case} {wname} d{depth}", y, want)
                g = cg.k1_geometry(w.shape[1], xk.shape[0], w.element_size(),
                                   sm_count(dev) if on_card else 132, depth, w.shape[0])
                if on_card and library("chunk_gather.cu").k1_smem_bytes(
                        cg._WTYPE[w.dtype], g["tile"], g["blocks"], xk.shape[0], 0, w.shape[0],
                        depth, s.shape[0], 1, 0) != cg.k1_smem_bytes(
                            s.shape[0], w.element_size(), g["tile"], g["blocks"], xk.shape[0],
                            depth, w.shape[0]):
                    failures.append(f"k1_smem_bytes: C and Python differ ({case} {wname})")
            if case == "empty" and float(y.abs().max()) != 0.0:
                failures.append(f"K1 empty table is not exact zero ({wname})")
            if wname != "int8":
                check("chunk_gather_matmul", f"case {case} {wname}",
                      k3.chunk_gather_matmul(w, xk, s, z, tile_d=8), want)

    # the same body over two weight streams (K2's phase 1, and K4 at depth
    # 1) on the same shapes, plus int8 ±127 saturation: h bitwise equal to
    # the plain SwiGLU gather, and the C and Python layouts equal
    k4 = importlib.import_module("repro_torch.kernels.chunk_gather_swiglu")
    for case in K1_CASES + ("sat",):
        for wname in ("bf16", "f32", "int8"):
            if case == "sat" and wname != "int8":
                continue
            wg, xk, s, z, sg, wu, su = k2_case(case, wname, randn, dev)
            want = cg.chunk_gather_swiglu_plain(wg, wu, xk, s, z,
                                                None if sg is None else (sg, su))
            for depth in range(cg.MAX_PREFETCH_DEPTH + 1):
                h = gate_up(wg, wu, xk, s, z, sg, su, depth)
                check("chunk_gather_mlp_dma", f"phase 1 case {case} {wname} d{depth}", h, want)
                g = cg.k1_geometry(wg.shape[1], xk.shape[0], wg.element_size(),
                                   sm_count(dev) if on_card else 132, depth, wg.shape[0],
                                   nmat=2)
                if on_card and library("chunk_gather.cu").k1_smem_bytes(
                        cg._WTYPE[wg.dtype], g["tile"], g["blocks"], xk.shape[0], 0,
                        wg.shape[0], depth, s.shape[0], 2, 0) != cg.k1_smem_bytes(
                            s.shape[0], wg.element_size(), g["tile"], g["blocks"],
                            xk.shape[0], depth, wg.shape[0], nmat=2):
                    failures.append(f"k1_smem_bytes (2 streams): C and Python differ "
                                    f"({case} {wname})")
            if case == "empty" and float(h.abs().max()) != 0.0:
                failures.append(f"K2 phase 1: empty table is not exact zero ({wname})")
            if wname != "int8":
                check("chunk_gather_swiglu", f"case {case} {wname}",
                      k4.chunk_gather_swiglu(wg, wu, xk, s, z, tile_f=8), want)

    # the body at the VLM's widths: K1 with an input mask at N = d_model and
    # batch 2 (x and the mask, 3 x N floats, do not fit the x slab: per-block
    # input records, the branch K2's phase 2 takes at N = d_ff), and K2's
    # phase 1 over gate and up at F = d_ff; both with a table as wide as the
    # serve path's (d_ff / 8 entries, every site padded to the widest),
    # which puts gate/up near the shared-memory limit; bf16 and int8, depths
    # 0-3, and the C and Python layouts equal
    vn, vf, vk = vcfg.d_model, vcfg.d_ff, vcfg.d_ff // 8

    def wide_table(n):
        """A (vk,) table over runs of 32 rows kept with probability 0.6."""
        keep = (randn(n // 32) > -0.25).repeat_interleave(32)
        s, z = cg.masks_to_block_tables(keep[None], 8, 512)
        st = torch.zeros(vk, dtype=torch.int32, device=dev)
        sz = torch.zeros_like(st)
        st[: s.shape[1]], sz[: z.shape[1]] = s[0], z[0]
        return st, sz, keep.float()

    for wname in ("bf16", "int8"):
        st, sz, xmask = wide_table(vn)
        w, sc = randn(vn, vn, std=vn ** -0.5), None
        w, sc = (w.to(torch.bfloat16), None) if wname == "bf16" else quantize_rows(w, 8)
        xk = randn(BATCH, vn)
        want = cg.chunk_gather_matmul_plain(w, xk, st, sz, sc, xmask)
        for depth in range(cg.MAX_PREFETCH_DEPTH + 1):
            y = cg._launch_k1(w, xk, st, sz, sc, xmask, 512, depth) if on_card else want
            check("chunk_gather_matmul_dma", f"{vcfg.name} masked N={vn} {wname} d{depth}",
                  y, want)
            g = cg.k1_geometry(vn, BATCH, w.element_size(), sm_count(dev) if on_card else 132,
                               depth, vn, True)
            if on_card and library("chunk_gather.cu").k1_smem_bytes(
                    cg._WTYPE[w.dtype], g["tile"], g["blocks"], BATCH, 1, vn, depth, vk,
                    1, 0) != cg.k1_smem_bytes(vk, w.element_size(), g["tile"], g["blocks"],
                                           BATCH, depth, vn, True):
                failures.append(f"k1_smem_bytes: C and Python differ ({vcfg.name} masked)")
        del w, sc
        st, sz, _ = wide_table(vn)
        wg, wu = randn(vn, vf, std=vn ** -0.5), randn(vn, vf, std=vn ** -0.5)
        if wname == "bf16":
            (wg, sg), (wu, su) = (wg.to(torch.bfloat16), None), (wu.to(torch.bfloat16), None)
        else:
            (wg, sg), (wu, su) = quantize_rows(wg, 8), quantize_rows(wu, 8)
        xk = randn(BATCH, vn)
        want = cg.chunk_gather_swiglu_plain(wg, wu, xk, st, sz,
                                            None if sg is None else (sg, su))
        for depth in range(cg.MAX_PREFETCH_DEPTH + 1):
            check("chunk_gather_mlp_dma", f"{vcfg.name} phase 1 F={vf} {wname} d{depth}",
                  gate_up(wg, wu, xk, st, sz, sg, su, depth), want)
            g = cg.k1_geometry(vf, BATCH, wg.element_size(), sm_count(dev) if on_card else 132,
                               depth, vn, nmat=2)
            need = cg.k1_smem_bytes(vk, wg.element_size(), g["tile"], g["blocks"], BATCH,
                                    depth, vn, nmat=2)
            # with the checksum lanes (phase 9): 4 bytes a block, stream and stage more
            g_ck = cg.k1_geometry(vf, BATCH, wg.element_size(),
                                  sm_count(dev) if on_card else 132, depth, vn, nmat=2, ck=True)
            need_ck = cg.k1_smem_bytes(vk, wg.element_size(), g_ck["tile"], g_ck["blocks"],
                                       BATCH, depth, vn, nmat=2, ck=True)
            if need_ck > cg.SMEM_LIMIT_BYTES:
                failures.append(f"{vcfg.name} gate/up with the lanes needs {need_ck} bytes")
            if on_card and (library("chunk_gather.cu").k1_smem_bytes(
                    cg._WTYPE[wg.dtype], g["tile"], g["blocks"], BATCH, 0, vn, depth, vk,
                    2, 0) != need or library("chunk_gather.cu").k1_smem_bytes(
                    cg._WTYPE[wg.dtype], g_ck["tile"], g_ck["blocks"], BATCH, 0, vn, depth, vk,
                    2, 1) != need_ck):
                failures.append(f"k1_smem_bytes (2 streams): C and Python differ "
                                f"({vcfg.name} gate/up)")
            log(f"[bitwise] {vcfg.name} gate/up {wname} depth {depth}: {g['grid'][0]} CTAs "
                f"of {g['tile']} columns, {g['blocks']} blocks a stage, {need} bytes of "
                f"shared memory ({need_ck} with the checksum lanes; limit "
                f"{cg.SMEM_LIMIT_BYTES})")
        del wg, wu

    # the reduced model on the card against the same model on the CPU
    rcfg = cfg.reduced()
    rmodel = build_model(rcfg)
    rp_cpu = rmodel.init(seed=7, device="cpu")
    rp_gpu = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev))
              for k, v in rp_cpu.items()}
    rbatch = make_dummy_batch(rcfg, InputShape("small", 16, BATCH, "train"), seed=7,
                              device="cpu")
    small = {}
    for name, params, tdev in (("cuda", rp_gpu, dev), ("cpu", rp_cpu, torch.device("cpu"))):
        eng = ServeEngine(rmodel, params, max_seq=32, batch_size=BATCH, backend="kernel",
                          torch_device=tdev)
        last = eng.prefill(rbatch)
        eng.decode(torch.argmax(last, -1)[:, None], 1)
        small[name] = (last.float().cpu(), {k: v["mask"].cpu() for k, v in eng._plan.items()})
    if not torch.allclose(small["cuda"][0], small["cpu"][0], atol=4e-2, rtol=4e-2):
        failures.append("reduced model: prefill logits on the card differ from the CPU's")
    for kind, mask in small["cpu"][1].items():
        if not torch.equal(small["cuda"][1][kind], mask):
            failures.append(f"reduced model: first-refresh {kind} masks differ from the CPU's")

    log(f"[bitwise] {check.n} checks, max abs err "
        + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    if failures:
        for msg in failures:
            log(f"[bitwise] {msg}")
        fail(f"{len(failures)} kernel checks failed")
    del w16, w8
    if on_card:
        torch.cuda.empty_cache()

    # -- 4. the serve run -------------------------------------------------------
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    batch = make_dummy_batch(cfg, InputShape("smoke", PROMPT, BATCH, "train"), seed=0,
                             device=dev)
    counters = (cg.LAUNCHES, chunking.LAUNCHES)
    serve = {}
    for wbits in (16, 8):
        eng = ServeEngine(model, params, max_seq=64, batch_size=BATCH, method="chunk",
                          backend="kernel", wbits=wbits, torch_device=dev)
        last = eng.prefill(batch)
        if not bool(torch.isfinite(last).all()):
            fail(f"w{wbits}: prefill logits are not finite")
        tok0 = torch.argmax(last, dim=-1)[:, None]
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        for c in counters:
            for k in c:
                c[k] = 0
        out = eng.decode(tok0, DECODE)
        launches = {**cg.LAUNCHES, **chunking.LAUNCHES}
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        want = {"chunk_gather_matmul_dma": 4 * n_layers * DECODE,
                "chunk_gather_mlp_dma": n_layers * DECODE,
                "greedy_select": DECODE + TIME_SELECTION_LAUNCHES}
        if on_card and launches != want:
            fail(f"w{wbits}: launch counts {launches} != per-step counts {want}")
        if out.shape != (BATCH, DECODE + 1) or int(out.min()) < 0 \
                or int(out.max()) >= cfg.vocab_size:
            fail(f"w{wbits}: bad tokens {out.tolist()}")
        loop_wall = sum(s.wall_s for s in eng.stats if s.kind == "decode")
        io = eng.io_summary()
        ref = ServeEngine(model, params, max_seq=64, batch_size=BATCH, method="chunk",
                          backend="reference", wbits=wbits, torch_device=dev)
        ref.prefill(batch)
        out_ref = ref.decode(tok0, REF_DECODE)
        if not torch.equal(out_ref, out[:, : REF_DECODE + 1]):
            fail(f"w{wbits}: kernel tokens {out[:, :REF_DECODE + 1].tolist()} != reference "
                 f"backend tokens {out_ref.tolist()}")
        del ref
        profile = profile_decode(eng, out[:, -1:].to(dev), card) if on_card else {}
        serve[wbits] = {"eng": eng, "launches": launches, "loop_wall_s": loop_wall,
                        "profile": profile,
                        "tokens_per_s": BATCH * DECODE / loop_wall, "peak_bytes": peak,
                        "io_bytes": io["io_bytes"], "tokens": out.tolist()}
        log(f"[serve] w{wbits} {cfg.name} L={n_layers} batch {BATCH} prompt {PROMPT} "
            f"decode {DECODE}: {BATCH * DECODE / loop_wall:.2f} tokens/s "
            f"({loop_wall / DECODE * 1e3:.2f} ms/step)  io_bytes {io['io_bytes'] / 1e6:.1f} MB  "
            f"peak {peak / 2**30:.2f} GiB  launches {launches}  "
            f"reference-backend tokens identical ({REF_DECODE} steps)")
        if on_card:
            torch.cuda.empty_cache()

    # -- 5. the timings ---------------------------------------------------------
    cuda_ms, host_ms = timers(on_card)

    timing, lanes = {}, {}
    lane_check = Checks(("chunk_gather_matmul_dma", "chunk_gather_mlp_dma"))
    for wbits in (16, 8):
        timing[wbits], calls = decode_timings(serve[wbits]["eng"], wbits, randn, cuda_ms,
                                              host_ms, card, f"[time] w{wbits}")
        # phase 9's kernel half on these tables: K1/K2 with their checksum lanes
        lanes[wbits] = lane_timings(calls, wbits, lane_check, cuda_ms, host_ms, card,
                                    f"[lane] {cfg.name} w{wbits}")
        del calls
        wall = serve[wbits]["loop_wall_s"] * 1e3
        shares = {k: v["ms"] * (serve[wbits]["launches"][k]
                                - (TIME_SELECTION_LAUNCHES if k == "greedy_select" else 0)) / wall
                  for k, v in timing[wbits].items()}
        serve[wbits]["kernel_share"] = shares
        for k, v in timing[wbits].items():
            lib = "n/a" if v["library_ms"] is None else f"{v['library_ms'] * 1e3:.1f} us"
            log(f"[time] w{wbits} {k}: {v['ms'] * 1e3:.1f} us/launch  plain "
                f"{v['plain_ms'] * 1e3:.1f} us  library {lib}  bound {v['bound_ms'] * 1e3:.2f} us "
                f"({v['bound_by']})  share of decode wall {shares[k]:.1%}  ({card})")

    if lane_check.failures:
        for msg in lane_check.failures:
            log(f"[lane] {msg}")
        fail(f"{len(lane_check.failures)} checksum-lane checks failed")
    report["lanes"] = {"tinyllama": {"timing": lanes, "errs": lane_check.errs,
                                     "n_checks": lane_check.n}}
    log(f"[lane] {cfg.name}: {lane_check.n} checks (lane vs none vs plain, depths "
        f"{LANE_DEPTHS}, wbits 16 and 8), max abs err "
        + ", ".join(f"{k} {v:.1e}" for k, v in lane_check.errs.items()))

    # -- 6. the per-matrix library path ------------------------------------------
    lib_timing, lib_launches, lib_report = library_path(
        dev, cfg, params["layers"], randn, check, failures, cuda_ms, host_ms, card)
    errs["greedy_select"] = max(errs["greedy_select"], lib_report.pop("k5_err"))

    # -- the result ---------------------------------------------------------------
    meta = {
        "chunk_gather_matmul_dma": ("src/repro_torch/kernels/csrc/chunk_gather.cu",
                                    "src/repro/kernels/chunk_gather_dma.py:284"),
        "chunk_gather_mlp_dma": ("src/repro_torch/kernels/csrc/chunk_gather.cu",
                                 "src/repro/kernels/chunk_gather_dma.py:617"),
        "greedy_select": ("src/repro_torch/kernels/csrc/greedy_select.cu",
                          "src/repro/core/chunking.py:362"),
        "chunk_gather_matmul": ("src/repro_torch/kernels/csrc/chunk_gather.cu",
                                "src/repro/kernels/chunk_gather_matmul.py:69"),
        "chunk_gather_swiglu": ("src/repro_torch/kernels/csrc/chunk_gather.cu",
                                "src/repro/kernels/chunk_gather_swiglu.py:63"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        t = timing[16][name] if name in timing[16] else lib_timing[name]
        launches = (serve[16]["launches"] if name in timing[16] else lib_launches)[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    report.update({"library_path": {**lib_report, "timing": lib_timing,
                                    "launches": lib_launches}})
    report.update({"timing": timing, "errs": errs, "n_checks": check.n,
                   "k5_walked_per_lane_full": walked_full,
                   "serve": {w: {k: v for k, v in s.items() if k != "eng"}
                             for w, s in serve.items()}})
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_report.json").write_text(json.dumps(report, indent=1, default=str))
    return kernels


def library_path(dev, cfg, layers, randn, check, failures, cuda_ms, host_ms, card):
    """Phase 6: the per-matrix library path (``NeuronChunkingPlanner`` →
    ``plan_to_kernel_table`` → K3 / K4) over every offloaded matrix of
    ``cfg``'s layers, then the quickstart entry point, with the launch counts
    set to 0 just before and read just after. Then, outside the counted run:
    K3 and K4 against their plain versions and against K1 / K2 on the same
    tables, the tables against ``masks_to_block_tables``, the one-lane K5
    masks against the plain walk, and the timings. Returns (timing per
    kernel, launches, report)."""
    import torch

    from repro_torch.core import NeuronChunkingPlanner, chunk_stats_np, chunking
    from repro_torch.core.importance import importance
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import chunk_table_to_mask
    from repro_torch.launch import quickstart

    k3 = importlib.import_module("repro_torch.kernels.chunk_gather_matmul")
    k4 = importlib.import_module("repro_torch.kernels.chunk_gather_swiglu")
    on_card = dev.type == "cuda"
    n_layers, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    hd_all = cfg.n_heads * cfg.resolved_head_dim
    kv_all = cfg.n_kv_heads * cfg.resolved_head_dim
    # one planner per matrix shape (N, n_cols); gate and up share the input
    # and so one plan and one K4 table
    shapes = {"wq": (d, hd_all), "wk": (d, kv_all), "wv": (d, kv_all), "wo": (hd_all, d),
              "gate_up": (d, f), "w_down": (f, d)}
    planners = {k: NeuronChunkingPlanner.build(n, c, device="nano") for k, (n, c) in shapes.items()}

    def heavy(n):
        """The quickstart's activations: |N(0, 1)| rows times a log-normal
        per-neuron scale, LIB_ROWS rows for planning."""
        return randn(LIB_ROWS, n).abs() * torch.exp(randn(n))

    def plan(kind, acts, x):
        """Our plan and top-k's for one matrix, and our plan's kernel table
        (host numpy from the mask, then on the device)."""
        ours = planners[kind].plan(acts, LIB_SPARSITY)
        s, z = ops.plan_to_kernel_table(ours.mask)
        return {"acts": acts, "plan": ours, "topk": planners[kind].plan_topk(acts, LIB_SPARSITY),
                "table": (torch.from_numpy(s).to(dev), torch.from_numpy(z).to(dev)), "x": x}

    counters = (cg.LAUNCHES, chunking.LAUNCHES, k3.LAUNCHES, k4.LAUNCHES)
    for c in counters:
        for k in c:
            c[k] = 0
    t0 = time.perf_counter()
    calls = []  # per layer: {kind: {acts, plan, topk, table, x, out}}
    for layer in range(n_layers):
        a_attn, a_o, a_mlp = heavy(d), heavy(hd_all), heavy(d)
        rec = {kind: plan(kind, acts, acts[:BATCH])
               for kind, acts in (("wq", a_attn), ("wk", a_attn), ("wv", a_attn), ("wo", a_o),
                                  ("gate_up", a_mlp))}
        for kind in ("wq", "wk", "wv", "wo"):
            r = rec[kind]
            r["out"] = ops.sparse_matmul(layers[kind][layer], r["x"], *r["table"],
                                         tile_d=LIB_TILE)
        r = rec["gate_up"]
        h = r["out"] = ops.sparse_swiglu(layers["w_gate"][layer], layers["w_up"][layer], r["x"],
                                         *r["table"], tile_f=LIB_TILE)
        r = rec["w_down"] = plan("w_down", h, h)  # down is planned from importance(h)
        r["out"] = ops.sparse_matmul(layers["w_down"][layer], h, *r["table"], tile_d=LIB_TILE)
        calls.append(rec)
    log("[library] the quickstart entry point:")
    qs = quickstart.main(["--torch-device", dev.type])
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**cg.LAUNCHES, **chunking.LAUNCHES, **k3.LAUNCHES, **k4.LAUNCHES}
    want = {"chunk_gather_matmul_dma": 0, "chunk_gather_mlp_dma": 0,
            "greedy_select": 6 * n_layers + 1, "chunk_gather_matmul": 5 * n_layers + 1,
            "chunk_gather_swiglu": n_layers}
    if on_card and launches != want:
        fail(f"library path: launch counts {launches} != {want}")

    # -- checks, outside the counted run --------------------------------------
    k5_err = 0.0
    one_lane = []  # the planner's one-lane K5 inputs, for its timing
    for layer, rec in enumerate(calls):
        for kind, r in rec.items():
            what = f"L{layer} {kind}"
            ours, (s, z), x, out = r["plan"], r["table"], r["x"], r["out"]
            bs, bz = cg.masks_to_block_tables(ours.mask[None], 8, 512)
            keep = bz[0] > 0
            if not (torch.equal(s, bs[0][keep]) and torch.equal(z, bz[0][keep])):
                failures.append(f"library path {what}: plan_to_kernel_table != the non-empty "
                                "entries of masks_to_block_tables")
            batched, _ = planners[kind].selector.lane(dev)
            st_s, sz_s = batched.sorted_candidates(importance(r["acts"])[None])
            budget = torch.tensor([round((1.0 - LIB_SPARSITY) * shapes[kind][0])],
                                  dtype=torch.int32, device=dev)
            m_p, sel_p = chunking.greedy_select_plain(st_s, sz_s, budget, batched.min_sizes,
                                                      batched.n_max)
            one_lane.append((st_s, sz_s, budget, batched.min_sizes, batched.n_max))
            if not (torch.equal(m_p[0] & batched.row_valid[0], ours.mask)
                    and int(sel_p[0]) == int(ours.n_selected)):
                failures.append(f"greedy_select {what}: the one-lane walk differs from the "
                                "plain walk")
                k5_err = max(k5_err, float((m_p[0].int() - ours.mask.int()).abs().max()))
            if kind == "gate_up":
                wg, wu = layers["w_gate"][layer], layers["w_up"][layer]
                check("chunk_gather_swiglu", f"{what} vs plain", out,
                      cg.chunk_gather_swiglu_plain(wg, wu, x, s, z))
                ds, dz = rec["w_down"]["table"]
                k = max(s.shape[0], ds.shape[0])
                st = torch.zeros((2, k), dtype=torch.int32, device=dev)
                sz = torch.zeros_like(st)
                st[0, : s.shape[0]], sz[0, : z.shape[0]] = s, z
                st[1, : ds.shape[0]], sz[1, : dz.shape[0]] = ds, dz
                wd = layers["w_down"][layer]
                y2, h2 = cg.chunk_gather_mlp_dma(wg, wu, wd, x, st, sz, prefetch_depth=1,
                                                 return_h=True)
                check("chunk_gather_swiglu", f"{what} vs K2's h", out, h2)
                y_site = rec["w_down"]["out"]
                check("chunk_gather_matmul", f"L{layer} per-site MLP y vs K2", y_site, y2)
                y_plain, _ = cg.chunk_gather_mlp_plain(wg, wu, wd, x, st, sz, ffn_mask=None)
                check("chunk_gather_matmul", f"L{layer} per-site MLP y vs plain", y_site,
                      y_plain)
            else:
                w = layers[kind][layer]
                check("chunk_gather_matmul", f"{what} vs plain", out,
                      cg.chunk_gather_matmul_plain(w, x, s, z))
                check("chunk_gather_matmul", f"{what} vs K1 depth 1", out,
                      cg.chunk_gather_matmul_dma(w, x, s, z, prefetch_depth=1))
    check("chunk_gather_matmul", "quickstart vs plain", qs["y"],
          cg.chunk_gather_matmul_plain(qs["w"], qs["x"], qs["starts"], qs["sizes"]))
    check("chunk_gather_matmul", "quickstart vs K1 depth 1", qs["y"],
          cg.chunk_gather_matmul_dma(qs["w"], qs["x"], qs["starts"], qs["sizes"],
                                     prefetch_depth=1))
    if qs["max_err"] / max(1.0, float(qs["y"].abs().max())) >= 1e-5:
        failures.append(f"quickstart: kernel vs oracle max err {qs['max_err']:.2e}")
    for rec in calls:
        for kind, r in rec.items():
            if not bool(torch.isfinite(r["out"]).all()):
                failures.append(f"library path {kind}: non-finite output")
    if failures:
        for msg in failures:
            log(f"[library] {msg}")
        fail(f"{len(failures)} library-path checks failed")

    def mean(xs):
        xs = [float(v) for v in xs]
        return sum(xs) / len(xs)

    stats = {}
    for kind, (n, c) in shapes.items():
        ours = [rec[kind]["plan"] for rec in calls]
        topk = [rec[kind]["topk"] for rec in calls]
        stats[kind] = {
            "shape": [n, c], "selected": mean(p.n_selected for p in ours),
            "retention": mean(p.importance_retention for p in ours),
            "retention_topk": mean(p.importance_retention for p in topk),
            "est_io_ms": mean(p.est_latency_s for p in ours) * 1e3,
            "est_io_ms_topk": mean(p.est_latency_s for p in topk) * 1e3,
            "avg_chunk": mean(chunk_stats_np(p.mask.cpu().numpy())[0] for p in ours),
            "avg_chunk_topk": mean(chunk_stats_np(p.mask.cpu().numpy())[0] for p in topk)}
        v = stats[kind]
        log(f"[library] {kind} ({n}x{c}), mean of {n_layers} layers: selected "
            f"{v['selected']:.1f}/{n} rows, retention ours {v['retention']:.3f} vs top-k "
            f"{v['retention_topk']:.3f}, est. I/O ours {v['est_io_ms']:.3f} ms vs top-k "
            f"{v['est_io_ms_topk']:.3f} ms ({v['est_io_ms_topk'] / v['est_io_ms']:.1f}x), "
            f"avg chunk {v['avg_chunk']:.1f} rows (top-k {v['avg_chunk_topk']:.1f})")
    log(f"[library] {n_layers} layers planned and run in {wall:.2f} s (host clock, "
        f"quickstart included); launches {launches}")

    # -- timings: CUDA-graph replay over the layers' tables -----------------------
    k3_calls, k4_calls, k3_sites, k3_bounds = [], [], [], []
    k3_bytes = k3_ops = k4_bytes = k4_ops = k3_bound = k4_bound = 0.0
    for layer, rec in enumerate(calls):
        for kind in ("wq", "wk", "wv", "wo", "w_down"):
            w = layers[kind][layer]
            (s, z), x = rec[kind]["table"], rec[kind]["x"]
            xm = x * chunk_table_to_mask(s, z, w.shape[0]).to(x.dtype)
            k3_calls.append((w, x, s, z, xm.to(w.dtype)))
            rows = rows_of(z)
            byts = (rows * w.shape[1] * w.element_size() + x.numel() * 4 + 8 * s.numel()
                    + x.shape[0] * w.shape[1] * 4)
            ops_ = 2.0 * x.shape[0] * rows * w.shape[1]
            k3_bytes, k3_ops = k3_bytes + byts, k3_ops + ops_
            k3_bound += max(byts / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S)
            k3_sites.append(kind)
            k3_bounds.append(max(byts / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S))
        wg, wu = layers["w_gate"][layer], layers["w_up"][layer]
        (s, z), x = rec["gate_up"]["table"], rec["gate_up"]["x"]
        k4_calls.append((wg, wu, x, s, z))
        rows = rows_of(z)
        byts = (2 * rows * f * wg.element_size() + x.numel() * 4 + 8 * s.numel()
                + x.shape[0] * f * 4)
        ops_ = 2.0 * x.shape[0] * 2 * rows * f
        k4_bytes, k4_ops = k4_bytes + byts, k4_ops + ops_
        k4_bound += max(byts / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S)
    n3, n4 = len(k3_calls), len(k4_calls)

    def run_k3(plain=False, calls=k3_calls):
        for w, x, s, z, _ in calls:
            if plain:
                cg.chunk_gather_matmul_plain(w, x, s, z)
            else:
                ops.sparse_matmul(w, x, s, z, tile_d=LIB_TILE)

    def run_k3_lib(calls=k3_calls):
        for w, _, _, _, xm in calls:
            xm @ w

    def run_k4(plain=False):
        for wg, wu, x, s, z in k4_calls:
            if plain:
                cg.chunk_gather_swiglu_plain(wg, wu, x, s, z)
            else:
                ops.sparse_swiglu(wg, wu, x, s, z, tile_f=LIB_TILE)

    timing = {
        "chunk_gather_matmul": {
            "ms": cuda_ms(run_k3, 20) / n3, "plain_ms": host_ms(lambda: run_k3(True)) / n3,
            "library_ms": cuda_ms(run_k3_lib, 20) / n3, "bound_ms": k3_bound / n3 * 1e3,
            "bound_by": "bytes" if k3_bytes / HBM_BYTES_PER_S >= k3_ops / F32_OPS_PER_S
            else "operations", "calls": n3, "bytes_per_call": k3_bytes / n3},
        "chunk_gather_swiglu": {
            "ms": cuda_ms(run_k4, 20) / n4, "plain_ms": host_ms(lambda: run_k4(True)) / n4,
            "library_ms": None, "bound_ms": k4_bound / n4 * 1e3,
            "bound_by": "bytes" if k4_bytes / HBM_BYTES_PER_S >= k4_ops / F32_OPS_PER_S
            else "operations", "calls": n4, "bytes_per_call": k4_bytes / n4},
    }
    sites = per_site(k3_calls, k3_sites, k3_bounds, run_k3, run_k3_lib, cuda_ms)
    timing["chunk_gather_matmul"]["per_site"] = sites

    def run_k5_one_lane():
        for args in one_lane:
            chunking.greedy_select(*args)

    one_lane_ms = cuda_ms(run_k5_one_lane, 5) / len(one_lane)
    log(f"[time] greedy_select one lane (the planner's walks, mean of {len(one_lane)}): "
        f"{one_lane_ms * 1e3:.1f} us/launch  ({card})")
    log(f"[time] chunk_gather_matmul per site: {site_line(sites)}  ({card})")
    for k, v in timing.items():
        lib = "n/a" if v["library_ms"] is None else f"{v['library_ms'] * 1e3:.1f} us"
        log(f"[time] {k}: {v['ms'] * 1e3:.1f} us/launch  plain {v['plain_ms'] * 1e3:.1f} us  "
            f"library {lib}  bound {v['bound_ms'] * 1e3:.2f} us ({v['bound_by']})  "
            f"over {v['calls']} calls  ({card})")
    return timing, launches, {"stats": stats, "wall_s": wall, "k5_err": k5_err,
                              "k5_one_lane_ms": one_lane_ms,
                              "quickstart_max_err": qs["max_err"]}


def vlm_path(dev, full_cfg, card, report):
    """Phase 7: the paper's VLM workload at the full width of ``full_cfg``,
    depth cut to VLM_LAYERS: prefill (vision + text tokens) → VLM_FRAMES
    frame appends → VLM_DECODE decode tokens through ``ServeEngine``,
    ``--method chunk --sparsity 0.4 --device nano --backend kernel``, at
    wbits 16 and 8. The launch counts are set to 0 just before and read
    just after each run, and must be exact; the tokens must equal the same
    run's on the reference backend. Then, outside the counted runs: K1 (every
    site), K2 and K5 (the all-layer refresh and each site's one-lane walk)
    bitwise against their plain versions on the run's own tables; the
    timings as in phase 5 plus K5's one-lane walks; the rows the kernels read
    against the rows selected; the profiled device busy share; and the
    video-stream policy table at wbits 16. Returns the phase's kernel rows."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.launch import video_stream
    from repro_torch.models import build_model
    from repro_torch.models.inputs import FRONT_DTYPE, make_dummy_batch
    from repro_torch.serving import ServeEngine

    on_card = dev.type == "cuda"
    cfg = dataclasses.replace(full_cfg, n_layers=min(VLM_LAYERS, full_cfg.n_layers))
    n_layers, hd = cfg.n_layers, cfg.resolved_head_dim
    frame_tokens = max(cfg.frontend_tokens // 4, 4)
    log(f"[vlm] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, d_frontend {cfg.d_frontend} (the "
        f"model's widths); depth cut to {n_layers} of {full_cfg.n_layers} layers; random "
        f"weights from seed 0; batch {BATCH}, prompt {VLM_PROMPT} tokens, {VLM_FRAMES} frames "
        f"of {frame_tokens} tokens, {VLM_DECODE} decode tokens, max_seq {VLM_MAX_SEQ}")
    randn, sync = seeded(dev, 4321)
    cuda_ms, host_ms = timers(on_card)
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    prompt = make_dummy_batch(cfg, InputShape("vlm", VLM_PROMPT, BATCH, "train"), seed=0,
                              device=dev)
    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(rng.normal(0, 1, (BATCH, frame_tokens, cfg.d_frontend)))
              .to(FRONT_DTYPE).to(dev) for _ in range(VLM_FRAMES)]
    sync()
    log(f"[vlm] weights made in {time.perf_counter() - t0:.1f} s: "
        f"{sum(t.numel() * t.element_size() for t in params['layers'].values()) / 2**30:.2f} "
        f"GiB of layers, prompt {tuple(prompt['tokens'].shape)} text + "
        f"{tuple(prompt['frontend'].shape)} vision")
    counters = (cg.LAUNCHES, chunking.LAUNCHES)
    check = Checks(("chunk_gather_matmul_dma", "chunk_gather_mlp_dma", "greedy_select"))
    errs = check.errs

    def serve(backend, wbits):
        """One run of the path: prefill → frames → decode. Returns (engine,
        tokens (b, VLM_DECODE + 1), prefill logits, frame hidden states)."""
        eng = ServeEngine(model, params, max_seq=VLM_MAX_SEQ, batch_size=BATCH,
                          device="nano", sparsity=0.4, method="chunk", backend=backend,
                          wbits=wbits, torch_device=dev)
        last = eng.prefill(prompt)
        hidden = [eng.append_frame(fr) for fr in frames]
        out = eng.decode(torch.argmax(last, dim=-1)[:, None], VLM_DECODE)
        return eng, out, last, hidden

    runs, timing, lanes = {}, {}, {}
    lane_check = Checks(("chunk_gather_matmul_dma", "chunk_gather_mlp_dma"))
    for wbits in (16, 8):
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        for c in counters:
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        eng, out, last, hidden = serve("kernel", wbits)
        sync()
        wall = time.perf_counter() - t0
        launches = {**cg.LAUNCHES, **chunking.LAUNCHES}
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        want = {"chunk_gather_matmul_dma": 4 * n_layers * VLM_DECODE,
                "chunk_gather_mlp_dma": n_layers * VLM_DECODE,
                "greedy_select": VLM_DECODE + TIME_SELECTION_LAUNCHES
                + 4 * n_layers * VLM_FRAMES}
        if on_card and launches != want:
            fail(f"vlm w{wbits}: launch counts {launches} != per-step counts {want}")
        if not (bool(torch.isfinite(last).all())
                and all(bool(torch.isfinite(h).all()) for h in hidden)):
            fail(f"vlm w{wbits}: non-finite prefill logits or frame hidden states")
        if out.shape != (BATCH, VLM_DECODE + 1) or int(out.min()) < 0 \
                or int(out.max()) >= cfg.vocab_size:
            fail(f"vlm w{wbits}: bad tokens {out.tolist()}")
        if eng.cache["length"] != VLM_PROMPT + VLM_FRAMES * frame_tokens + VLM_DECODE:
            fail(f"vlm w{wbits}: cache length {eng.cache['length']}")
        st = {k: [s for s in eng.stats if s.kind == k] for k in ("prefill", "frame", "decode")}
        if len(st["frame"]) != VLM_FRAMES or not all(s.io_est_s > 0 for s in st["frame"]):
            fail(f"vlm w{wbits}: frame stats {st['frame']}")
        ref, out_ref, _, _ = serve("reference", wbits)
        if not torch.equal(out_ref, out):
            fail(f"vlm w{wbits}: kernel tokens {out.tolist()} != reference backend tokens "
                 f"{out_ref.tolist()}")
        del ref
        if on_card:
            torch.cuda.empty_cache()
        decode_wall = sum(s.wall_s for s in st["decode"])
        profile = profile_decode(eng, out[:, -1:].to(dev), card) if on_card else {}
        io = eng.io_summary()
        runs[wbits] = {
            "launches": launches, "wall_s": wall, "peak_bytes": peak,
            "prefill_wall_s": st["prefill"][0].wall_s,
            "frame_wall_s": [s.wall_s for s in st["frame"]],
            "frame_io_est_s": [s.io_est_s for s in st["frame"]],
            "frame_io_sim_s": [s.io_sim_s for s in st["frame"]],
            "decode_wall_per_step_s": decode_wall / VLM_DECODE,
            "tokens_per_s": BATCH * VLM_DECODE / decode_wall, "profile": profile,
            "io_bytes": io["io_bytes"], "io_sim_s": io["io_sim_s"], "tokens": out.tolist()}
        log(f"[vlm] w{wbits} served: prefill {st['prefill'][0].wall_s * 1e3:.1f} ms, frames "
            + ", ".join(f"{s.wall_s * 1e3:.1f}" for s in st["frame"])
            + f" ms (io_est {np.mean(runs[wbits]['frame_io_est_s']) * 1e3:.2f} ms a frame), "
            f"decode {decode_wall / VLM_DECODE * 1e3:.2f} ms/step "
            f"({runs[wbits]['tokens_per_s']:.2f} tokens/s), peak {peak / 2**30:.2f} GiB, "
            f"launches {launches}, tokens identical to the reference backend  ({card})")

        # -- the timings, and the kernels on the run's own tables (every
        # layer's, as timed) against their plain versions
        timing[wbits], calls = decode_timings(eng, wbits, randn, cuda_ms, host_ms, card,
                                              f"[vlm] w{wbits}")
        # phase 9's kernel half on these tables: K1/K2 with their checksum lanes
        lanes[wbits] = lane_timings(calls, wbits, lane_check, cuda_ms, host_ms, card,
                                    f"[lane] {cfg.name} w{wbits}")
        plan, sp = eng._plan, eng.sparse_ctx
        for i, (name, (w, xm, s, z, sc)) in enumerate(zip(calls["k1_sites"], calls["k1"])):
            check("chunk_gather_matmul_dma", f"vlm w{wbits} L{i // 4} {name}",
                  cg.chunk_gather_matmul_dma(w, xm, s, z, sc),
                  cg.chunk_gather_matmul_plain(w, xm, s, z, sc))
        for layer, (wg, wu, wd, xm, s, z, fm, scs) in enumerate(calls["k2"]):
            yk, hk = cg.chunk_gather_mlp_dma(wg, wu, wd, xm, s, z, fm, scs, return_h=True)
            yp, hp = cg.chunk_gather_mlp_plain(wg, wu, wd, xm, s, z, fm, scs)
            check("chunk_gather_mlp_dma", f"vlm w{wbits} L{layer} y", yk, yp)
            check("chunk_gather_mlp_dma", f"vlm w{wbits} L{layer} h", hk, hp)
        for args in calls["k5"]:
            for got, want_ in zip(chunking.greedy_select(*args),
                                  chunking.greedy_select_plain(*args)):
                check("greedy_select", f"vlm w{wbits} {args[0].shape[0]} lanes", got, want_)
        one_lane = {}
        for kind in sp.site_order:
            site = sp.sites[kind]
            batched, _ = site.selector.lane(dev)
            st_s, sz_s = batched.sorted_candidates(plan[kind]["pending"][0][None])
            args = (st_s, sz_s, torch.tensor([site.budget()], dtype=torch.int32, device=dev),
                    batched.min_sizes, batched.n_max)
            walked = []
            for got, want_ in zip(chunking.greedy_select(*args),
                                  chunking.greedy_select_plain(*args, walked)):
                check("greedy_select", f"vlm w{wbits} one lane {kind}", got, want_)
            one_lane[kind] = (args, walked[0])
        if check.failures or lane_check.failures:
            for msg in check.failures + lane_check.failures:
                log(f"[vlm] {msg}")
            fail(f"{len(check.failures) + len(lane_check.failures)} phase-7 kernel or "
                 "checksum-lane checks failed")
        log(f"[vlm] w{wbits} bitwise: {check.n} checks so far (K1 at every site of "
            f"{n_layers} layers, K2 at every layer, K5 over {n_layers * sp.batched.n_sites} "
            "lanes and one lane a site), max abs err "
            + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))

        lane_ms = {}
        for kind, (args, walked) in one_lane.items():
            ms = cuda_ms(lambda a=args: chunking.greedy_select(*a), 5)
            lane_ms[kind] = {"ms": ms, "walked": walked, "candidates": int(args[0].shape[1]),
                             "bound_ms": (walked * 8 + args[4] + 12) / HBM_BYTES_PER_S * 1e3}
        timing[wbits]["greedy_select"]["one_lane"] = lane_ms
        log(f"[vlm] w{wbits} greedy_select one lane: " + "  ".join(
            f"{k} {v['ms'] * 1e3:.1f} us ({v['walked']} of {v['candidates']} candidates "
            f"walked)" for k, v in lane_ms.items()) + f"  ({card})")
        for k, v in timing[wbits].items():
            lib = "n/a" if v["library_ms"] is None else f"{v['library_ms'] * 1e3:.1f} us"
            log(f"[vlm] w{wbits} {k}: {v['ms'] * 1e3:.1f} us/launch  plain "
                f"{v['plain_ms'] * 1e3:.1f} us  library {lib}  bound "
                f"{v['bound_ms'] * 1e3:.2f} us ({v['bound_by']})  ({card})")

        # -- the rows the kernels read (whole 8-row blocks) against the rows
        # the last refresh selected, per site over the layers
        grain = {}
        for kind in sp.site_order:
            sel = int(plan[kind]["mask"].sum())
            read = sum(rows_of(plan[kind]["ksizes"][layer]) for layer in range(n_layers))
            grain[kind] = {"selected": sel, "read": read, "ratio": read / max(sel, 1),
                           "rows": sp.sites[kind].n * n_layers,
                           "max_chunk_rows": sp.sites[kind].selector.max_size}
        runs[wbits]["grain"] = grain
        log(f"[vlm] w{wbits} rows read / selected, {n_layers} layers: " + "  ".join(
            f"{k} {v['read']}/{v['selected']} = {v['ratio']:.2f}x (chunks up to "
            f"{v['max_chunk_rows']} rows)" for k, v in grain.items()))
        del eng
        if on_card:
            torch.cuda.empty_cache()

    # -- the video-stream policy table at wbits 16 (dense / top-k / chunk)
    policies = video_stream.policy_io(model, params, prompt, frames, VLM_DECODE, 0.4, 1, dev,
                                      backend="kernel")
    log(f"[vlm] the video-stream table, {cfg.name} at {n_layers} layers, wbits 16, simulated "
        "Jetson Orin Nano flash:")
    video_stream.print_policy_table(policies)
    report["vlm"] = {"config": dataclasses.asdict(cfg), "runs": runs, "timing": timing,
                     "errs": errs, "n_checks": check.n, "policies": policies}
    report.setdefault("lanes", {})["internvl2"] = {"timing": lanes, "errs": lane_check.errs,
                                                  "n_checks": lane_check.n}
    log(f"[lane] {cfg.name}: {lane_check.n} checks, max abs err "
        + ", ".join(f"{k} {v:.1e}" for k, v in lane_check.errs.items()))
    meta = {
        "chunk_gather_matmul_dma": ("src/repro_torch/kernels/csrc/chunk_gather.cu",
                                    "src/repro/kernels/chunk_gather_dma.py:284"),
        "chunk_gather_mlp_dma": ("src/repro_torch/kernels/csrc/chunk_gather.cu",
                                 "src/repro/kernels/chunk_gather_dma.py:617"),
        "greedy_select": ("src/repro_torch/kernels/csrc/greedy_select.cu",
                          "src/repro/core/chunking.py:362"),
    }
    return [{"name": f"{name} [{cfg.name}, {n_layers} layers]", "route": "cuda",
             "source": source, "replaces": replaces, "launches": runs[16]["launches"][name],
             "max_abs_err": errs[name], "ms": timing[16][name]["ms"],
             "plain_ms": timing[16][name]["plain_ms"], "bound_ms": timing[16][name]["bound_ms"],
             "bound_by": timing[16][name]["bound_by"],
             "library_ms": timing[16][name]["library_ms"]}
            for name, (source, replaces) in meta.items()]


def cache_path(dev, cfg, card, report):
    """Phase 8, TinyLlama: the residency cache (paper §5) on ``cfg``'s
    full depth at CACHE_FRACS of ``sparsifiable_bytes``, wbits 16 and 8,
    prompt PROMPT, DECODE decode tokens: on the kernel backend with the
    launch counts set to 0 just before and read just after (exact), against
    the reference backend (tokens, hit and miss rows, io_est equal), every
    (layer, site) within its cap; then ``decode_per_token`` against
    ``decode`` at the middle budget and refresh interval 2, the repriced
    timeline at depths 0-4, depth 7 against depth 1, and K1 (every site of
    every layer), K2 (every layer) and K5 (the resident-aware refresh
    input) bitwise against their plain versions on the middle budget's own
    tables, which are timed. Returns the phase's kernel rows."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.models import build_model
    from repro_torch.models.inputs import make_dummy_batch
    from repro_torch.serving import ServeEngine, SparseExecution

    on_card = dev.type == "cuda"
    n_layers = cfg.n_layers
    randn, sync = seeded(dev, 8888)
    cuda_ms, host_ms = timers(on_card)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    batch = make_dummy_batch(cfg, InputShape("cache", PROMPT, BATCH, "train"), seed=0,
                             device=dev)
    counters = (cg.LAUNCHES, chunking.LAUNCHES)
    check = Checks(("chunk_gather_matmul_dma", "chunk_gather_mlp_dma", "greedy_select"))
    hit_steps = {}  # id(engine) -> its refresh steps' (L, S) hit rows

    def serve(backend, wbits, cache_mb, per_token=False, refresh=1, depth=1):
        eng = ServeEngine(model, params, max_seq=64, batch_size=BATCH, method="chunk",
                          backend=backend, wbits=wbits, cache_mb=cache_mb,
                          plan_refresh_interval=refresh, prefetch_depth=depth,
                          torch_device=dev)
        hit_steps[id(eng)] = record_hits(eng.sparse_ctx)
        tok0 = torch.argmax(eng.prefill(batch), dim=-1)[:, None]
        sync()
        out = (eng.decode_per_token if per_token else eng.decode)(tok0, DECODE)
        sync()
        return eng, out

    def record_hits(sp):
        """Keep, on the device, each refresh step's hit rows per (layer,
        site): the growth of the plan's per-site ``hit`` over the step, the
        number the refresh itself charged."""
        inner, steps = sp.refresh_step, []

        def refresh_step(plan, refresh):
            before = torch.stack([plan[k]["hit"].clone() for k in sp.site_order], dim=1)
            io = inner(plan, refresh)
            steps.append(torch.stack([plan[k]["hit"] for k in sp.site_order], dim=1) - before)
            return io

        sp.refresh_step = refresh_step
        return steps

    def within_caps(eng):
        """Every refresh step charged each (layer, site) at most its cap of
        hit rows, and the steps' hits add up to the run's."""
        sp, steps = eng.sparse_ctx, hit_steps.pop(id(eng))
        if not sp.cache_enabled:
            return True
        hits = torch.stack(steps)  # (refresh steps, L, S)
        caps = torch.tensor([sp.cache_caps[k] for k in sp.site_order], dtype=torch.float32,
                            device=hits.device)
        return len(steps) == DECODE and bool(((hits >= 0) & (hits <= caps)).all()) \
            and float(hits.sum()) == eng.io_summary()["hit_rows"]

    runs = {}
    mid = {}
    for wbits in (16, 8):
        total = SparseExecution(cfg, wbits=wbits, torch_device=dev).sparsifiable_bytes(n_layers)
        budgets = [frac * total / 2**20 for frac in CACHE_FRACS]
        for frac, mb in zip(CACHE_FRACS, budgets):
            for c in counters:
                for k in c:
                    c[k] = 0
            eng, out = serve("kernel", wbits, mb)
            launches = {**cg.LAUNCHES, **chunking.LAUNCHES}
            want = {"chunk_gather_matmul_dma": 4 * n_layers * DECODE,
                    "chunk_gather_mlp_dma": n_layers * DECODE,
                    "greedy_select": DECODE + TIME_SELECTION_LAUNCHES}
            if on_card and launches != want:
                fail(f"cache w{wbits} {frac:.0%}: launch counts {launches} != {want}")
            if out.shape != (BATCH, DECODE + 1) or int(out.min()) < 0 \
                    or int(out.max()) >= cfg.vocab_size:
                fail(f"cache w{wbits} {frac:.0%}: bad tokens {out.tolist()}")
            ref, out_ref = serve("reference", wbits, mb)
            io, io_ref = eng.io_summary(), ref.io_summary()
            if not torch.equal(out, out_ref):
                fail(f"cache w{wbits} {frac:.0%}: kernel tokens {out.tolist()} != reference "
                     f"backend tokens {out_ref.tolist()}")
            for key in ("hit_rows", "miss_rows", "io_est_s", "io_bytes"):
                if io[key] != io_ref[key]:
                    fail(f"cache w{wbits} {frac:.0%}: {key} {io[key]} != reference backend "
                         f"{io_ref[key]}")
            if not (within_caps(eng) and within_caps(ref)):
                fail(f"cache w{wbits} {frac:.0%}: a refresh step charged a (layer, site) "
                     "more hit rows than its cap")
            del ref
            dec = [st for st in eng.stats if st.kind == "decode"]
            wall = sum(st.wall_s for st in dec) / DECODE
            runs[(wbits, frac)] = {"cache_mb": mb, "launches": launches,
                                   "io_sim_s": io["io_sim_s"], "io_est_s": io["io_est_s"],
                                   "io_bytes": io["io_bytes"], "hit_rows": io["hit_rows"],
                                   "miss_rows": io["miss_rows"],
                                   "cache_hit_rate": io["cache_hit_rate"],
                                   "decode_io_sim_s": sum(st.io_sim_s for st in dec),
                                   "wall_per_step_s": wall, "tokens": out.tolist()}
            log(f"[cache] w{wbits} {cfg.name} L={n_layers} budget {frac:.0%} = {mb:.1f} MiB: "
                f"decode io_sim {runs[(wbits, frac)]['decode_io_sim_s'] * 1e3:.2f} ms over "
                f"{DECODE} steps, cache_hit_rate {io['cache_hit_rate']:.3f}, io_bytes "
                f"{io['io_bytes'] / 1e6:.1f} MB, wall {wall * 1e3:.2f} ms/step, launches "
                f"{launches}; tokens, hits, misses and io_est equal to the reference backend; "
                f"hit rows per refresh step within every cap  ({card})")
            if frac == CACHE_FRACS[1]:
                mid[wbits] = eng
            else:
                del eng
        ios = [runs[(wbits, f)]["decode_io_sim_s"] for f in CACHE_FRACS]
        falls = all(b < a for a, b in zip(ios, ios[1:]))
        runs[(wbits, "io_falls")] = falls
        log(f"[cache] w{wbits} decode io_sim by budget "
            + " > ".join(f"{x * 1e3:.2f}" for x in ios) + f" ms: falls as the budget grows: "
            f"{'yes' if falls else 'NO'}")

    # -- per-token against fused, at the middle budget and refresh interval 2
    per_token = {}
    for wbits in (16, 8):
        mb = runs[(wbits, CACHE_FRACS[1])]["cache_mb"]
        fused, out_f = serve("kernel", wbits, mb, refresh=2)
        loop, out_p = serve("kernel", wbits, mb, per_token=True, refresh=2)
        if not torch.equal(out_f, out_p):
            fail(f"cache w{wbits}: decode_per_token tokens {out_p.tolist()} != decode "
                 f"{out_f.tolist()}")
        if fused.io_summary()["hit_rows"] != loop.io_summary()["hit_rows"]:
            fail(f"cache w{wbits}: per-token hits differ from the fused loop's")
        walls = [sum(st.wall_s for st in e.stats if st.kind == "decode") / DECODE
                 for e in (fused, loop)]
        per_token[wbits] = {"fused_wall_per_token_s": walls[0],
                            "per_token_wall_per_token_s": walls[1]}
        log(f"[cache] w{wbits} refresh interval 2: decode_per_token tokens equal decode's; "
            f"wall per token fused {walls[0] * 1e3:.2f} ms, per-token {walls[1] * 1e3:.2f} ms "
            f"({card})")
        del fused, loop

    # -- the repriced timeline, and depth 7 against depth 1
    eng = mid[16]
    reprice = {}
    for depth in range(5):
        tl = eng.reprice_timeline(depth)
        reprice[depth] = float(tl.overlap_s.sum())
    log("[cache] w16 reprice_timeline overlapped charge over the decode: " + ", ".join(
        f"depth {d} {v * 1e3:.3f} ms" for d, v in reprice.items()))
    deep, out_deep = serve("kernel", 16, runs[(16, CACHE_FRACS[1])]["cache_mb"], depth=7)
    if out_deep.tolist() != runs[(16, CACHE_FRACS[1])]["tokens"]:
        fail(f"cache: depth 7 tokens {out_deep.tolist()} != depth 1 tokens")
    log("[cache] depth 7 (ring at 3) tokens equal depth 1's on the kernel backend")
    del deep

    # -- the kernels on the middle budget's own tables against their plain
    # versions (the calls that are timed)
    timing = {}
    for wbits in (16, 8):
        timing[wbits], calls = decode_timings(mid[wbits], wbits, randn, cuda_ms, host_ms, card,
                                              f"[cache] w{wbits}")
        for i, (name, (w, xm, st_, sz, sc)) in enumerate(zip(calls["k1_sites"], calls["k1"])):
            check("chunk_gather_matmul_dma", f"cache w{wbits} L{i // 4} {name}",
                  cg.chunk_gather_matmul_dma(w, xm, st_, sz, sc),
                  cg.chunk_gather_matmul_plain(w, xm, st_, sz, sc))
        for layer, (wg, wu, wd, xm, st_, sz, fm, scs) in enumerate(calls["k2"]):
            yk, hk = cg.chunk_gather_mlp_dma(wg, wu, wd, xm, st_, sz, fm, scs, return_h=True)
            yp, hp = cg.chunk_gather_mlp_plain(wg, wu, wd, xm, st_, sz, fm, scs)
            check("chunk_gather_mlp_dma", f"cache w{wbits} L{layer} y", yk, yp)
            check("chunk_gather_mlp_dma", f"cache w{wbits} L{layer} h", hk, hp)
        for args in calls["k5"]:
            for got, want_ in zip(chunking.greedy_select(*args),
                                  chunking.greedy_select_plain(*args)):
                check("greedy_select", f"cache w{wbits} {args[0].shape[0]} lanes", got, want_)
        for k, v in timing[wbits].items():
            lib = "n/a" if v["library_ms"] is None else f"{v['library_ms'] * 1e3:.1f} us"
            log(f"[cache] w{wbits} {k}: {v['ms'] * 1e3:.1f} us/launch  plain "
                f"{v['plain_ms'] * 1e3:.1f} us  library {lib}  bound "
                f"{v['bound_ms'] * 1e3:.2f} us ({v['bound_by']})  ({card})")
    if check.failures:
        for msg in check.failures:
            log(f"[cache] {msg}")
        fail(f"{len(check.failures)} phase-8 kernel checks failed")
    log(f"[cache] bitwise: {check.n} checks, max abs err "
        + ", ".join(f"{k} {v:.1e}" for k, v in check.errs.items()))
    del mid
    report["cache"] = {"runs": {f"w{w} {f}": v for (w, f), v in runs.items()},
                       "per_token": per_token, "reprice_overlap_s": reprice,
                       "timing": timing, "errs": check.errs, "n_checks": check.n}
    meta = {
        "chunk_gather_matmul_dma": ("src/repro_torch/kernels/csrc/chunk_gather.cu",
                                    "src/repro/kernels/chunk_gather_dma.py:284"),
        "chunk_gather_mlp_dma": ("src/repro_torch/kernels/csrc/chunk_gather.cu",
                                 "src/repro/kernels/chunk_gather_dma.py:617"),
        "greedy_select": ("src/repro_torch/kernels/csrc/greedy_select.cu",
                          "src/repro/core/chunking.py:362"),
    }
    tag = f"{cfg.name}, residency cache {CACHE_FRACS[1]:.0%}"
    return [{"name": f"{name} [{tag}]", "route": "cuda", "source": source,
             "replaces": replaces, "launches": runs[(16, CACHE_FRACS[1])]["launches"][name],
             "max_abs_err": check.errs[name], "ms": timing[16][name]["ms"],
             "plain_ms": timing[16][name]["plain_ms"], "bound_ms": timing[16][name]["bound_ms"],
             "bound_by": timing[16][name]["bound_by"],
             "library_ms": timing[16][name]["library_ms"]}
            for name, (source, replaces) in meta.items()]


def refresh_time_us(eng, dev):
    """Mean host-clock µs of one all-layer refresh step of a served engine
    (selection, the integrity ladder where it is on, tables, pricing),
    synchronised, over REFRESH_REPS refreshes of its own plan."""
    import torch

    from repro_torch.models.transformer import _integrity_weights

    sp, plan = eng.sparse_ctx, eng._plan
    weights = _integrity_weights(eng.params["layers"], sp, eng.model.cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    sp.refresh_step(plan, True, weights)  # warm
    sync()
    t0 = time.perf_counter()
    for _ in range(REFRESH_REPS):
        sp.refresh_step(plan, True, weights)
    sync()
    return (time.perf_counter() - t0) / REFRESH_REPS * 1e6


def robust_path(dev, cfg, card, report):
    """Phase 9, the engine half on ``cfg`` at full width and depth (prompt
    PROMPT, DECODE decode tokens, chunk at sparsity 0.4, kernel backend):
    every fault profile (tokens equal to the fault-off run's, charged time
    moved); ``thermal_throttle`` with and without the degradation
    controller over four calls of DECODE / 4 tokens (the scale goes below
    1.0 and the bytes per token fall); ``bit_rot`` with recovery at wbits 16
    and 8 (tokens equal, detected == recovered > 0, re-read seconds > 0;
    the wbits-16 run is the path whose K1/K2 launches, with their checksum
    lanes, are counted from 0); ``degraded_nand`` and recovery off, each
    twice (replays exact; substitutes or drops; corrupted tokens); the
    counter-based draws on the card against the same draws on the CPU; the
    refresh step's time with integrity on and off; then, at TWIN_LAYERS of
    the layers, the kernel backend against the reference backend's twin on
    corrupted tokens (recovery off and ``degraded_nand``). Returns the
    phase's launch counts."""
    import dataclasses

    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core import chunking
    from repro_torch.core.faults import FAULT_PROFILES
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.models import build_model
    from repro_torch.models.inputs import make_dummy_batch
    from repro_torch.serving import ServeEngine

    on_card = dev.type == "cuda"
    out = {"runs": {}}

    def build(cfg_):
        model = build_model(cfg_)
        params = model.init(seed=0, device=dev)
        batch = make_dummy_batch(cfg_, InputShape("robust", PROMPT, BATCH, "train"), seed=0,
                                 device=dev)
        return model, params, batch

    def serve(model, params, batch, calls=1, tag=None, **kw):
        kw.setdefault("backend", "kernel")
        eng = ServeEngine(model, params, max_seq=64, batch_size=BATCH, method="chunk",
                          torch_device=dev, **kw)
        tok = torch.argmax(eng.prefill(batch), dim=-1)[:, None]
        toks = [tok.cpu()]
        for _ in range(calls):
            t = eng.decode(tok, DECODE // calls)
            toks.append(t[:, 1:])
            tok = t[:, -1:].to(dev)
        toks = torch.cat(toks, dim=1)
        io, fs = eng.io_summary(), eng.fault_summary()
        if tag is not None:
            out["runs"][tag] = {"tokens": toks.tolist(),
                                **{k: v for k, v in io.items() if k != "select_overhead_s"},
                                **{k: v for k, v in fs.items() if k.startswith("degrade_")}}
            log(f"[robust] {tag}: io_sim {io['io_sim_s'] * 1e3:.3f} ms  io_bytes "
                f"{io['io_bytes'] / 1e6:.1f} MB  faults {fs['fault_events']} events "
                f"{fs['fault_spikes']} spikes {fs['fault_retries']} retries, min throttle "
                f"{fs['min_throttle_scale']:.3f}  corruptions det/rec/sub/drop "
                f"{io['corruptions_detected']:.0f}/{io['corruptions_recovered']:.0f}/"
                f"{io['corruptions_substituted']:.0f}/{io['corruptions_dropped']:.0f} re-read "
                f"{io['integrity_reread_s'] * 1e3:.3f} ms  degrade scale "
                f"{fs['degrade_scale']:.2f}")
        return eng, toks

    model, params, batch = build(cfg)
    base = {}
    for wbits in (16, 8):
        base[wbits] = serve(model, params, batch, wbits=wbits, tag=f"clean w{wbits}")
    t16 = base[16][1]
    io16 = base[16][0].io_summary()

    # faults: time only
    for name in FAULT_PROFILES:
        if name == "none":
            continue
        eng, toks = serve(model, params, batch, fault_profile=name, fault_seed=FAULT_SEED,
                          tag=f"fault {name}")
        io = eng.io_summary()
        if not torch.equal(toks, t16):
            fail(f"fault {name}: tokens {toks.tolist()} != fault-off {t16.tolist()}")
        if io["io_sim_s"] == io16["io_sim_s"] or io["fault_events"] == 0:
            fail(f"fault {name}: the charged time did not move ({io['io_sim_s']} s, "
                 f"{io['fault_events']} events)")
        if io["io_est_s"] != io16["io_est_s"] or io["io_bytes"] != io16["io_bytes"]:
            fail(f"fault {name}: the planning estimate or the bytes moved")
        del eng

    # the degradation controller under a sustained throttle: four calls
    throttled = {}
    for degrade in (False, True):
        eng, _ = serve(model, params, batch, calls=4, fault_profile="thermal_throttle",
                       fault_seed=FAULT_SEED, degrade=degrade,
                       tag=f"thermal_throttle degrade={degrade}")
        throttled[degrade] = (eng.io_summary(), eng.fault_summary())
        del eng
    per_tok = {k: v[0]["io_bytes"] / DECODE for k, v in throttled.items()}
    if not (throttled[True][1]["degrade_scale"] < 1.0 and per_tok[True] < per_tok[False]):
        fail(f"degrade: scale {throttled[True][1]['degrade_scale']}, io_bytes per token "
             f"{per_tok[True]:.0f} with vs {per_tok[False]:.0f} without")
    log(f"[robust] degrade under thermal_throttle: scale "
        f"{throttled[True][1]['degrade_scale']:.2f} after {throttled[True][1]['degrade_tighten_steps']} "
        f"tightenings, io_bytes per token {per_tok[True] / 1e6:.2f} vs {per_tok[False] / 1e6:.2f} "
        f"MB, io_sim {throttled[True][0]['io_sim_s'] * 1e3:.1f} vs "
        f"{throttled[False][0]['io_sim_s'] * 1e3:.1f} ms")

    # bit_rot with recovery: the main path of this phase (wbits 16), launches
    # counted from 0, every K1/K2 launch carrying its checksum lanes
    counters = (cg.LAUNCHES, cg.LANE_LAUNCHES, chunking.LAUNCHES)
    n_layers = cfg.n_layers
    lanes = {}
    for wbits in (16, 8):
        for c in counters:
            for k in c:
                c[k] = 0
        eng, toks = serve(model, params, batch, wbits=wbits, corruption_profile="bit_rot",
                          corruption_seed=CORRUPTION_SEED, tag=f"bit_rot recover w{wbits}")
        lanes[wbits] = {"lane": dict(cg.LANE_LAUNCHES), "all": dict(cg.LAUNCHES),
                        "greedy_select": chunking.LAUNCHES["greedy_select"]}
        want = {"chunk_gather_matmul_dma": 4 * n_layers * DECODE,
                "chunk_gather_mlp_dma": n_layers * DECODE}
        if on_card and (lanes[wbits]["lane"] != want or lanes[wbits]["all"] != want
                        or lanes[wbits]["greedy_select"] != DECODE + TIME_SELECTION_LAUNCHES):
            fail(f"bit_rot w{wbits}: launches {lanes[wbits]} != {want} with the lanes")
        io = eng.io_summary()
        if not torch.equal(toks, base[wbits][1]):
            fail(f"bit_rot w{wbits}: recovered tokens {toks.tolist()} != corruption-off "
                 f"{base[wbits][1].tolist()}")
        if not (io["corruptions_detected"] == io["corruptions_recovered"] > 0
                and io["integrity_reread_s"] > 0
                and io["corruptions_substituted"] == 0 == io["corruptions_dropped"]):
            fail(f"bit_rot w{wbits}: counters {io}")
        if wbits == 16:
            out["refresh_us"] = {"integrity on": refresh_time_us(eng, dev),
                                 "integrity off": refresh_time_us(base[16][0], dev)}
            # the draws on the card against the same draws on the CPU
            cm = eng.corruption
            nb = cfg.d_ff // 8
            lay = torch.arange(n_layers)[:, None]
            for stream in range(4):
                for site, matrix in ((0, 0), (2, 1), (3, 0)):
                    idx = torch.arange(nb)
                    cpu = (cm.uniforms(stream, lay, lay + 5, site, matrix, idx),
                           cm.integers(stream, lay, lay + 5, site, matrix, idx, 8 * 5632))
                    card_ = (cm.uniforms(stream, lay.to(dev), (lay + 5).to(dev), site, matrix,
                                         idx.to(dev)),
                             cm.integers(stream, lay.to(dev), (lay + 5).to(dev), site,
                                         matrix, idx.to(dev), 8 * 5632))
                    if not all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card_)):
                        fail(f"draws: stream {stream} site {site} matrix {matrix} differ "
                             "between the card and the CPU")
            out["draws_equal"] = 4 * 3 * 2 * n_layers * nb
            log(f"[robust] the counter-based draws: {out['draws_equal']} uniforms and "
                "integers on the card bit-equal to the CPU's")
        del eng
    out["lane_launches"] = lanes
    log(f"[robust] bit_rot recovered at wbits 16 and 8: tokens identical, launches with the "
        f"lanes {lanes[16]['lane']}; refresh step {out['refresh_us']['integrity on']:.0f} us "
        f"with integrity, {out['refresh_us']['integrity off']:.0f} us without ({card})")

    # degraded_nand (the ladder's rungs) and recovery off, each twice
    for tag, kw in (("degraded_nand", dict(corruption_profile="degraded_nand",
                                           corruption_seed=NAND_SEED, max_reread=1)),
                    ("bit_rot no-recover", dict(corruption_profile="bit_rot",
                                                corruption_seed=CORRUPTION_SEED,
                                                recover=False))):
        runs = [serve(model, params, batch, tag=f"{tag} run {i}", **kw) for i in (1, 2)]
        (e1, t1), (e2, t2) = runs
        c1, c2 = ({k: v for k, v in e.io_summary().items() if k != "select_overhead_s"}
                  for e in (e1, e2))
        if not (torch.equal(t1, t2) and c1 == c2):
            fail(f"{tag}: two runs differ ({t1.tolist()} vs {t2.tolist()})")
        if tag == "degraded_nand":
            if c1["corruptions_substituted"] + c1["corruptions_dropped"] <= 0:
                fail(f"degraded_nand: the ladder never substituted or dropped ({c1})")
        elif torch.equal(t1, t16) or c1["corruptions_detected"] <= 0:
            fail(f"{tag}: tokens equal the clean run's or nothing was detected")
        del runs, e1, e2
    del base, model, params
    if on_card:
        torch.cuda.empty_cache()

    # kernel backend against the reference backend's twin on corrupted tokens
    small = dataclasses.replace(cfg, n_layers=min(TWIN_LAYERS, cfg.n_layers))
    model, params, batch = build(small)
    for tag, kw in (("bit_rot no-recover", dict(corruption_profile="bit_rot",
                                                corruption_seed=CORRUPTION_SEED,
                                                recover=False)),
                    ("degraded_nand", dict(corruption_profile="degraded_nand",
                                           corruption_seed=NAND_SEED, max_reread=1))):
        got = {b: serve(model, params, batch, backend=b, **kw) for b in ("kernel", "reference")}
        (ek, tk_), (er, tr) = got["kernel"], got["reference"]
        ck, cr = ({k: v for k, v in e.io_summary().items() if k.startswith("corruptions")}
                  for e in (ek, er))
        if not (torch.equal(tk_, tr) and ck == cr):
            fail(f"{tag} at {small.n_layers} layers: kernel {tk_.tolist()} {ck} != reference "
                 f"backend {tr.tolist()} {cr}")
        out["runs"][f"twin {tag}"] = {"tokens": tk_.tolist(), **ck}
        log(f"[robust] {tag}, {small.n_layers} layers: kernel and reference backends "
            f"byte-identical on corrupted tokens ({ck})")
        del got, ek, er
    del model, params
    report["robust"] = out
    return out


def vlm_integrity(dev, cfg, model, params, card, report):
    """Phase 9 on the VLM (``vlm_model``'s config, model and weights):
    prefill → VLM_FRAMES frames → VLM_DECODE decode tokens at wbits 8 on the
    kernel backend, ``bit_rot`` with recovery against the corruption-off
    run: tokens byte-identical, detected == recovered > 0; the refresh
    step's time with integrity on and off; the run's K1/K2 launches with
    their lanes, counted from 0."""
    import numpy as np
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.models.inputs import FRONT_DTYPE, make_dummy_batch
    from repro_torch.serving import ServeEngine

    frame_tokens = max(cfg.frontend_tokens // 4, 4)
    prompt = make_dummy_batch(cfg, InputShape("vlm", VLM_PROMPT, BATCH, "train"), seed=0,
                              device=dev)
    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(rng.normal(0, 1, (BATCH, frame_tokens, cfg.d_frontend)))
              .to(FRONT_DTYPE).to(dev) for _ in range(VLM_FRAMES)]
    res = {}
    for tag, kw in (("clean", {}), ("bit_rot", dict(corruption_profile="bit_rot",
                                                     corruption_seed=CORRUPTION_SEED))):
        for c in (cg.LAUNCHES, cg.LANE_LAUNCHES):
            for k in c:
                c[k] = 0
        eng = ServeEngine(model, params, max_seq=VLM_MAX_SEQ, batch_size=BATCH, device="nano",
                          sparsity=0.4, method="chunk", backend="kernel", wbits=8,
                          torch_device=dev, **kw)
        last = eng.prefill(prompt)
        for fr in frames:
            eng.append_frame(fr)
        toks = eng.decode(torch.argmax(last, dim=-1)[:, None], VLM_DECODE)
        io = eng.io_summary()
        res[tag] = {"tokens": toks, "io": io, "lane": dict(cg.LANE_LAUNCHES),
                    "refresh_us": refresh_time_us(eng, dev)}
        del eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    io = res["bit_rot"]["io"]
    if not torch.equal(res["bit_rot"]["tokens"], res["clean"]["tokens"]):
        fail(f"vlm bit_rot w8: recovered tokens {res['bit_rot']['tokens'].tolist()} != "
             f"corruption-off {res['clean']['tokens'].tolist()}")
    if not (io["corruptions_detected"] == io["corruptions_recovered"] > 0
            and io["integrity_reread_s"] > 0):
        fail(f"vlm bit_rot w8: counters {io}")
    want = {"chunk_gather_matmul_dma": 4 * cfg.n_layers * VLM_DECODE,
            "chunk_gather_mlp_dma": cfg.n_layers * VLM_DECODE}
    if dev.type == "cuda" and res["bit_rot"]["lane"] != want:
        fail(f"vlm bit_rot w8: launches with the lanes {res['bit_rot']['lane']} != {want}")
    out = {"lane_launches": res["bit_rot"]["lane"],
           "refresh_us": {"integrity on": res["bit_rot"]["refresh_us"],
                          "integrity off": res["clean"]["refresh_us"]},
           "counters": {k: v for k, v in io.items() if k.startswith(("corruptions", "integrity"))},
           "tokens": res["clean"]["tokens"].tolist()}
    report["robust_vlm"] = out
    log(f"[robust] {cfg.name} {cfg.n_layers} layers w8 bit_rot recovered: tokens identical, "
        f"det/rec {io['corruptions_detected']:.0f}/{io['corruptions_recovered']:.0f}, re-read "
        f"{io['integrity_reread_s'] * 1e3:.3f} ms; refresh step "
        f"{out['refresh_us']['integrity on']:.0f} us with integrity, "
        f"{out['refresh_us']['integrity off']:.0f} us without; launches with the lanes "
        f"{out['lane_launches']}  ({card})")
    return out


def lane_rows(report):
    """The kernel line's "checksum lane" rows: K1 and K2 with their lanes at
    depth 1 and wbits 16 (phase 9 on phase 5's and phase 7's tables), with
    the launches of phase 9's integrity runs."""
    rows = []
    src = "src/repro_torch/kernels/csrc/chunk_gather_ck.cu"
    for model, launches, timing in (
            ("tinyllama", report["robust"]["lane_launches"][16]["lane"], report["timing"][16]),
            ("internvl2", report["robust_vlm"]["lane_launches"], report["vlm"]["timing"][16])):
        lanes = report["lanes"][model]
        for name, line in (("chunk_gather_matmul_dma", 284), ("chunk_gather_mlp_dma", 617)):
            t = lanes["timing"][16][name]
            rows.append({"name": f"{name}, checksum lane [{model}]", "route": "cuda",
                         "source": src, "replaces": f"src/repro/kernels/chunk_gather_dma.py:{line}",
                         "launches": launches[name], "max_abs_err": lanes["errs"][name],
                         "ms": t[1]["ms_lane"], "ms_without_lane": t[1]["ms_none"],
                         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"],
                         # the lane computes the function without it: (x·m) @ W for K1
                         "library_ms": timing[name]["library_ms"]})
    return rows


def vlm_model(dev, full_cfg):
    """``full_cfg`` at full width, depth cut to VLM_LAYERS, with random
    weights from seed 0 on ``dev``: (config, model, params)."""
    import dataclasses

    from repro_torch.models import build_model

    cfg = dataclasses.replace(full_cfg, n_layers=min(VLM_LAYERS, full_cfg.n_layers))
    model = build_model(cfg)
    return cfg, model, model.init(seed=0, device=dev)


def vlm_cache(dev, cfg, model, params, card, report):
    """Phase 8, the VLM: ``full_cfg`` at full width, depth cut to VLM_LAYERS,
    prefill → VLM_FRAMES frames → VLM_DECODE decode tokens with the
    residency cache at VLM_CACHE_FRAC of ``sparsifiable_bytes``: chunk at
    wbits 16 and 8 and top-k at wbits 16, each on the kernel backend (launch
    counts exact) against the reference backend (tokens equal); then
    simulated I/O per decode token for chunk and top-k with and without
    the cache (wbits 16, kernel backend). ``cfg``, ``model``, ``params``:
    from ``vlm_model``."""
    import numpy as np
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.models.inputs import FRONT_DTYPE, make_dummy_batch
    from repro_torch.serving import ServeEngine, SparseExecution

    on_card = dev.type == "cuda"
    n_layers = cfg.n_layers
    frame_tokens = max(cfg.frontend_tokens // 4, 4)
    _, sync = seeded(dev, 0)
    prompt = make_dummy_batch(cfg, InputShape("vlm", VLM_PROMPT, BATCH, "train"), seed=0,
                              device=dev)
    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(rng.normal(0, 1, (BATCH, frame_tokens, cfg.d_frontend)))
              .to(FRONT_DTYPE).to(dev) for _ in range(VLM_FRAMES)]
    counters = (cg.LAUNCHES, chunking.LAUNCHES)

    def serve(backend, wbits, method, cache_mb):
        eng = ServeEngine(model, params, max_seq=VLM_MAX_SEQ, batch_size=BATCH,
                          device="nano", sparsity=0.4, method=method, backend=backend,
                          wbits=wbits, cache_mb=cache_mb, torch_device=dev)
        last = eng.prefill(prompt)
        for fr in frames:
            eng.append_frame(fr)
        out = eng.decode(torch.argmax(last, dim=-1)[:, None], VLM_DECODE)
        sync()
        io = eng.io_summary()
        dec = [st for st in eng.stats if st.kind == "decode"]
        res = {"io_sim_per_token_s": sum(st.io_sim_s for st in dec) / VLM_DECODE,
               "cache_hit_rate": io["cache_hit_rate"], "io_bytes": io["io_bytes"],
               "wall_per_step_s": sum(st.wall_s for st in dec) / VLM_DECODE,
               "tokens": out.tolist()}
        return eng, out, res

    runs = {}
    for wbits, method in ((16, "chunk"), (8, "chunk"), (16, "topk")):
        mb = VLM_CACHE_FRAC * SparseExecution(cfg, wbits=wbits, torch_device=dev) \
            .sparsifiable_bytes(n_layers) / 2**20
        for c in counters:
            for k in c:
                c[k] = 0
        eng, out, res = serve("kernel", wbits, method, mb)
        launches = {**cg.LAUNCHES, **chunking.LAUNCHES}
        # top-k selects with a rank, not with K5
        want = {"chunk_gather_matmul_dma": 4 * n_layers * VLM_DECODE,
                "chunk_gather_mlp_dma": n_layers * VLM_DECODE,
                "greedy_select": VLM_DECODE + TIME_SELECTION_LAUNCHES
                + 4 * n_layers * VLM_FRAMES if method == "chunk" else 0}
        if on_card and launches != want:
            fail(f"vlm cache w{wbits} {method}: launch counts {launches} != {want}")
        del eng
        ref, out_ref, res_ref = serve("reference", wbits, method, mb)
        if not torch.equal(out, out_ref):
            fail(f"vlm cache w{wbits} {method}: kernel tokens {out.tolist()} != reference "
                 f"backend tokens {out_ref.tolist()}")
        del ref
        if on_card:
            torch.cuda.empty_cache()
        runs[f"w{wbits} {method} cache"] = {**res, "cache_mb": mb, "launches": launches}
        log(f"[vlm-cache] w{wbits} {method} budget {VLM_CACHE_FRAC:.0%} = {mb:.0f} MiB: "
            f"io_sim {res['io_sim_per_token_s'] * 1e3:.2f} ms/token, cache_hit_rate "
            f"{res['cache_hit_rate']:.3f}, wall {res['wall_per_step_s'] * 1e3:.2f} ms/step, "
            f"launches {launches}; tokens equal to the reference backend  ({card})")
    for method in ("chunk", "topk"):
        eng, _, res = serve("kernel", 16, method, 0.0)
        del eng
        runs[f"w16 {method} no cache"] = res
    log(f"[vlm-cache] {cfg.name} at {n_layers} layers, wbits 16, simulated I/O per decode "
        "token: " + ", ".join(f"{k} {v['io_sim_per_token_s'] * 1e3:.2f} ms"
                              for k, v in runs.items() if k.startswith("w16")))
    report["vlm_cache"] = runs
    if on_card:
        torch.cuda.empty_cache()


def long_prompt(dev, cfg, model, params, card, report):
    """Phase 8, the long prompt: the VLM of ``vlm_model``, LONG_FRAMES
    frames of frontend_tokens vision tokens and LONG_TEXT text tokens
    through ``Model.prefill`` — the blockwise attention above
    ``attention.BLOCKWISE_THRESHOLD`` positions — against the same prefill
    on the direct path (the module's threshold raised above the prompt for
    that run): last-position logits within LONG_TOL of their largest
    magnitude, and each path's peak device memory. Then, in one more
    prefill per path, layer 0's attention in f32 (before its bf16 cast) on
    the prompt's own q/k/v, blockwise against direct over every position at
    LONG_ATOL, the share of its bf16 outputs that round apart, and the gap
    between the two paths' residual streams after every layer."""
    import numpy as np
    import torch

    from repro_torch.models import attention, transformer

    on_card = dev.type == "cuda"
    rng = np.random.default_rng(0)
    n_front = LONG_FRAMES * cfg.frontend_tokens
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, LONG_TEXT)))
             .to(dev),
             "frontend": torch.from_numpy(rng.normal(0, 1, (BATCH, n_front, cfg.d_frontend)))
             .to(torch.bfloat16).to(dev)}
    positions = n_front + LONG_TEXT
    threshold = attention.BLOCKWISE_THRESHOLD
    paths = (("blockwise", threshold), ("direct", positions))

    def prefill(path_threshold):
        attention.BLOCKWISE_THRESHOLD = path_threshold
        try:
            return model.prefill(params, batch, positions + 8)
        finally:
            attention.BLOCKWISE_THRESHOLD = threshold

    out = {}
    for path, path_threshold in paths:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        last, cache = prefill(path_threshold)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if cache["length"] != positions or not bool(torch.isfinite(last).all()):
            fail(f"long prompt ({path}): length {cache['length']} or non-finite logits")
        out[path] = {"logits": last.float(), "peak_bytes": peak, "wall_s": wall}
        del cache
    diff = float((out["blockwise"]["logits"] - out["direct"]["logits"]).abs().max())
    scale = float(out["direct"]["logits"].abs().max())
    same_argmax = bool(torch.equal(out["blockwise"]["logits"].argmax(-1),
                                   out["direct"]["logits"].argmax(-1)))
    if diff > LONG_TOL * scale:
        fail(f"long prompt: blockwise logits differ from the direct path's by {diff:.4f} "
             f"(max |logit| {scale:.3f}, tolerance {LONG_TOL:.0%} of it)")

    # -- where the gap comes from: each layer's residual stream (kept on the
    # host), and layer 0's q/k/v as the attention receives them
    layers, qkv = {}, []
    inner_block, inner_blockwise = transformer.block_prefill, attention._blockwise_attention

    def block_prefill(*args, **kwargs):
        x, k, v = inner_block(*args, **kwargs)
        layers[current].append(x.float().cpu())
        return x, k, v

    def blockwise(q, k, v, *args, **kwargs):
        if not qkv:
            qkv.extend(t.detach().clone() for t in (q, k, v))
        return inner_blockwise(q, k, v, *args, **kwargs)

    transformer.block_prefill, attention._blockwise_attention = block_prefill, blockwise
    try:
        for current, path_threshold in paths:
            layers[current] = []
            prefill(path_threshold)
    finally:
        transformer.block_prefill = inner_block
        attention._blockwise_attention = inner_blockwise
    if positions > threshold and not qkv:
        fail("long prompt: the blockwise attention never ran")
    gaps = []
    for xb, xd in zip(layers["blockwise"], layers["direct"]):
        gaps.append({"max_abs_diff": float((xb - xd).abs().max()),
                     "max_abs": float(xd.abs().max()),
                     "share_differing": float((xb != xd).float().mean())})
    del layers
    attn0 = None
    if qkv:  # the prompt took the blockwise path
        q, k, v = (t.float() for t in qkv)
        del qkv[:]
        s = q.shape[1]
        blk = attention._blockwise_attention(q, k, v, 0, True)
        pos = torch.arange(s, device=q.device)
        dirc = attention._direct_attention(q, k, v, pos[None, :] <= pos[:, None])
        err = float((blk - dirc).abs().max())
        attn0 = {"max_abs_err": err, "max_abs": float(dirc.abs().max()),
                 "bf16_share_differing": float(
                     (blk.to(torch.bfloat16) != dirc.to(torch.bfloat16)).float().mean())}
        del q, k, v, blk, dirc
        if err > LONG_ATOL:
            fail(f"long prompt: layer 0's f32 attention, blockwise against direct over "
                 f"{s} positions, max abs err {err:.3e} > {LONG_ATOL:.0e}")
    report["long_prompt"] = {"positions": positions, "max_abs_diff": diff, "max_abs_logit": scale,
                             "same_argmax": same_argmax, "layer0_attention_f32": attn0,
                             "residual_gap_by_layer": gaps,
                             **{f"{k}_{m}": v[m] for k, v in out.items()
                                for m in ("peak_bytes", "wall_s")}}
    log(f"[long] {cfg.name} at {cfg.n_layers} layers, batch {BATCH}, {LONG_FRAMES} frames x "
        f"{cfg.frontend_tokens} vision + {LONG_TEXT} text = {positions} positions: blockwise "
        f"vs direct last-position logits max abs diff {diff:.4f} (max |logit| {scale:.3f}, "
        f"tolerance {LONG_TOL:.0%} of it; argmax equal: {same_argmax}); peak "
        f"{out['blockwise']['peak_bytes'] / 2**30:.2f} GiB blockwise, "
        f"{out['direct']['peak_bytes'] / 2**30:.2f} GiB direct; prefill "
        f"{out['blockwise']['wall_s'] * 1e3:.0f} / {out['direct']['wall_s'] * 1e3:.0f} ms  "
        f"({card})")
    if attn0 is not None:
        log(f"[long] layer 0 attention in f32, blockwise vs direct over {positions} positions: "
            f"max abs err {attn0['max_abs_err']:.3e} (max |out| {attn0['max_abs']:.3f}, "
            f"tolerance {LONG_ATOL:.0e}); after the bf16 cast "
            f"{attn0['bf16_share_differing']:.4%} of the outputs differ  ({card})")
    log("[long] residual stream after each layer, blockwise vs direct: " + "; ".join(
        f"L{i} max abs diff {g['max_abs_diff']:.4g} of {g['max_abs']:.4g}, "
        f"{g['share_differing']:.2%} differ" for i, g in enumerate(gaps)) + f"  ({card})")


if __name__ == "__main__":
    main()
