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
     shared-memory limit), bf16 and int8 at depths 0-3; at StarCoder2-7B's
     widths K1 over the gelu MLP's w_fc (4608 → 18432) and w_proj (18432 →
     4608), with x pre-masked and with an input mask, and at
     Granite-3-2B's widths K2 whole, bf16 and int8 at depths 0-3; and the
     reduced model on the card against the same model on the CPU;
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
     prefill: full-width tinyllama-1.1b, depth cut to SLIM_LAYERS (8) of
     22 layers (the script's time limit), prompt 32, 16
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
     then full-width tinyllama-1.1b (SLIM_LAYERS of 22 layers, kernel
     backend, 16 decode
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
 10. continuous batching (``Scheduler`` over the engine's slot mode, paged
     KV): TinyLlama-1.1B, 22 layers, 24 chat requests through 8 slots on
     both backends and on the dense cache, page pressure and deadlines;
     InternVL2-76B as in phase 7 through 4 slots.
 11. the other dense decoders at full width and depth: starcoder2-7b (32
     layers; LayerNorm, the gelu MLP as two K1 calls) and granite-3-2b
     (40 layers; the tied head, K2), as phase 4 serves TinyLlama — exact
     launch counts, tokens byte-identical to the reference backend at
     wbits 16 and 8, every K1/K2/K5 call timed (K1 per site, fc and proj
     set apart) and held bitwise; then the rotating window on
     starcoder2-7b: max_seq 65,600 (a 4096-position cache), a 4160-token
     prompt rolled in, 16 teacher-forced dense decode steps against a
     windowed forward over all positions (LONG_TOL), and a kernel-backend
     serve against the reference backend's tokens.
 12. the mixture-of-experts decoders at full width: olmoe-1b-7b at all 16
     layers (64 experts top-8, d_ff 1024) and llama4-scout-17b-a16e at 8
     of its 48 layers (16 experts top-1 + the shared expert, d_ff 8192,
     d_frontend 1408; all 48 layers' 215 GB of bf16 do not fit one card):
     K1 bitwise at the attention sites' widths; then, as phase 11 serves
     its archs, a prompt of PROMPT tokens (Scout: half vision, then
     MOE_FRAMES frames), DECODE decode tokens at wbits 16 and 8 — exact
     launch counts (K1 4 a layer a step, K2 none: a MoE layer has no MLP
     sites), tokens equal to the reference backend's, every K1/K5 call
     timed held bitwise, wall and idle share a step; and the MoE FFN at the
     decode's shape, device µs a layer from CUDA-graph replays of the layer
     loop (the profiler's kernel sum beside it) against its HBM bound.
 13. the hybrid, recurrent and audio families at full width and depth:
     zamba2-7b (81 Mamba2 layers, the shared attention block after every
     6), xlstm-125m (12 blocks) and whisper-small (12 + 12 layers over 1500
     audio positions), served as phase 4 serves TinyLlama with chunk and
     dense_free — exact launch counts (no K1 or K2: their decode reaches no
     sparsification site; K5 in the engine's selection timing), tokens of
     dense_free equal to chunk's, wall a step and of the prefill, idle
     share and host launches a step, io_summary; K5 on the selection
     timing's lanes bitwise and timed; prefill + sequential decode against
     a forward's last logits in f32 (Zamba at 15 layers); the reduced
     config on the card against the CPU; paged KV, wbits 8 and the frame
     append refused.
 14. training: tinyllama-1.1b at full width and depth (22 layers, d_model
     2048, d_ff 5632, vocab 32000), random weights from a seed, batch 8 x
     512 tokens of the synthetic pipeline (drawn before the timed window,
     its host time printed apart), remat on, the chunked-CE loss, AdamW:
     2 warm-up and 6 timed steps (wall a step, tokens/s, 6·N·T FLOPs a step
     against the bf16 dense peak, peak memory), one profiled step (idle
     share, host launches), every loss and grad_norm finite, no chunk-gather
     kernel launched; one step with remat off from the same state as a
     remat-on step (equal loss, both peaks); then each family's reduced
     config, one bf16 step on the card against the CPU, and a checkpoint
     saved from the card and loaded on the CPU, bitwise.
 15. sharded serving: tinyllama-1.1b at full width and depth, batch 2,
     chunk at sparsity 0.4 on nano, the kernel backend, wbits 16 and 8.
     The card runs the one-rank mesh only (NCCL refuses two ranks on one
     device; the 2×2 mesh runs on the CPU in the tests): (a)
     ``ServeMesh.create(1, 1)`` is inert — tokens equal the engine's
     without a mesh, ``shard_summary`` one shard holding the I/O, no event
     with shard bytes; (b) a world-size-1 NCCL process group (a file://
     store in a temporary directory) and a (1, 1) DeviceMesh under a
     ``ServeMesh(1, 1, mesh, rules)``, so the sharded code path runs on the
     card (placement, ``_gather``, the data-group gather of the
     selection's activations, per-shard lanes of width 1): tokens equal
     (a)'s with exact K1/K2/K5 launch counts, the per-shard bytes summing
     to ``io_bytes``, the decode step's wall against the unsharded one, the
     gathers' span a step by CUDA events and their device time (a layer's
     slices gathered alone under the profiler); (c) slot mode with the
     paged KV cache on the same one-rank mesh (the pool's pages split over
     the data ranks, reached through the ``PageExchange``): two requests,
     eight tokens, at wbits 16 — tokens equal the dense slot cache's on the
     mesh and the unsharded paged engine's, exact K1/K2 launch counts,
     ``kv_pages_per_shard`` summing to ``kv_pages_in_use``. The group is
     destroyed at the end.
 16. training on the one-rank (data, model) mesh (see ``mesh_train_path``).
 17. the dry run (``repro_torch.launch.dryrun``) in a subprocess, on torch's
     fake process group with device type ``cuda`` (it starts after the
     build and works beside phases 3-18 on one thread of the host's CPU,
     at a lower priority): DRYRUN_PAIRS on the fake
     (16, 16) production mesh (tinyllama-1.1b/train_4k at 6 of 22 layers,
     internvl2-76b/decode_32k at 40 of 80, xlstm-125m/train_4k at 4 of 12,
     olmoe-1b-7b/train_4k at 4 of 16, olmoe-1b-7b/prefill_32k at 1 of 16,
     llama4-scout-17b-a16e/train_4k at 1 of 48 and xlstm-125m/prefill_32k
     at 4 of 12: depths cut for time; whole models:
     ``--all`` on the CPU, PERF.md), each report and per-rank peak,
     FLOPs and trace seconds printed; a prefill's output bytes a rank
     (its cache and last logits) must not exceed the whole cache over the
     ranks its shapes divide it over (DRYRUN_CACHE_RANKS: 256 for OLMoE,
     16 for xLSTM) plus the logits' bound, and the placements' blocks must
     be that share (its peak is printed beside the whole cache's bytes);
     then on a fake 1×1 mesh phase 14's own step (TinyLlama-1.1B, batch 8 x
     512, remat) and phase 18's two chunk-64 steps, whose predicted peak
     memory, against the real step's measured ``max_memory_allocated``,
     must lie within DRYRUN_PEAK_RATIO, and whose FLOPs must equal
     ``FlopCounterMode``'s count of the real step exactly (phase 14's step
     and phase 18's 2 x 1024 step: the counter's Python dispatch would
     make the 2 x 4096 step take minutes).
 18. xLSTM training at the scans' chunk grain (runs before phase 17, which
     judges its predictions): xlstm-125m at full width, XLSTM_TRAIN_LAYERS
     blocks (one mLSTM and one sLSTM: the config's kinds, depth cut for
     time), random weights from a seed, one step with remat at batch 2 x
     4096 and the reference's chunk of 64 steps (wall, peak memory from the
     step's start); then one step at 2 x 1024 with chunk 64 under
     ``FlopCounterMode`` and one with a single chunk as long as the
     sequence, from the same state: loss, grad_norm and the first moments
     bitwise equal, each step's peak memory printed.

Prints the kernel table as one JSON line (K1-K5 from phases 4-6, phase
7's K1, K2 and K5 rows, phase 8's and phase 9's checksum-lane rows, phase
10's slot rows, phase 11's and phase 12's rows per arch, phase 13's K5 row
per arch; phase 14's training path launches none of the kernels), then,
as the last line,
``{"ok": true, "device": {...}}``. A fuller report goes to
``chiprun_out/chip_smoke_report.json``.
"""
import contextlib
import dataclasses
import gc
import importlib
import json
import math
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
# dense bf16 on the tensor cores (the MoE's batched expert products)
BF16_OPS_PER_S = 989e12

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
# bytes (TinyLlama, at SLIM_LAYERS), the VLM's, and the long prompt (frames of
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


# phase 10: continuous batching. TinyLlama: SLOTS request slots over a
# max_seq of SLOT_MAX_SEQ in PAGE_TOKENS-token pages, ROUND_TOKENS tokens a
# round; SLOT_REQUESTS chat requests at ARRIVAL_RATE/s (the CLI's default),
# each a SYSTEM_TOKENS-token system prompt (one of SYSTEMS) and
# USER_TOKENS of its own, SLOT_NEW new tokens; K1/K2 timed at
# SLOT_TIMING_BATCHES rows on the run's tables. Page pressure: a pool of
# PRESSURE_PAGES pages. Deadlines: the rate and the deadline in units of
# the clean run's mean charged decode step (DEADLINE_GAP_STEPS between
# arrivals; the first of DEADLINE_STEPS whose throttled run preempts).
# The VLM: VLM_SLOTS slots, VLM_REQUESTS requests of VLM_PROMPT tokens
# (half vision), two of them the same, VLM_SLOT_NEW new tokens.
SLOTS, SLOT_MAX_SEQ, PAGE_TOKENS, ROUND_TOKENS = 8, 512, 16, 4
# phases 8 and 9 run TinyLlama-1.1B at full width, depth cut to SLIM_LAYERS
# of its 22 layers, so that the script with phase 10 stays inside its time
# limit (phase 10 and phases 4-6 keep all 22)
SLIM_LAYERS = 8
SLOT_REQUESTS, SYSTEMS, SYSTEM_TOKENS, USER_TOKENS, SLOT_NEW = 24, 3, 32, 16, 16
ARRIVAL_RATE, SLOT_TIMING_BATCHES, PRESSURE_PAGES = 50.0, (8, 16), 19
DEADLINE_GAP_STEPS, DEADLINE_STEPS = 2.0, (24.0, 16.0, 40.0)
VLM_SLOTS, VLM_REQUESTS, VLM_SLOT_NEW = 4, 8, 8


# phase 11: the other dense decoders at full width, (arch, layers kept),
# served as phase 4 serves TinyLlama (StarCoder2-7B: LayerNorm, the gelu
# MLP through K1; Granite-3-2B: the tied head, K2); depth cut to 8 of 32
# and 10 of 40 layers for the script's time limit (the phase took 174 s of
# 904 at full depth on a typical host; slow hosts ran the script past its
# 1200 s): every kernel keeps its widths, its launch counts scale with the
# layers. Then the rotating window on StarCoder2-7B's weights: a cache for
# WINDOW_MAX_SEQ positions (past the 65,536-position threshold, so it holds
# sliding_window = 4096), a prompt of WINDOW_PROMPT tokens (over the
# window, so rolled, and over BLOCKWISE_THRESHOLD), WINDOW_DECODE decode
# steps
DENSE_ARCHS, WINDOW_ARCH = (("starcoder2-7b", 8), ("granite-3-2b", 10)), "starcoder2-7b"
WINDOW_MAX_SEQ, WINDOW_PROMPT, WINDOW_DECODE = 65_600, 4_160, 16


# phase 12: the mixture-of-experts decoders at full width, (arch, layers
# kept): OLMoE-1B-7B whole (13.8 GB of bf16); Llama-4-Scout cut to 8 of its
# 48 layers (a layer is 4.4 GB of bf16 and embed + head 4.1 GB: 8 layers
# take ~39 GB, all 48 ~215 GB, over one card's 80). Scout's prompt is half
# vision, then MOE_FRAMES frames of frontend_tokens // 4 tokens; max_seq
# MOE_MAX_SEQ
MOE_ARCHS = (("olmoe-1b-7b", None), ("llama4-scout-17b-a16e", 8))
MOE_FRAMES, MOE_MAX_SEQ = 3, 256


# phase 13: the hybrid, recurrent and audio families at full width and
# depth (Zamba2-7B: 81 Mamba2 layers and 13 applications of the shared
# block, 13.6 GB of bf16; xLSTM-125M; Whisper-small: 12 + 12 layers over
# 1500 audio positions), served as phase 4 serves TinyLlama with a cache of
# FAMILY_MAX_SEQ positions. Their decode reaches no sparsification site: K1
# and K2 never launch, K5 only in SparseExecution.time_selection. The f32
# consistency check (prefill + sequential decode against a forward's last
# logits, CONSIST_SEQ tokens, CONSIST_TOL: the reference suite's 1e-3) runs
# Zamba at CONSIST_ZAMBA_LAYERS (two groups of six and a tail of three);
# card against CPU at the reduced configs within CPU_TOL (the port's bf16
# tolerance), over CPU_DECODE teacher-forced decode steps
FAMILY_ARCHS, FAMILY_MAX_SEQ = ("zamba2-7b", "xlstm-125m", "whisper-small"), 64
CONSIST_SEQ, CONSIST_ZAMBA_LAYERS, CONSIST_TOL = 12, 15, dict(atol=1e-3, rtol=1e-3)
CPU_TOL, CPU_DECODE = dict(atol=4e-2, rtol=4e-2), 4


# phase 14: training. TRAIN_ARCH at full width and depth with remat, batch
# TRAIN_BATCH x TRAIN_SEQ tokens, loss chunk TRAIN_LOSS_CHUNK, AdamW at lr
# TRAIN_LR after TRAIN_WARMUP warmup steps: TRAIN_WARM untimed steps, then
# TRAIN_TIMED timed ones, then one profiled; then one step from a saved
# state with remat on and one from the same state with remat off (a dense
# model's step repeats the same products with or without the recomputation,
# so the loss, grad_norm and the first moments, which hold the clipped
# gradients, are bitwise equal). Each family of TRAIN_FAMILIES at its reduced
# config: one bf16 step on the card against the same step on the CPU, same
# weights and batch (TRAIN_CPU_BATCH x TRAIN_CPU_SEQ, loss chunk
# TRAIN_CPU_CHUNK, lr 1e-2 after one warmup step), loss, ce and moe_aux
# within TRAIN_CPU_RTOL and grad_norm within TRAIN_CPU_GNORM_RTOL (the
# bounds of the CPU parity tests against the reference,
# tests/test_torch_training_families.py); TRAIN_CKPT_ARCH's stepped params
# saved from the card and loaded on the CPU, bitwise
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LOSS_CHUNK = "tinyllama-1.1b", 8, 512, 512
TRAIN_LR, TRAIN_WARMUP, TRAIN_WARM, TRAIN_TIMED = 3e-4, 2, 2, 6
TRAIN_FAMILIES = ("tinyllama-1.1b", "internvl2-76b", "olmoe-1b-7b", "starcoder2-3b",
                  "granite-3-2b", "zamba2-7b", "xlstm-125m", "whisper-small")
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, TRAIN_CPU_CHUNK = 2, 32, 16
TRAIN_CPU_RTOL, TRAIN_CPU_GNORM_RTOL, TRAIN_CKPT_ARCH = 5e-3, 2e-2, "granite-3-2b"


# phase 15: sharded serving on the one-rank mesh, MESH_ARCH at full width
# and depth
MESH_ARCH, GATHER_REPS = "tinyllama-1.1b", 20
# (c): slot mode with paged KV, MESH_PAGED_TOKENS decode tokens over two
# requests of MESH_PAGED_PROMPT tokens, MESH_PAGE_TOKENS a page
MESH_PAGED_TOKENS, MESH_PAGED_PROMPT, MESH_PAGE_TOKENS = 8, 20, 16

# phase 16: training on the one-rank (data, model) mesh. MESH_TRAIN_ARCH at
# full width and depth, FSDP rules, batch TRAIN_BATCH x TRAIN_SEQ with
# remat: MESH_TRAIN_STEPS steps on the mesh and as many unsharded, from
# the same seed and batches, each metric within METRIC_RTOL of the
# unsharded step's (the bounds of tests/test_torch_training_families.py);
# MESH_MOE_ARCH at full width and MESH_MOE_LAYERS of its layers with the
# expert-parallel dispatch (``optimized_for(1)``), batch MESH_MOE_BATCH x
# TRAIN_SEQ, one step at capacity factor 8.0 held to the gather dispatch's
# and one at the config's own; StarCoder2-7B's attention shape
# (SEQ_ATTN_SHAPE, bf16, causal) through the sequence-sharded attention
# against the blockwise one at offset 0
MESH_TRAIN_ARCH, MESH_TRAIN_STEPS = "tinyllama-1.1b", 3
MESH_MOE_ARCH, MESH_MOE_LAYERS, MESH_MOE_BATCH = "olmoe-1b-7b", 2, 4
SEQ_ATTN_SHAPE = (1, 4096, 36, 128)

# phase 17: the dry run. DRYRUN_PAIRS (arch, shape, layers) on the fake
# production (16, 16) mesh, depth cut for the script's time limit (the
# whole models' reports: `--all`, PERF.md), among them a prefill whose
# cache each rank makes as its block (its output bytes a rank held to the
# cache's blocks plus the logits), an attention whose 40 heads the model
# axis does not divide (each model rank's query rows) and the mLSTM scan
# split over 'model'; phase 14's step whole on a fake 1×1 mesh, its
# predicted peak memory within DRYRUN_PEAK_RATIO of phase 14's measured
# one. The subprocess starts after the build and runs beside phases 3-18,
# on one CPU thread at a lower priority (fake tensors: it never touches
# the card)
DRYRUN_PAIRS = (("tinyllama-1.1b", "train_4k", 6), ("internvl2-76b", "decode_32k", 40),
                ("xlstm-125m", "train_4k", 4), ("olmoe-1b-7b", "train_4k", 4),
                ("olmoe-1b-7b", "prefill_32k", 1), ("llama4-scout-17b-a16e", "train_4k", 1),
                ("xlstm-125m", "prefill_32k", 4))
# the ranks over which each prefill pair's cache divides, from its shapes
# alone: OLMoE's (L, b, S, kv, hd) K and V with the batch's 32 rows over
# 'data' (16) and the 16 kv heads over 'model' (16); xLSTM-125M's states
# with the batch over 'data' and whole over 'model' (its 4 heads do not
# divide 16; the sLSTM's (b, d) state stays whole over 'model', as the
# reference's cache_axes lay it out, though its scan splits the gates'
# columns over 'model')
DRYRUN_CACHE_RANKS = {("olmoe-1b-7b", "prefill_32k"): 256, ("xlstm-125m", "prefill_32k"): 16}
# the reference's own FLOPs a device for a pair (its dry run's
# trip-count-corrected ``analyze_hlo`` count of the compiled step on its
# (16, 16) mesh, at the pair's layers), and the relative gap allowed. From
#   XLA_FLAGS=--xla_force_host_platform_device_count=512 JAX_PLATFORMS=cpu
#   python: build_step("xlstm-125m", "prefill_32k", mesh, rules) of
#   repro.launch.dryrun with get_config's n_layers replaced by 4, jitted
#   with its in_shardings on jax.make_mesh((16, 16), ("data", "model"),
#   axis_types=(AxisType.Auto,) * 2), lowered, compiled, analyze_hlo(hlo)
#   ["flops"] (jax 0.9.0 on the CPU; 12 layers give 9.93657053184e11, the
#   reference's --all figure)
DRYRUN_REF_FLOPS = {("xlstm-125m", "prefill_32k", 4): 312921513984.0}
DRYRUN_REF_RTOL = 0.005
DRYRUN_PEAK_RATIO = (0.8, 1.25)
DRYRUN_CODE = r"""
import dataclasses, json, math, os, sys
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import run_dryrun
from repro_torch.launch.mesh import make_dry_mesh, production_shape

from repro_torch.configs.shapes import get_shape
from repro_torch.models import build_model
from repro_torch.models.common import Leaf, tree_leaves
from repro_torch.sharding import MeshRules

# beside the card's phases: one thread, a lower priority
torch.set_num_threads(1)
os.nice(10)

# the sLSTM scans' FLOPs a rank, counted apart (the dry run's counter)
from repro_torch.models import scan, xlstm
slstm_flops, slstm_region = [0], xlstm._slstm_region


def counted_region(chunk):
    run = slstm_region(chunk)

    def go(*args):
        with scan.chunk_counter().measured() as delta:
            out = run(*args)
        slstm_flops[0] += delta["flops"]
        return out

    return go


xlstm._slstm_region = counted_region


def cache_bytes(cfg, shape, rules):
    # the bytes of the pair's whole cache, and of one rank's blocks of it
    # (its leaves' whole shapes over the ranks their placements divide
    # them over)
    model = build_model(cfg)
    axes, whole, blocks = dict(tree_leaves(model.cache_axes())), 0, 0
    for path, leaf in tree_leaves(model.cache_layout(shape.global_batch, shape.seq_len)):
        pairs = zip(leaf, axes[path]) if isinstance(leaf, tuple) else [(leaf, axes[path])]
        for lf, ax in pairs:
            if isinstance(lf, Leaf):
                block = rules.block_shape(lf.shape, rules.placements(ax, lf.shape))
                whole += math.prod(lf.shape) * lf.dtype.itemsize
                blocks += math.prod(block) * lf.dtype.itemsize
    return whole, blocks


pairs, steps = json.loads(sys.argv[1]), json.loads(sys.argv[2])
mesh = make_dry_mesh(*production_shape(False), device_type="cuda")
for arch, shape, layers in pairs:
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    slstm_flops[0] = 0
    rep = run_dryrun(cfg, shape, mesh=mesh, verbose=False)
    rep["slstm_flops"] = slstm_flops[0]
    if get_shape(shape).kind == "prefill":
        rules = MeshRules.for_mesh(mesh, fsdp=cfg.fsdp)
        rep["cache_whole_bytes"], rep["cache_block_bytes"] = cache_bytes(cfg, get_shape(shape),
                                                                         rules)
        rep["logits_bound_bytes"] = (get_shape(shape).global_batch
                                     // rules.axis_size(rules.rules["batch"])) * cfg.vocab_size * 4
    print("DRYRUN " + json.dumps({**rep, "n_layers": layers}), flush=True)
dist.destroy_process_group()
mesh = make_dry_mesh((1, 1), ("data", "model"), device_type="cuda")
for step in steps:
    shape = InputShape("real_step", step["seq"], step["batch"], "train")
    cfg = get_config(step["arch"].removesuffix("-reduced"))  # a CPU rehearsal's reduced step
    cfg = cfg.reduced() if step["arch"].endswith("-reduced") else cfg
    cfg = dataclasses.replace(cfg, n_layers=step["layers"],
                              slstm_layers=tuple(step["slstm_layers"]))
    print("DRYRUN " + json.dumps(run_dryrun(cfg, shape, mesh=mesh, verbose=False)), flush=True)
"""

# phase 18: xLSTM training at the scans' chunk grain. XLSTM_TRAIN_ARCH at
# full width, XLSTM_TRAIN_LAYERS blocks of which XLSTM_TRAIN_SLSTM are
# sLSTM (one of each kind: a step is a host loop over the sequence's steps
# in every block, about 6.6 s a block at 2 x 4096 on an H100, so the
# config's 12 blocks do not fit the script's time), random weights from
# seed 0, remat on (which xLSTM ignores: it rematerialises per chunk), AdamW
# as in phase 14: one step at XLSTM_TRAIN_BATCH x XLSTM_TRAIN_SEQ with the
# config's chunk (64), timed, its peak memory from its start; one step at
# XLSTM_CHECK_BATCH x XLSTM_CHECK_SEQ at chunk 64 under FlopCounterMode and
# one with a single chunk as long as the sequence, both from the seed-0
# state. Phase 17's dry run predicts the two chunk-64 steps
XLSTM_TRAIN_ARCH, XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_SLSTM = "xlstm-125m", 2, (1,)
XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ = 2, 4096
XLSTM_CHECK_BATCH, XLSTM_CHECK_SEQ = 2, 1024
METRIC_RTOL = {"loss": 5e-3, "ce": 5e-3, "moe_aux": 5e-3, "grad_norm": 2e-2}


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


def decode_timings(eng, wbits, randn, cuda_ms, host_ms, card, tag, batch=BATCH):
    """Each decode kernel of one served engine, over that engine's own
    tables, weights and last refresh input: K1 (in all and per site q, k,
    v, o — and fc, proj in the gelu family, whose MLP is two K1 calls —
    beside the dense library product), K2 and its phase 1 alone (the
    SwiGLU family), K5 over one refresh step's lanes with what each lane's
    walk meets. Device time per launch from CUDA-graph replays, the plain
    versions on the host clock, the bound from the bytes and flops of the
    call; ``batch`` rows of activations a call (the served batch). Returns
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
    gelu_family = cfg.mlp == "gelu"
    k1_spec = (("wq", "hidden_attn", d), ("wk", "hidden_attn", d), ("wv", "hidden_attn", d),
               ("wo", "attn_out", hd_all))
    if gelu_family:
        k1_spec += (("w_fc", "hidden_mlp", d), ("w_proj", "ffn", f))
    for layer in range(n_layers):
        for name, site, n_in in k1_spec:
            w = lp[name][layer] if wbits == 16 else lp[name + "_q8"][layer]
            sc = None if wbits == 16 else lp[name + "_sc"][layer]
            s, z = sp.kernel_tables(plan, site, layer)
            xm = randn(batch, n_in) * plan[site]["mask"][layer]
            k1_calls.append((w, xm, s, z, sc))
            rows = rows_of(z)
            byts = (rows * w.shape[1] * el + (rows // 8 * 4 if sc is not None else 0)
                    + batch * n_in * 4 + 2 * 4 * s.numel() + batch * w.shape[1] * 4)
            ops = 2.0 * batch * rows * w.shape[1]
            k1_bytes, k1_ops = k1_bytes + byts, k1_ops + ops
            k1_bound += max(byts / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
            k1_sites.append(name)
            k1_bounds.append(max(byts / HBM_BYTES_PER_S, ops / F32_OPS_PER_S))
        if gelu_family or cfg.has_moe:  # no K2: the MLP is K1's, or a MoE layer's
            continue
        ws = [lp[n][layer] if wbits == 16 else lp[n + "_q8"][layer]
              for n in ("w_gate", "w_up", "w_down")]
        scs = None if wbits == 16 else tuple(lp[n + "_sc"][layer]
                                             for n in ("w_gate", "w_up", "w_down"))
        st, sz = sp.mlp_kernel_plan(plan, layer)
        fm = plan["ffn"]["mask"][layer]
        xm = randn(batch, d) * plan["hidden_mlp"]["mask"][layer]
        k2_calls.append((*ws, xm, st, sz, fm, scs))
        rh, rf = rows_of(sz[0]), rows_of(sz[1])
        byts = (2 * rh * f * el + rf * d * el
                + ((2 * rh + rf) // 8 * 4 if scs is not None else 0)
                + batch * d * 4 + f * 4 + 2 * 2 * 4 * st.shape[1]
                + batch * f * 4 + batch * d * 4)
        ops = 2.0 * batch * (2 * rh * f + rf * d)
        k2_bytes, k2_ops = k2_bytes + byts, k2_ops + ops
        k2_bound += max(byts / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
        # K2's phase 1 alone: gate and up in, h out
        byts = (2 * rh * f * el + (2 * rh // 8 * 4 if scs is not None else 0)
                + batch * d * 4 + 2 * 4 * st.shape[1] + batch * f * 4)
        ops = 2.0 * batch * 2 * rh * f
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
        "greedy_select": {
            "ms": cuda_ms(run_k5, 5) / n5, "plain_ms": t_k5_plain, "library_ms": None,
            "bound_ms": k5_bound * 1e3, "bound_by": "bytes", "calls": n5, "lanes": lanes,
            "walked_per_lane": sum(walked) / max(len(walked), 1), "per_lane": k5_lanes},
    }
    if n2:
        timing["chunk_gather_mlp_dma"] = {
            "ms": cuda_ms(run_k2, 20) / n2, "plain_ms": host_ms(lambda: run_k2(True)) / n2,
            "library_ms": None, "bound_ms": k2_bound / n2 * 1e3,
            "bound_by": "bytes" if k2_bytes / HBM_BYTES_PER_S >= k2_ops / F32_OPS_PER_S
            else "operations",
            "calls": n2, "bytes_per_call": k2_bytes / n2}
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
    dry = start_dryrun(dry_steps())  # phase 17's subprocess, on the host's CPU meanwhile
    kernels = run(dev, get_config("tinyllama-1.1b"), card, report, get_config(VLM_ARCH),
                  [get_config(arch) for arch, _ in DENSE_ARCHS])
    done("phases 3-6")  # phase 4-6's engines and weights go before phase 7's
    kernels += vlm_path(dev, get_config(VLM_ARCH), card, report)
    done("phase 7")
    slim = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=SLIM_LAYERS)
    kernels += cache_path(dev, slim, card, report)
    done("phase 8, TinyLlama cache")
    vcfg, vmodel, vparams = vlm_model(dev, get_config(VLM_ARCH))
    vlm_cache(dev, vcfg, vmodel, vparams, card, report)
    done("phase 8, InternVL2 cache")
    long_prompt(dev, vcfg, vmodel, vparams, card, report)
    done("phase 8, long prompt")
    vlm_integrity(dev, vcfg, vmodel, vparams, card, report)
    done("phase 9, InternVL2 integrity")
    vlm_slots(dev, vcfg, vmodel, vparams, card, report)
    del vparams
    done("phase 10, InternVL2 slots")
    robust_path(dev, slim, card, report)
    done("phase 9, TinyLlama faults and integrity")
    kernels += lane_rows(report)
    kernels += slot_path(dev, get_config("tinyllama-1.1b"), card, report)
    done("phase 10, TinyLlama continuous batching")
    for arch, n_layers in DENSE_ARCHS:
        model, params, rows = dense_path(dev, dataclasses.replace(get_config(arch),
                                                                  n_layers=n_layers),
                                         card, report)
        kernels += rows
        done(f"phase 11, {arch}")
        if arch == WINDOW_ARCH:
            window_path(dev, model, params, card, report)
            done(f"phase 11, {arch} rotating window")
        del model, params
    for arch, n_layers in MOE_ARCHS:
        kernels += moe_path(dev, get_config(arch), n_layers, card, report)
        done(f"phase 12, {arch}")
    for arch in FAMILY_ARCHS:
        kernels += family_path(dev, get_config(arch), card, report)
        done(f"phase 13, {arch}")
    train_path(dev, card, report)
    done("phase 14, training")
    train_families(dev, card, report)
    done("phase 14, families card vs CPU, checkpoint")
    mesh_path(dev, get_config(MESH_ARCH), card, report)
    done("phase 15, sharded serving")
    mesh_train_path(dev, card, report)
    done("phase 16, mesh training")
    xlstm_train_path(dev, card, report)
    done("phase 18, xLSTM training")
    dryrun_path(card, report, dry)
    done("phase 17, dry run")
    (OUT / "chip_smoke_report.json").write_text(json.dumps(report, indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def profile_decode(eng, token, card):
    """A profiled decode call of PROFILE_TOKENS steps (``profile_call``)."""
    return profile_call(lambda: eng.decode(token, PROFILE_TOKENS),
                        f"{PROFILE_TOKENS} steps", card)


def profiled(fn):
    """``fn()`` (ending in a host sync) under ``torch.profiler``: (wall µs,
    {device event: µs}, {host op: (self µs, count)}). The device's own
    events (kernels, copies) are each counted once: an aten op's device
    time is its kernels', listed under them. A user annotation's device
    range (NCCL names each collective's so) spans the kernels and copies
    inside it, gaps included, and is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, cpu_ops = {}, {}
    for ev in prof.key_averages():
        if getattr(ev, "is_user_annotation", False):
            continue
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us
        elif ev.self_cpu_time_total > 0:
            cpu_ops[ev.key] = (ev.self_cpu_time_total, ev.count)
    return wall_us, kernels, cpu_ops


def profile_call(fn, what, card):
    """A profiled ``fn()`` (it ends in a host sync): device time by kernel,
    the device's busy share of the call's wall, and the host ops that take
    the most time. The profiler's own overhead inflates the wall, so the
    shares are of the profiled call."""
    wall_us, kernels, cpu_ops = profiled(fn)
    busy = sum(kernels.values())
    if busy == 0:
        log("[profile] the profiler recorded no device time")
        return {"wall_us": wall_us}
    out = {"wall_us": wall_us, "device_busy_us": busy, "device_busy_share": busy / wall_us,
           "device_us": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15]),
           "host_ops": dict(sorted(cpu_ops.items(), key=lambda kv: -kv[1][0])[:15]),
           # the host's kernel launches (cudaLaunchKernel and its variants)
           "launch_calls": sum(n for k, (_, n) in cpu_ops.items() if "LaunchKernel" in k)}
    ours = {name: sum(v for k, v in kernels.items() if name in k)
            for name in ("k1_kernel", "k2_gate_up_kernel", "k5_kernel")}
    log(f"[profile] {what}, wall {wall_us / 1e3:.1f} ms (profiled): device busy "
        f"{busy / wall_us:.1%}, idle {1 - busy / wall_us:.1%}; "
        + ", ".join(f"{k} {v / wall_us:.1%}" for k, v in ours.items())
        + f"; other device work {(busy - sum(ours.values())) / wall_us:.1%}  ({card})")
    top = sorted(cpu_ops.items(), key=lambda kv: -kv[1][0])[:8]
    log("[profile] host self time: " + ", ".join(
        f"{k} {v[0] / 1e3:.1f} ms/{v[1]}" for k, v in top))
    return out


def run(dev, cfg, card, report, vcfg, dcfgs=()):
    """Phases 3-6 on ``dev`` for ``cfg`` (phase 3 also at the widths of the
    VLM config ``vcfg`` and of the dense configs ``dcfgs``); returns the
    kernel table. On a CPU device (a
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
    dense_width_checks(dev, dcfgs, randn, check, failures)

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
    depth at CACHE_FRACS of ``sparsifiable_bytes``, wbits 16 and 8,
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



def chat_requests(cfg, n, new_tokens, deadline=None, seed=0):
    """Phase 10's chat service: ``make_request(rid)`` for the arrival
    driver. Each prompt is one of SYSTEMS seeded system prompts of
    SYSTEM_TOKENS tokens, then USER_TOKENS tokens of its own, on the host
    (the pool hashes it there); ``new_tokens`` new tokens, ``deadline``
    seconds of SLO."""
    import numpy as np
    import torch

    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, cfg.vocab_size, SYSTEM_TOKENS) for _ in range(SYSTEMS)]
    picks = rng.integers(0, SYSTEMS, n)
    own = [rng.integers(0, cfg.vocab_size, USER_TOKENS) for _ in range(n)]

    def make(rid):
        toks = np.concatenate([systems[picks[rid]], own[rid]])[None]
        return Request(rid=rid, prompt={"tokens": torch.from_numpy(toks)},
                       max_new_tokens=new_tokens, deadline_s=deadline)

    return make


def count_syncs(fn):
    """(fn(), the synchronizing CUDA operations it ran, as ``file:line``
    of their Python callers) under ``torch.cuda.set_sync_debug_mode``."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]


def slot_run(model, params, dev, make_request, n_requests, slots, rate, paged=True,
             backend="kernel", wbits=16, kv_pages=None, noise=None, probe=None, card="",
             **kw):
    """One continuous-batching run through the user's entry points:
    ``Scheduler(ServeEngine(...)).run()`` over Poisson arrivals (driver seed
    1), chunk at sparsity 0.4, ``nano``, max_seq SLOT_MAX_SEQ, rounds of
    ROUND_TOKENS; ``kw`` goes to the engine, ``noise`` (if given) to its
    simulator before the run. With ``probe`` (on the card), round
    ``probe`` is profiled and every other round's synchronizing operations
    are counted. Returns {eng, stats, tokens {rid: [...]}, rounds,
    round_wall_s, steps, profile, syncs: [[file:line, ...] a round]}."""
    import torch

    from repro_torch.serving import PoissonArrivalDriver, Scheduler, ServeEngine

    eng = ServeEngine(model, params, max_seq=SLOT_MAX_SEQ, batch_size=slots, device="nano",
                      sparsity=0.4, method="chunk", backend=backend, wbits=wbits,
                      torch_device=dev, kv_page_tokens=PAGE_TOKENS if paged else None,
                      kv_pages=kv_pages, **kw)
    if noise is not None:
        eng.simulator.noise = noise
    sched = Scheduler(eng, round_tokens=ROUND_TOKENS)
    sched.submit(PoissonArrivalDriver(rate, make_request, seed=1).generate(n_requests))
    walls, out = [], {"profile": None, "syncs": []}
    more = True
    while more:
        t0 = time.perf_counter()
        if probe is not None and len(walls) == probe:
            box = []
            out["profile"] = profile_call(lambda: box.append(sched.step()),
                                          f"one round of {slots} slots", card)
            more = box[0]
        elif probe is not None:
            more, syncs = count_syncs(sched.step)
            out["syncs"].append(syncs)
        else:
            more = sched.step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if len(walls) > 10_000:
            fail("phase 10: the scheduler did not drain")
    stats = sched.stats()
    return {**out, "eng": eng, "stats": stats, "rounds": len(walls), "round_wall_s": walls,
            "steps": sum(s.kind == "decode" for s in eng.stats),
            "tokens": {r.rid: list(r.tokens_out) for r in sched.finished}}


def check_drained(tag, run, n_requests, new_tokens, paged=True):
    """Every request finished with its tokens; the pool (paged) passes its
    check with no live page."""
    st = run["stats"]
    if st.finished != n_requests or sorted(run["tokens"]) != list(range(n_requests)) \
            or any(len(t) != new_tokens for t in run["tokens"].values()):
        fail(f"{tag}: {st.finished} of {n_requests} requests drained, tokens "
             f"{ {k: len(v) for k, v in run['tokens'].items()} }")
    if paged:
        pool = run["eng"].kv_pool
        try:
            pool.check()
        except AssertionError as e:
            fail(f"{tag}: the page pool's check failed: {e}")
        if not pool.steady_state():
            fail(f"{tag}: {pool.pages_in_use} pages still live after the drain")


def stats_equal(a, b):
    """Two ``SchedulerStats`` field for field, NaN equal to NaN."""
    import math

    return all(x == y or (isinstance(x, float) and math.isnan(x) and math.isnan(y))
               for x, y in zip(vars(a).values(), vars(b).values()))


def stats_line(st):
    return (f"{st.finished} requests, {st.decode_tokens} tokens, simulated "
            f"{st.tokens_per_s:.3f} tokens/s, TTFT p50 {st.ttft_p50_s:.3f} s, latency p50 "
            f"{st.latency_p50_s:.3f} p99 {st.latency_p99_s:.3f} s, SLO "
            f"{st.slo_attainment:.3f}, preempted {st.preempted}, admitted in stalls "
            f"{st.admitted_during_stall}")


def slot_path(dev, cfg, card, report):
    """Phase 10a/b on ``cfg`` at full width and depth: continuous batching
    through ``Scheduler(ServeEngine(...)).run()`` — SLOTS slots, paged KV
    of PAGE_TOKENS-token pages, SLOT_REQUESTS chat requests sharing SYSTEMS
    system prompts, arriving at ARRIVAL_RATE/s on the simulated clock.

    10a: the main path (paged, wbits 16, kernel backend) with the launch
    counts set to 0 just before and read just after (K1 4·L and K2 L a
    decode step, K5 once a refresh step, + the selection timing's); then
    the reference backend, the dense KV cache and a replay (the same tokens
    request by request, the same ``SchedulerStats``), the replay with one
    profiled round and one round under the sync debug mode; wbits 8 (exact
    counts); after each drain the pool's check, no live page, shared hits.
    On the main run's own tables, K1 and K2 at SLOT_TIMING_BATCHES rows,
    bitwise against their plain versions and timed. 10b: a pool of
    PRESSURE_PAGES pages (page-pressure preemption), and ``thermal_throttle``
    with deadlines, without and with the degradation controller (noise 0):
    each drains and replays exactly. Returns the kernel rows "K1, slots"
    and "K2, slots"."""
    import torch

    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.models import build_model

    on_card = dev.type == "cuda"
    n_layers = cfg.n_layers
    t_phase = time.perf_counter()
    log(f"[slots] {cfg.name}: L={n_layers}, {SLOTS} slots, max_seq {SLOT_MAX_SEQ}, pages of "
        f"{PAGE_TOKENS} tokens, rounds of {ROUND_TOKENS}; {SLOT_REQUESTS} requests at "
        f"{ARRIVAL_RATE:g}/s of {SYSTEM_TOKENS} system ({SYSTEMS} prompts) + {USER_TOKENS} own "
        f"tokens, {SLOT_NEW} new tokens each; chunk at sparsity 0.4, nano")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    make = chat_requests(cfg, SLOT_REQUESTS, SLOT_NEW)
    counters = (cg.LAUNCHES, chunking.LAUNCHES)

    def zero():
        for c in counters:
            for k in c:
                c[k] = 0

    def want(steps):
        return {"chunk_gather_matmul_dma": 4 * n_layers * steps,
                "chunk_gather_mlp_dma": n_layers * steps,
                "greedy_select": steps + TIME_SELECTION_LAUNCHES}

    def same(tag, a, b, stats=True):
        if a["tokens"] != b["tokens"]:
            bad = [k for k in a["tokens"] if a["tokens"][k] != b["tokens"].get(k)]
            fail(f"{tag}: tokens differ at requests {bad}")
        if stats and not stats_equal(a["stats"], b["stats"]):
            fail(f"{tag}: SchedulerStats differ: {a['stats']} != {b['stats']}")

    def run(tag, **kw):
        kw.setdefault("slots", SLOTS)
        kw.setdefault("rate", ARRIVAL_RATE)
        n = kw.pop("n", SLOT_REQUESTS)
        t0 = time.perf_counter()
        r = slot_run(model, params, dev, kw.pop("make", make), n, **kw)
        r["wall_s"] = time.perf_counter() - t0
        io = r["eng"].io_summary()
        pool = r["eng"].kv_pool
        log(f"[slots] {tag}: {stats_line(r['stats'])}; {r['rounds']} rounds, {r['steps']} "
            f"decode steps in {r['wall_s']:.2f} s"
            + ("" if pool is None else f"; pool {pool.summary()}")
            + f"; bubble_utilization {io['bubble_utilization']:.3f}")
        return r

    out = {}
    # -- 10a: the main path, launches counted from 0
    if on_card:
        torch.cuda.synchronize()
    zero()
    main = run("paged w16 kernel (main path)")
    launches = {**cg.LAUNCHES, **chunking.LAUNCHES}
    check_drained("main", main, SLOT_REQUESTS, SLOT_NEW)
    if on_card and launches != want(main["steps"]):
        fail(f"slots: launch counts {launches} != per-step counts {want(main['steps'])}")
    if main["eng"].kv_pool.alloc.shared_hits == 0:
        fail("slots: no prompt page was shared")
    eng = main["eng"]
    dec = [s for s in eng.stats if s.kind == "decode"]
    io = eng.io_summary()
    st = main["stats"]
    out["main"] = {
        "launches": launches, "steps": main["steps"], "rounds": main["rounds"],
        "wall_s": main["wall_s"], "wall_per_round_s": sum(main["round_wall_s"]) / main["rounds"],
        "decode_wall_per_step_s": sum(s.wall_s for s in dec) / len(dec),
        "stats": vars(st), "pool": eng.kv_pool.summary(),
        "admitted_during_stall": io["admitted_during_stall"],
        "bubble_utilization": io["bubble_utilization"], "kv_cache_mb": io["kv_cache_mb"]}
    log(f"[slots] main path: launches {launches} over {main['steps']} decode steps (exact); "
        f"wall {out['main']['wall_per_round_s'] * 1e3:.1f} ms a round, "
        f"{out['main']['decode_wall_per_step_s'] * 1e3:.2f} ms a decode step of {SLOTS} slots; "
        f"simulated {st.tokens_per_s:.3f} tokens/s, TTFT p50 {st.ttft_p50_s:.3f} s, latency "
        f"p50 {st.latency_p50_s:.3f} s p99 {st.latency_p99_s:.3f} s; admitted_during_stall "
        f"{io['admitted_during_stall']}, bubble_utilization {io['bubble_utilization']:.3f}  "
        f"({card})")

    # -- K1/K2 at the slot batches, on the main run's own tables
    randn, _ = seeded(dev, 2024)
    cuda_ms, host_ms = timers(on_card)
    check = Checks(("chunk_gather_matmul_dma", "chunk_gather_mlp_dma"))
    timing = {}
    for b in SLOT_TIMING_BATCHES:
        timing[b], calls = decode_timings(eng, 16, randn, cuda_ms, host_ms, card,
                                          f"[slots] batch {b}", batch=b)
        for i, (name, (w, xm, s, z, sc)) in enumerate(zip(calls["k1_sites"], calls["k1"])):
            check("chunk_gather_matmul_dma", f"b{b} L{i // 4} {name}",
                  cg.chunk_gather_matmul_dma(w, xm, s, z, sc),
                  cg.chunk_gather_matmul_plain(w, xm, s, z, sc))
        for layer, (wg, wu, wd, xm, s, z, fm, scs) in enumerate(calls["k2"]):
            yk, hk = cg.chunk_gather_mlp_dma(wg, wu, wd, xm, s, z, fm, scs, return_h=True)
            yp, hp = cg.chunk_gather_mlp_plain(wg, wu, wd, xm, s, z, fm, scs)
            check("chunk_gather_mlp_dma", f"b{b} L{layer} y", yk, yp)
            check("chunk_gather_mlp_dma", f"b{b} L{layer} h", hk, hp)
        del calls
        for k in ("chunk_gather_matmul_dma", "chunk_gather_mlp_dma"):
            v = timing[b][k]
            lib = "n/a" if v["library_ms"] is None else f"{v['library_ms'] * 1e3:.1f} us"
            log(f"[slots] batch {b} {k}: {v['ms'] * 1e3:.1f} us/launch  plain "
                f"{v['plain_ms'] * 1e3:.1f} us  library {lib}  bound {v['bound_ms'] * 1e3:.2f} "
                f"us ({v['bound_by']})  ({card})")
    if check.failures:
        for msg in check.failures:
            log(f"[slots] {msg}")
        fail(f"{len(check.failures)} phase-10 kernel checks failed")
    log(f"[slots] bitwise: {check.n} checks (K1 at every site and K2 at every layer, batches "
        f"{SLOT_TIMING_BATCHES}), max abs err "
        + ", ".join(f"{k} {v:.1e}" for k, v in check.errs.items()))
    out["timing"] = timing
    u = sum(s.overlap_s for s in dec) / len(dec)  # the clean charged decode step
    del eng, dec
    main["eng"] = None

    # -- the same settings on the reference backend, the dense cache, a replay
    ref = run("paged w16 reference backend", backend="reference")
    same("reference backend", main, ref)
    check_drained("reference", ref, SLOT_REQUESTS, SLOT_NEW)
    del ref
    dense = run("dense w16 kernel", paged=False)
    same("dense KV", main, dense)
    check_drained("dense", dense, SLOT_REQUESTS, SLOT_NEW, paged=False)
    del dense
    replay = run("paged w16 kernel, replay", probe=2 if on_card else None, card=card)
    same("replay", main, replay)
    check_drained("replay", replay, SLOT_REQUESTS, SLOT_NEW)
    out["profile_round"] = replay["profile"]
    out["syncs_per_round"] = replay["syncs"]
    if on_card:
        counts = [len(x) for x in replay["syncs"]]
        sites = sorted({f for x in replay["syncs"] for f in x})
        log(f"[slots] synchronizing operations a round under the sync debug mode (every "
            f"round but the profiled one): {counts}; at {', '.join(sites)}")
    del replay
    zero()
    w8 = run("paged w8 kernel", wbits=8)
    launches8 = {**cg.LAUNCHES, **chunking.LAUNCHES}
    check_drained("w8", w8, SLOT_REQUESTS, SLOT_NEW)
    if on_card and launches8 != want(w8["steps"]):
        fail(f"slots w8: launch counts {launches8} != per-step counts {want(w8['steps'])}")
    out["w8"] = {"launches": launches8, "stats": vars(w8["stats"])}
    del w8

    # -- 10b: page pressure
    pressure = [run(f"page pressure ({PRESSURE_PAGES} pages), run {i}",
                    kv_pages=PRESSURE_PAGES) for i in (1, 2)]
    for i, r in enumerate(pressure):
        check_drained(f"page pressure {i}", r, SLOT_REQUESTS, SLOT_NEW)
    if pressure[0]["stats"].preempted < 1:
        fail("page pressure: no preemption")
    same("page-pressure replay", pressure[0], pressure[1])
    out["pressure"] = {"stats": vars(pressure[0]["stats"]),
                       "pool": pressure[0]["eng"].kv_pool.summary()}
    del pressure

    # -- 10b: deadlines under a sustained throttle, the controller off and on
    # (the arrival gap and the deadline in clean decode steps: the first
    # deadline whose controller-off run preempts is kept)
    rate = 1.0 / (DEADLINE_GAP_STEPS * u)
    kw = dict(rate=rate, fault_profile="thermal_throttle", fault_seed=FAULT_SEED, noise=0.0)
    for steps in DEADLINE_STEPS:
        deadline = steps * u
        kw["make"] = chat_requests(cfg, SLOT_REQUESTS, SLOT_NEW, deadline=deadline)
        tag = f"thermal_throttle, deadline {deadline:.3f} s ({steps:g} steps), rate {rate:.3f}/s"
        off = run(f"{tag}, degrade off", **kw)
        if off["stats"].preempted >= 1:
            break
        log(f"[slots] {tag}: no preemption; the next deadline")
    else:
        fail(f"deadlines: no preemption at any of {DEADLINE_STEPS} clean steps")
    dl_runs = {False: [off], True: []}
    for degrade in (True, False):
        r = run(f"deadline {deadline:.3f} s, degrade {'on' if degrade else 'off'}",
                degrade=degrade, **kw)
        dl_runs[degrade].append(r)
    for degrade, rs in dl_runs.items():
        for r in rs:
            check_drained(f"deadline, degrade {degrade}", r, SLOT_REQUESTS, SLOT_NEW)
    same("deadline replay", dl_runs[False][0], dl_runs[False][1])
    off_s, on_s = dl_runs[False][0]["stats"], dl_runs[True][0]["stats"]
    out["deadlines"] = {"deadline_s": deadline, "rate": rate, "step_s": u,
                        "off": vars(off_s), "on": vars(on_s),
                        "on_scale": dl_runs[True][0]["eng"].fault_summary()["degrade_scale"]}
    log(f"[slots] deadlines (thermal_throttle, seed {FAULT_SEED}, noise 0): SLO attainment "
        f"off {off_s.slo_attainment:.3f} on {on_s.slo_attainment:.3f}; p99 off "
        f"{off_s.latency_p99_s:.3f} s on {on_s.latency_p99_s:.3f} s; preempted off "
        f"{off_s.preempted} on {on_s.preempted}; controller scale "
        f"{out['deadlines']['on_scale']:.2f}")
    del dl_runs, off
    out["phase_s"] = time.perf_counter() - t_phase
    report["slots"] = out
    rows = []
    for name, line in (("chunk_gather_matmul_dma", 284), ("chunk_gather_mlp_dma", 617)):
        t = timing[SLOTS][name]
        rows.append({"name": f"{name}, slots [{cfg.name}, batch {SLOTS}]", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/chunk_gather.cu",
                     "replaces": f"src/repro/kernels/chunk_gather_dma.py:{line}",
                     "launches": launches[name], "max_abs_err": check.errs[name],
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "ms_batch_16": timing[16][name]["ms"],
                     "bound_ms_batch_16": timing[16][name]["bound_ms"],
                     "library_ms_batch_16": timing[16][name]["library_ms"]})
    return rows


def vlm_slots(dev, cfg, model, params, card, report):
    """Phase 10c on the VLM at full width (``params``: phase 8/9's, depth cut
    to VLM_LAYERS): VLM_SLOTS slots, paged KV of PAGE_TOKENS-token pages,
    VLM_REQUESTS requests of VLM_PROMPT // 2 vision + VLM_PROMPT // 2 text
    tokens at ARRIVAL_RATE/s (requests 1 and 2 the same image and text, so
    their pages are shared), VLM_SLOT_NEW new tokens: the kernel backend
    with the launch counts from 0 (exact; K2's phase 1 runs at batch
    VLM_SLOTS), against the reference backend (the same tokens)."""
    import numpy as np
    import torch

    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.models.inputs import FRONT_DTYPE
    from repro_torch.serving import Request

    on_card = dev.type == "cuda"
    n_layers = cfg.n_layers
    n_vis = VLM_PROMPT // 2
    rng = np.random.default_rng(0)
    prompts = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n_vis))),
                "frontend": torch.from_numpy(rng.normal(0, 1, (1, n_vis, cfg.d_frontend)))
                .to(FRONT_DTYPE)} for _ in range(VLM_REQUESTS)]
    prompts[2] = prompts[1]

    def make(rid):
        return Request(rid=rid, prompt=prompts[rid], max_new_tokens=VLM_SLOT_NEW)

    runs = {}
    for backend in ("kernel", "reference"):
        for c in (cg.LAUNCHES, chunking.LAUNCHES):
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        r = slot_run(model, params, dev, make, VLM_REQUESTS, VLM_SLOTS, ARRIVAL_RATE,
                     backend=backend)
        r["wall_s"] = time.perf_counter() - t0
        r["launches"] = {**cg.LAUNCHES, **chunking.LAUNCHES}
        check_drained(f"vlm slots {backend}", r, VLM_REQUESTS, VLM_SLOT_NEW)
        runs[backend] = r
        log(f"[vlm-slots] {cfg.name} L={n_layers} {backend}: {stats_line(r['stats'])}; "
            f"{r['rounds']} rounds, {r['steps']} decode steps in {r['wall_s']:.2f} s; pool "
            f"{r['eng'].kv_pool.summary()}; launches {r['launches']}  ({card})")
        r["eng"] = None
    k = runs["kernel"]
    steps = k["steps"]
    want = {"chunk_gather_matmul_dma": 4 * n_layers * steps,
            "chunk_gather_mlp_dma": n_layers * steps,
            "greedy_select": steps + TIME_SELECTION_LAUNCHES}
    if on_card and k["launches"] != want:
        fail(f"vlm slots: launch counts {k['launches']} != per-step counts {want}")
    if k["tokens"] != runs["reference"]["tokens"]:
        fail(f"vlm slots: kernel tokens {k['tokens']} != reference backend tokens "
             f"{runs['reference']['tokens']}")
    if k["tokens"][1] != k["tokens"][2]:
        fail("vlm slots: two identical requests decoded different tokens")
    log(f"[vlm-slots] kernel tokens equal the reference backend's for all {VLM_REQUESTS} "
        f"requests; launches exact over {steps} decode steps at batch {VLM_SLOTS}")
    report["vlm_slots"] = {b: {"stats": vars(r["stats"]), "launches": r["launches"],
                               "steps": r["steps"], "wall_s": r["wall_s"]}
                           for b, r in runs.items()}



def width_tables(dev, k, randn):
    """(table, stored): ``table(n)`` → (starts, sizes) of ``k`` entries (a
    serve-width table, zero-padded) over runs of 32 of n rows kept with
    probability 0.6, and the keep mask as f32; ``stored(n, cols, wname)`` →
    an (n, cols) matrix of fan-in normals as the planned path streams it,
    (bf16, None) or (int8 payload, per-8-row scales)."""
    import torch

    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.kernels.quantize import quantize_rows

    def table(n):
        keep = (randn(n // 32) > -0.25).repeat_interleave(32)
        s, z = cg.masks_to_block_tables(keep[None], 8, 512)
        st = torch.zeros(k, dtype=torch.int32, device=dev)
        sz = torch.zeros_like(st)
        st[: s.shape[1]], sz[: z.shape[1]] = s[0], z[0]
        return st, sz, keep.float()

    def stored(n, cols, wname):
        w = randn(n, cols, std=n ** -0.5)
        return (w.to(torch.bfloat16), None) if wname == "bf16" else quantize_rows(w, 8)

    return table, stored


def k1_width_checks(dev, name, sites, k, randn, check):
    """K1 at one model's site widths ``sites`` [(site, n, cols)] on tables
    of ``k`` entries (``width_tables``), bf16 and int8, ring depths 0-3,
    with x pre-masked (the ``project`` path) and with an input mask (K2's
    phase-2 path; at n past the x slab the per-block input records); every
    launch bitwise against its plain version."""
    from repro_torch.kernels import chunk_gather_dma as cg

    on_card = dev.type == "cuda"
    table, stored = width_tables(dev, k, randn)
    for wname in ("bf16", "int8"):
        for site, n, cols in sites:
            w, sc = stored(n, cols, wname)
            st, sz, xmask = table(n)
            xk = randn(BATCH, n)
            want = cg.chunk_gather_matmul_plain(w, xk * xmask, st, sz, sc)
            want_m = cg.chunk_gather_matmul_plain(w, xk, st, sz, sc, xmask)
            for depth in range(cg.MAX_PREFETCH_DEPTH + 1):
                check("chunk_gather_matmul_dma", f"{name} {site} {wname} d{depth}",
                      cg.chunk_gather_matmul_dma(w, xk * xmask, st, sz, sc,
                                                 prefetch_depth=depth), want)
                y = cg._launch_k1(w, xk, st, sz, sc, xmask, 512, depth) if on_card else want_m
                check("chunk_gather_matmul_dma", f"{name} {site} masked {wname} d{depth}", y,
                      want_m)
            del w, sc


def dense_width_checks(dev, dcfgs, randn, check, failures):
    """Phase 3 at the widths of the other dense decoders ``dcfgs``, on
    tables as wide as their serve path's (d_ff / 8 entries, every site
    padded to the widest) over runs of 32 rows kept with probability 0.6:
    K1 over the gelu MLP's w_fc (N = d_model, D = d_ff) and w_proj (N =
    d_ff, D = d_model), bf16 and int8, depths 0-3, with x pre-masked (the
    ``project`` path) and with an input mask (K2's phase-2 path; at N =
    d_ff the per-block input records), and K2 whole at each SwiGLU
    config's widths, y and h; every launch bitwise against its plain
    version."""
    import torch

    from repro_torch.kernels import chunk_gather_dma as cg

    depths = range(cg.MAX_PREFETCH_DEPTH + 1)
    for cfg in dcfgs:
        d, f, k = cfg.d_model, cfg.d_ff, cfg.d_ff // 8
        if cfg.mlp == "gelu":
            k1_width_checks(dev, cfg.name, (("w_fc", d, f), ("w_proj", f, d)), k, randn, check)
            continue
        table, stored = width_tables(dev, k, randn)
        for wname in ("bf16", "int8"):
            (wg, sg), (wu, su), (wd, sd) = (stored(d, f, wname), stored(d, f, wname),
                                            stored(f, d, wname))
            scales = None if wname == "bf16" else (sg, su, sd)
            (sh, zh, hmask), (sf, zf, fmask) = table(d), table(f)
            st, sz = torch.stack([sh, sf]), torch.stack([zh, zf])
            xk = randn(BATCH, d) * hmask
            yp, hp = cg.chunk_gather_mlp_plain(wg, wu, wd, xk, st, sz, fmask, scales)
            for depth in depths:
                yk, hk = cg.chunk_gather_mlp_dma(wg, wu, wd, xk, st, sz, fmask, scales,
                                                 prefetch_depth=depth, return_h=True)
                check("chunk_gather_mlp_dma", f"{cfg.name} y {wname} d{depth}", yk, yp)
                check("chunk_gather_mlp_dma", f"{cfg.name} h {wname} d{depth}", hk, hp)
            del wg, wu, wd
    if dcfgs:
        log(f"[bitwise] {', '.join(c.name for c in dcfgs)} widths: {check.n} checks so far, "
            f"{len(failures)} failed")


def dense_path(dev, cfg, card, report):
    """Phase 11, one arch: ``cfg`` at full width (DENSE_ARCHS' depth), random weights
    from seed 0, batch BATCH, prompt PROMPT, DECODE decode tokens through
    ``ServeEngine``, ``--method chunk --sparsity 0.4 --device nano
    --backend kernel``, at wbits 16 and 8, as phase 4 runs TinyLlama. The
    launch counts are set to 0 just before each decode and read just after,
    and must be exact: K1 at q, k, v, o (and the gelu MLP's fc and proj) of
    every layer each step, K2 at every layer of a SwiGLU MLP, K5 once per
    refresh step. The first REF_DECODE + 1 tokens must equal the reference
    backend's (the twin, at the same depth). Then, outside the counted runs: the
    timings as in phase 5 (K1 per site, fc and proj set apart; the plain
    version per site too), every K1, K2 and K5 call timed bitwise against
    its plain version, wall per decode step and the profiled idle share.
    Returns (model, params, the phase's kernel rows)."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.models import build_model
    from repro_torch.models.inputs import make_dummy_batch
    from repro_torch.serving import ServeEngine

    on_card = dev.type == "cuda"
    n_layers = cfg.n_layers
    gelu_family = cfg.mlp == "gelu"
    k1_per_layer = 6 if gelu_family else 4
    tag = f"[dense] {cfg.name}"
    log(f"{tag}: {n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.norm}, {cfg.mlp} MLP, head {'tied (embed.T)' if cfg.tie_embeddings else 'own'}; "
        f"random weights from seed 0; batch {BATCH}, prompt {PROMPT}, {DECODE} decode tokens")
    randn, sync = seeded(dev, 1111)
    cuda_ms, host_ms = timers(on_card)
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    batch = make_dummy_batch(cfg, InputShape("dense", PROMPT, BATCH, "train"), seed=0,
                             device=dev)
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in params["layers"].values())
    log(f"{tag} weights made in {time.perf_counter() - t0:.1f} s: {n_bytes / 2**30:.2f} GiB "
        "of layers")
    counters = (cg.LAUNCHES, chunking.LAUNCHES)
    check = Checks(("chunk_gather_matmul_dma", "chunk_gather_mlp_dma", "greedy_select"))
    runs, timing = {}, {}
    for wbits in (16, 8):
        eng = ServeEngine(model, params, max_seq=64, batch_size=BATCH, method="chunk",
                          backend="kernel", wbits=wbits, torch_device=dev)
        last = eng.prefill(batch)
        if not bool(torch.isfinite(last).all()):
            fail(f"{cfg.name} w{wbits}: prefill logits are not finite")
        tok0 = torch.argmax(last, dim=-1)[:, None]
        sync()
        for c in counters:
            for key in c:
                c[key] = 0
        out = eng.decode(tok0, DECODE)
        launches = {**cg.LAUNCHES, **chunking.LAUNCHES}
        want = {"chunk_gather_matmul_dma": k1_per_layer * n_layers * DECODE,
                "chunk_gather_mlp_dma": 0 if gelu_family else n_layers * DECODE,
                "greedy_select": DECODE + TIME_SELECTION_LAUNCHES}
        if on_card and launches != want:
            fail(f"{cfg.name} w{wbits}: launch counts {launches} != per-step counts {want}")
        if out.shape != (BATCH, DECODE + 1) or int(out.min()) < 0 \
                or int(out.max()) >= cfg.vocab_size:
            fail(f"{cfg.name} w{wbits}: bad tokens {out.tolist()}")
        loop_wall = sum(s.wall_s for s in eng.stats if s.kind == "decode")
        ref = ServeEngine(model, params, max_seq=64, batch_size=BATCH, method="chunk",
                          backend="reference", wbits=wbits, torch_device=dev)
        ref.prefill(batch)
        out_ref = ref.decode(tok0, REF_DECODE)
        if not torch.equal(out_ref, out[:, : REF_DECODE + 1]):
            fail(f"{cfg.name} w{wbits}: kernel tokens {out[:, :REF_DECODE + 1].tolist()} != "
                 f"reference backend tokens {out_ref.tolist()}")
        del ref
        if on_card:
            torch.cuda.empty_cache()
        profile = profile_decode(eng, out[:, -1:].to(dev), card) if on_card else {}
        io = eng.io_summary()
        timing[wbits], calls = decode_timings(eng, wbits, randn, cuda_ms, host_ms, card,
                                              f"{tag} w{wbits}")
        sites = timing[wbits]["chunk_gather_matmul_dma"]["per_site"]
        for site in sites:
            sub = [c for c, n in zip(calls["k1"], calls["k1_sites"]) if n == site]
            sites[site]["plain_ms"] = host_ms(lambda: [cg.chunk_gather_matmul_plain(*c)
                                                       for c in sub]) / len(sub)
        log(f"{tag} w{wbits} chunk_gather_matmul_dma plain version per site: " + "  ".join(
            f"{k} {v['plain_ms'] * 1e3:.1f} us" for k, v in sites.items()) + f"  ({card})")
        for i, (name, (w, xm, s, z, sc)) in enumerate(zip(calls["k1_sites"], calls["k1"])):
            check("chunk_gather_matmul_dma", f"{cfg.name} w{wbits} L{i // k1_per_layer} {name}",
                  cg.chunk_gather_matmul_dma(w, xm, s, z, sc),
                  cg.chunk_gather_matmul_plain(w, xm, s, z, sc))
        for layer, (wg, wu, wd, xm, s, z, fm, scs) in enumerate(calls["k2"]):
            yk, hk = cg.chunk_gather_mlp_dma(wg, wu, wd, xm, s, z, fm, scs, return_h=True)
            yp, hp = cg.chunk_gather_mlp_plain(wg, wu, wd, xm, s, z, fm, scs)
            check("chunk_gather_mlp_dma", f"{cfg.name} w{wbits} L{layer} y", yk, yp)
            check("chunk_gather_mlp_dma", f"{cfg.name} w{wbits} L{layer} h", hk, hp)
        for args in calls["k5"]:
            for got, want_ in zip(chunking.greedy_select(*args),
                                  chunking.greedy_select_plain(*args)):
                check("greedy_select", f"{cfg.name} w{wbits} {args[0].shape[0]} lanes", got,
                      want_)
        if check.failures:
            for msg in check.failures:
                log(f"{tag} {msg}")
            fail(f"{len(check.failures)} phase-11 kernel checks failed ({cfg.name})")
        runs[wbits] = {"launches": launches, "loop_wall_s": loop_wall,
                       "wall_per_step_s": loop_wall / DECODE,
                       "tokens_per_s": BATCH * DECODE / loop_wall, "profile": profile,
                       "io_bytes": io["io_bytes"], "io_sim_s": io["io_sim_s"],
                       "tokens": out.tolist()}
        log(f"{tag} w{wbits} served: {loop_wall / DECODE * 1e3:.2f} ms/step "
            f"({BATCH * DECODE / loop_wall:.2f} tokens/s), io_bytes {io['io_bytes'] / 1e6:.1f} "
            f"MB, launches {launches} (exact), first {REF_DECODE + 1} tokens identical to the "
            f"reference backend  ({card})")
        for k, v in timing[wbits].items():
            lib = "n/a" if v["library_ms"] is None else f"{v['library_ms'] * 1e3:.1f} us"
            log(f"{tag} w{wbits} {k}: {v['ms'] * 1e3:.1f} us/launch  plain "
                f"{v['plain_ms'] * 1e3:.1f} us  library {lib}  bound {v['bound_ms'] * 1e3:.2f} us "
                f"({v['bound_by']})  ({card})")
        del eng, calls
        if on_card:
            torch.cuda.empty_cache()
    log(f"{tag}: {check.n} bitwise checks (every K1, K2 and K5 call timed), max abs err "
        + ", ".join(f"{k} {v:.1e}" for k, v in check.errs.items()))
    report.setdefault("dense", {})[cfg.name] = {
        "config": dataclasses.asdict(cfg), "runs": runs, "timing": timing,
        "errs": check.errs, "n_checks": check.n}
    meta = {
        "chunk_gather_matmul_dma": ("src/repro_torch/kernels/csrc/chunk_gather.cu",
                                    "src/repro/kernels/chunk_gather_dma.py:284"),
        "chunk_gather_mlp_dma": ("src/repro_torch/kernels/csrc/chunk_gather.cu",
                                 "src/repro/kernels/chunk_gather_dma.py:617"),
        "greedy_select": ("src/repro_torch/kernels/csrc/greedy_select.cu",
                          "src/repro/core/chunking.py:362"),
    }
    return model, params, [
        {"name": f"{name} [{cfg.name}, {n_layers} layers]", "route": "cuda", "source": source,
         "replaces": replaces, "launches": runs[16]["launches"][name],
         "max_abs_err": check.errs[name], "ms": timing[16][name]["ms"],
         "plain_ms": timing[16][name]["plain_ms"], "bound_ms": timing[16][name]["bound_ms"],
         "bound_by": timing[16][name]["bound_by"], "library_ms": timing[16][name]["library_ms"]}
        for name, (source, replaces) in meta.items() if name in timing[16]]


def window_path(dev, model, params, card, report, max_seq=None, prompt_len=None,
                n_decode=None):
    """Phase 11, the rotating window on ``dense_path``'s weights: a cache for
    ``max_seq`` (WINDOW_MAX_SEQ) positions — past the window threshold, so
    it holds ``sliding_window`` positions — filled by a prompt of
    ``prompt_len`` (WINDOW_PROMPT) tokens, longer than the window (rolled
    into the cache) and than ``BLOCKWISE_THRESHOLD`` (the blockwise
    attention, windowed). Then ``n_decode`` (WINDOW_DECODE) teacher-forced
    dense decode steps, the last step's logits against ``stack_forward``
    over every position with the window, within LONG_TOL of their largest
    magnitude; then a serve of ``n_decode`` tokens on the kernel backend
    (launch counts from 0, exact) whose first REF_DECODE + 1 tokens equal
    the reference backend's."""
    import numpy as np
    import torch

    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.models import attention, transformer
    from repro_torch.models.model import effective_window
    from repro_torch.serving import ServeEngine

    cfg = model.cfg
    max_seq = max_seq or WINDOW_MAX_SEQ
    prompt_len = prompt_len or WINDOW_PROMPT
    n_decode = n_decode or WINDOW_DECODE
    on_card = dev.type == "cuda"
    window = effective_window(cfg, max_seq)
    if not window or prompt_len <= max(window, attention.BLOCKWISE_THRESHOLD):
        fail(f"window: max_seq {max_seq} and a {prompt_len}-token prompt do not engage "
             f"and roll the window ({window})")
    _, sync = seeded(dev, 0)
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (BATCH, prompt_len + n_decode))).to(dev)
    prompt = {"tokens": tokens[:, :prompt_len]}
    sync()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, prompt, max_seq)
    sync()
    prefill_wall = time.perf_counter() - t0
    if cache["k"].shape[2] != window or cache["length"] != prompt_len \
            or not bool(torch.isfinite(last).all()):
        fail(f"window: prefill gave a cache of {cache['k'].shape[2]} positions, length "
             f"{cache['length']}, or non-finite logits")
    t0 = time.perf_counter()
    for i in range(n_decode):
        logits, _ = model.decode_step_planned(
            params, tokens[:, prompt_len + i: prompt_len + i + 1], cache)
    sync()
    decode_wall = time.perf_counter() - t0
    del cache
    # the windowed forward over every position
    s = prompt_len + n_decode
    x = params["embed"][tokens].to(torch.bfloat16)
    positions = torch.arange(s, device=dev)[None].expand(BATCH, s)
    hidden = transformer.stack_forward(params["layers"], x, cfg, positions, window)[0]
    want = model.logits(params, model.final_norm(params, hidden[:, -1])).float()
    del x, hidden
    diff = float((logits - want).abs().max())
    scale = float(want.abs().max())
    same_argmax = bool(torch.equal(logits.argmax(-1), want.argmax(-1)))
    if not diff <= LONG_TOL * scale:
        fail(f"window: the decode's last logits differ from the windowed forward's by "
             f"{diff:.4f} (max |logit| {scale:.3f}, tolerance {LONG_TOL:.0%} of it)")
    log(f"[window] {cfg.name}, batch {BATCH}: max_seq {max_seq} → a rotating cache of "
        f"{window} positions; a {prompt_len}-token prompt rolled in ({prefill_wall * 1e3:.0f} "
        f"ms), {n_decode} teacher-forced dense decode steps ({decode_wall / n_decode * 1e3:.1f} "
        f"ms/step): last logits vs the windowed forward over {s} positions max abs diff "
        f"{diff:.4f} (max |logit| {scale:.3f}, tolerance {LONG_TOL:.0%} of it; argmax equal: "
        f"{same_argmax})  ({card})")

    # served on the kernel backend, against the twin
    counters = (cg.LAUNCHES, chunking.LAUNCHES)
    eng = ServeEngine(model, params, max_seq=max_seq, batch_size=BATCH, method="chunk",
                      backend="kernel", wbits=16, torch_device=dev)
    last = eng.prefill(prompt)
    tok0 = torch.argmax(last, dim=-1)[:, None]
    sync()
    for c in counters:
        for key in c:
            c[key] = 0
    out = eng.decode(tok0, n_decode)
    launches = {**cg.LAUNCHES, **chunking.LAUNCHES}
    gelu_family = cfg.mlp == "gelu"
    want_launches = {
        "chunk_gather_matmul_dma": (6 if gelu_family else 4) * cfg.n_layers * n_decode,
        "chunk_gather_mlp_dma": 0 if gelu_family else cfg.n_layers * n_decode,
        "greedy_select": n_decode + TIME_SELECTION_LAUNCHES}
    if on_card and launches != want_launches:
        fail(f"window: launch counts {launches} != per-step counts {want_launches}")
    if eng.cache["k"].shape[2] != window or eng.cache["length"] != prompt_len + n_decode:
        fail(f"window: the served cache holds {eng.cache['k'].shape[2]} positions, length "
             f"{eng.cache['length']}")
    loop_wall = sum(st.wall_s for st in eng.stats if st.kind == "decode")
    del eng
    ref = ServeEngine(model, params, max_seq=max_seq, batch_size=BATCH, method="chunk",
                      backend="reference", wbits=16, torch_device=dev)
    ref.prefill(prompt)
    out_ref = ref.decode(tok0, REF_DECODE)
    del ref
    if not torch.equal(out_ref, out[:, : REF_DECODE + 1]):
        fail(f"window: kernel tokens {out[:, :REF_DECODE + 1].tolist()} != reference backend "
             f"tokens {out_ref.tolist()}")
    log(f"[window] served on the kernel backend: {loop_wall / n_decode * 1e3:.2f} ms/step, "
        f"launches {launches} (exact), first {REF_DECODE + 1} tokens identical to the "
        f"reference backend  ({card})")
    report["window"] = {"arch": cfg.name, "max_seq": max_seq, "window": window,
                        "prompt": prompt_len, "decode": n_decode, "max_abs_diff": diff,
                        "max_abs_logit": scale, "same_argmax": same_argmax,
                        "prefill_wall_s": prefill_wall, "dense_decode_wall_per_step_s":
                        decode_wall / n_decode, "served_wall_per_step_s": loop_wall / n_decode,
                        "launches": launches, "tokens": out.tolist()}


def moe_path(dev, full_cfg, n_layers, card, report):
    """Phase 12, one MoE arch: ``full_cfg`` at full width, depth cut to
    ``n_layers`` (None: all), random weights from seed 0. First K1 bitwise
    at the attention sites' widths (``k1_width_checks`` on serve-width
    tables). Then, at wbits 16 and 8, ``ServeEngine`` with ``--method chunk
    --sparsity 0.4 --device nano --backend kernel``, batch BATCH: prefill of
    PROMPT tokens (half of them vision for an early-fusion arch), then
    MOE_FRAMES frames of frontend_tokens // 4 tokens (early fusion only),
    then DECODE decode tokens. The launch counts are set to 0 just before
    the prefill and read just after the decode, and must be exact: K1 at q,
    k, v, o of every layer each step (a MoE layer has no MLP sites, so K2
    never launches), K5 once per refresh step (and once per site and layer
    of each frame). The first REF_DECODE + 1 tokens must equal the
    reference backend's (the twin, on the same prompt and frames). Then,
    outside the counted runs: the K1/K5 timings as in phase 5, every K1 and
    K5 call timed held bitwise against its plain version, wall per step,
    the profiled idle share, and the MoE FFN at the decode's shape (BATCH
    tokens) on every layer's weights: device µs per layer from replays of
    a CUDA graph of the layer loop (the profiler's kernel sum beside it, a
    second reading) beside its bound, every expert's bytes read once over
    3.35 TB/s (the reference's semantics run all E experts over their
    capacity slots), and the expert products alone from CUDA-graph
    replays. Returns the phase's kernel rows."""
    import numpy as np
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.models import build_model
    from repro_torch.models.inputs import FRONT_DTYPE, make_dummy_batch
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.common import unstack
    from repro_torch.models.transformer import moe_cfg_of
    from repro_torch.serving import ServeEngine

    on_card = dev.type == "cuda"
    cfg = dataclasses.replace(full_cfg, n_layers=n_layers or full_cfg.n_layers)
    n_layers = cfg.n_layers
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hd_all, kv_all = cfg.n_heads * hd, cfg.n_kv_heads * hd
    n_frames = MOE_FRAMES if cfg.d_frontend else 0
    frame_tokens = max(cfg.frontend_tokens // 4, 4)
    mc = moe_cfg_of(cfg)
    tag = f"[moe] {cfg.name}"
    cut = ("all" if n_layers == full_cfg.n_layers else
           f"depth cut to {n_layers} of {full_cfg.n_layers}: all of them do not fit one card")
    log(f"{tag}: {n_layers} layers ({cut}), d_model {d}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
        f"of {hd}, {cfg.n_experts} experts top-{cfg.moe_top_k} of d_ff {cfg.d_ff}"
        f"{' + a shared expert' if cfg.moe_shared_expert else ''}, capacity factor "
        f"{cfg.moe_capacity_factor}, vocab {cfg.vocab_size}"
        + (f", d_frontend {cfg.d_frontend}" if cfg.d_frontend else "")
        + f"; random weights from seed 0; batch {BATCH}, prompt {PROMPT}"
        + (f" (half vision), {n_frames} frames of {frame_tokens} tokens" if n_frames else "")
        + f", {DECODE} decode tokens")
    randn, sync = seeded(dev, 2468)
    cuda_ms, host_ms = timers(on_card)
    check = Checks(("chunk_gather_matmul_dma", "greedy_select"))

    # K1 at this arch's site widths (q, k/v, o), on serve-width tables
    widths = list(dict.fromkeys(((d, hd_all), (d, kv_all), (hd_all, d))))
    k1_width_checks(dev, cfg.name, [(f"{n}->{c}", n, c) for n, c in widths],
                    max(d, hd_all) // 8, randn, check)
    if check.failures:
        for msg in check.failures:
            log(f"{tag} {msg}")
        fail(f"{len(check.failures)} phase-12 K1 width checks failed ({cfg.name})")
    width_checks = check.n
    log(f"{tag} K1 at {', '.join(f'{n}->{c}' for n, c in widths)}: {width_checks} bitwise "
        f"checks (bf16 and int8, depths 0-{cg.MAX_PREFETCH_DEPTH}, x pre-masked and with an "
        f"input mask), max abs err {check.errs['chunk_gather_matmul_dma']:.1e}")

    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    batch = make_dummy_batch(cfg, InputShape("moe", PROMPT, BATCH, "train"), seed=0,
                             device=dev)
    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(rng.normal(0, 1, (BATCH, frame_tokens, cfg.d_frontend)))
              .to(FRONT_DTYPE).to(dev) for _ in range(n_frames)]
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in params["layers"].values())
    top_bytes = sum(t.numel() * t.element_size() for t in params.values()
                    if isinstance(t, torch.Tensor))
    log(f"{tag} weights made in {time.perf_counter() - t0:.1f} s: {n_bytes / 2**30:.2f} GiB "
        f"of layers, {top_bytes / 2**30:.2f} GiB embed/head/projector")
    counters = (cg.LAUNCHES, chunking.LAUNCHES)

    def serve(backend, wbits, n_decode):
        eng = ServeEngine(model, params, max_seq=MOE_MAX_SEQ, batch_size=BATCH,
                          device="nano", sparsity=0.4, method="chunk", backend=backend,
                          wbits=wbits, torch_device=dev)
        last = eng.prefill(batch)
        hidden = [eng.append_frame(fr) for fr in frames]
        out = eng.decode(torch.argmax(last, dim=-1)[:, None], n_decode)
        return eng, out, last, hidden

    runs, timing = {}, {}
    for wbits in (16, 8):
        sync()
        for c in counters:
            for key in c:
                c[key] = 0
        eng, out, last, hidden = serve("kernel", wbits, DECODE)
        sync()
        launches = {**cg.LAUNCHES, **chunking.LAUNCHES}
        want = {"chunk_gather_matmul_dma": 4 * n_layers * DECODE, "chunk_gather_mlp_dma": 0,
                "greedy_select": DECODE + TIME_SELECTION_LAUNCHES + 2 * n_layers * n_frames}
        if on_card and launches != want:
            fail(f"{cfg.name} w{wbits}: launch counts {launches} != per-step counts {want}")
        if not (bool(torch.isfinite(last).all())
                and all(bool(torch.isfinite(h).all()) for h in hidden)):
            fail(f"{cfg.name} w{wbits}: non-finite prefill logits or frame hidden states")
        if out.shape != (BATCH, DECODE + 1) or int(out.min()) < 0 \
                or int(out.max()) >= cfg.vocab_size:
            fail(f"{cfg.name} w{wbits}: bad tokens {out.tolist()}")
        if eng.cache["length"] != PROMPT + n_frames * frame_tokens + DECODE:
            fail(f"{cfg.name} w{wbits}: cache length {eng.cache['length']}")
        st = {k: [x for x in eng.stats if x.kind == k] for k in ("prefill", "frame", "decode")}
        if len(st["frame"]) != n_frames or not all(x.io_est_s > 0 for x in st["frame"]):
            fail(f"{cfg.name} w{wbits}: frame stats {st['frame']}")
        ref, out_ref, _, _ = serve("reference", wbits, REF_DECODE)
        if not torch.equal(out_ref, out[:, : REF_DECODE + 1]):
            fail(f"{cfg.name} w{wbits}: kernel tokens {out[:, :REF_DECODE + 1].tolist()} != "
                 f"reference backend tokens {out_ref.tolist()}")
        del ref
        if on_card:
            torch.cuda.empty_cache()
        loop_wall = sum(x.wall_s for x in st["decode"])
        profile = profile_decode(eng, out[:, -1:].to(dev), card) if on_card else {}
        io = eng.io_summary()
        timing[wbits], calls = decode_timings(eng, wbits, randn, cuda_ms, host_ms, card,
                                              f"{tag} w{wbits}")
        for i, (name, (w, xm, s_, z, sc)) in enumerate(zip(calls["k1_sites"], calls["k1"])):
            check("chunk_gather_matmul_dma", f"{cfg.name} w{wbits} L{i // 4} {name}",
                  cg.chunk_gather_matmul_dma(w, xm, s_, z, sc),
                  cg.chunk_gather_matmul_plain(w, xm, s_, z, sc))
        for args in calls["k5"]:
            for got, want_ in zip(chunking.greedy_select(*args),
                                  chunking.greedy_select_plain(*args)):
                check("greedy_select", f"{cfg.name} w{wbits} {args[0].shape[0]} lanes", got,
                      want_)
        if check.failures:
            for msg in check.failures:
                log(f"{tag} {msg}")
            fail(f"{len(check.failures)} phase-12 kernel checks failed ({cfg.name})")
        runs[wbits] = {"launches": launches, "loop_wall_s": loop_wall,
                       "wall_per_step_s": loop_wall / DECODE,
                       "tokens_per_s": BATCH * DECODE / loop_wall, "profile": profile,
                       "prefill_wall_s": st["prefill"][0].wall_s,
                       "frame_wall_s": [x.wall_s for x in st["frame"]],
                       "io_bytes": io["io_bytes"], "io_sim_s": io["io_sim_s"],
                       "tokens": out.tolist()}
        log(f"{tag} w{wbits} served: prefill {st['prefill'][0].wall_s * 1e3:.1f} ms"
            + ("" if not n_frames else ", frames " + ", ".join(
                f"{x.wall_s * 1e3:.1f}" for x in st["frame"]) + " ms")
            + f", decode {loop_wall / DECODE * 1e3:.2f} ms/step "
            f"({BATCH * DECODE / loop_wall:.2f} tokens/s), io_bytes {io['io_bytes'] / 1e6:.1f} "
            f"MB, launches {launches} (exact), first {REF_DECODE + 1} tokens identical to the "
            f"reference backend  ({card})")
        for k, v in timing[wbits].items():
            lib = "n/a" if v["library_ms"] is None else f"{v['library_ms'] * 1e3:.1f} us"
            log(f"{tag} w{wbits} {k}: {v['ms'] * 1e3:.1f} us/launch  plain "
                f"{v['plain_ms'] * 1e3:.1f} us  library {lib}  bound {v['bound_ms'] * 1e3:.2f} us "
                f"({v['bound_by']})  ({card})")
        del eng, calls
        if on_card:
            torch.cuda.empty_cache()
    log(f"{tag}: {check.n} bitwise checks ({width_checks} at the widths, then every K1 and K5 "
        "call timed), max abs err " + ", ".join(f"{k} {v:.1e}" for k, v in check.errs.items()))

    # the MoE FFN at the decode's shape, every layer's weights
    h = randn(BATCH, 1, d).to(torch.bfloat16)
    layers = unstack(params["layers"])
    names = ("router", "we_gate", "we_up", "we_down") + (
        ("ws_gate", "ws_up", "ws_down") if cfg.moe_shared_expert else ())
    layer_bytes = sum(layers[0][n].numel() * layers[0][n].element_size() for n in names)
    cap = mc.capacity(BATCH)
    flops = 2.0 * 3 * d * cfg.d_ff * (cfg.n_experts * cap
                                      + (BATCH if cfg.moe_shared_expert else 0))
    bound_us = max(layer_bytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S) * 1e6
    bound_by = "bytes" if layer_bytes / HBM_BYTES_PER_S >= flops / BF16_OPS_PER_S \
        else "operations"

    def moe_loop():  # no host sync inside: capturable in a CUDA graph
        for lp in layers:
            moe_ffn(h, lp, mc)

    def run_moe():
        moe_loop()
        sync()

    # the expert products alone (the three batched matmuls over every
    # expert's cap slots, and the shared expert's), on a fixed buffer
    x_buf = randn(cfg.n_experts, cap, d).to(torch.bfloat16)
    x_sh = randn(BATCH, d).to(torch.bfloat16)

    def run_products():
        for lp in layers:
            torch.bmm(torch.bmm(x_buf, lp["we_gate"]) * torch.bmm(x_buf, lp["we_up"]),
                      lp["we_down"])
            if cfg.moe_shared_expert:
                ((x_sh @ lp["ws_gate"]) * (x_sh @ lp["ws_up"])) @ lp["ws_down"]

    run_moe()
    t0 = time.perf_counter()
    run_moe()
    host_us = (time.perf_counter() - t0) * 1e6 / n_layers
    products_us = cuda_ms(run_products, 5) * 1e3 / n_layers
    moe = {"cap": cap, "layer_bytes": layer_bytes, "bound_us": bound_us, "bound_by": bound_by,
           "host_wall_us_per_layer": host_us, "products_us_per_layer": products_us}
    if on_card:
        # the whole FFN's device time from replays of a CUDA graph of the
        # layer loop; if capture fails, CUDA events around the loop (that
        # wall includes the host's gaps between launches)
        try:
            ffn_us, timed_by = cuda_ms(moe_loop, 5) * 1e3 / n_layers, "CUDA-graph replay"
        except RuntimeError as err:
            log(f"{tag} MoE FFN: CUDA-graph capture failed ({err}); timing with events")
            sync()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(5):
                moe_loop()
            b.record()
            b.synchronize()
            ffn_us = a.elapsed_time(b) * 1e3 / 5 / n_layers
            timed_by = "CUDA events around the loop: this wall includes the host's gaps"
        # the profiler's kernel sum, a second reading (it undercounted
        # cuBLAS's kernels at Scout in PR 20)
        wall_us, kernels, _ = profiled(run_moe)
        busy = sum(kernels.values()) / n_layers
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
        moe.update({"device_us_per_layer": ffn_us, "timed_by": timed_by,
                    "profiler_kernel_sum_us_per_layer": busy,
                    "profiled_wall_us_per_layer": wall_us / n_layers,
                    "top_kernels_us_per_layer": {k: v / n_layers for k, v in top}})
        log(f"{tag} MoE FFN at decode ({BATCH} tokens, cap {cap} of {cfg.n_experts} experts): "
            f"{ffn_us:.1f} us a layer on the device ({timed_by}; the profiler's kernel sum "
            f"{busy:.1f} us; host wall {host_us:.1f} us), bound {bound_us:.1f} us "
            f"({layer_bytes / 1e6:.1f} MB of router and experts a layer over 3.35 TB/s, "
            f"{bound_by}), {bound_us / ffn_us:.0%} of it; the expert products alone "
            f"{products_us:.1f} us a layer (CUDA-graph replay, "
            f"{layer_bytes / products_us / 1e6:.2f} TB/s); top kernels a layer (profiler): "
            + ", ".join(f"{k[:60]} {v / n_layers:.1f} us" for k, v in top) + f"  ({card})")
    report.setdefault("moe", {})[cfg.name] = {
        "config": dataclasses.asdict(cfg), "layers_of": full_cfg.n_layers, "runs": runs,
        "timing": timing, "moe_ffn": moe, "errs": check.errs, "n_checks": check.n,
        "width_checks": width_checks}
    del params, layers, x_buf
    meta = {
        "chunk_gather_matmul_dma": ("src/repro_torch/kernels/csrc/chunk_gather.cu",
                                    "src/repro/kernels/chunk_gather_dma.py:284"),
        "greedy_select": ("src/repro_torch/kernels/csrc/greedy_select.cu",
                          "src/repro/core/chunking.py:362"),
    }
    depth = (f"{n_layers} layers" if n_layers == full_cfg.n_layers
             else f"{n_layers} of {full_cfg.n_layers} layers")
    return [
        {"name": f"{name} [{cfg.name}, {depth}]", "route": "cuda", "source": source,
         "replaces": replaces, "launches": runs[16]["launches"][name],
         "max_abs_err": check.errs[name], "ms": timing[16][name]["ms"],
         "plain_ms": timing[16][name]["plain_ms"], "bound_ms": timing[16][name]["bound_ms"],
         "bound_by": timing[16][name]["bound_by"], "library_ms": timing[16][name]["library_ms"]}
        for name, (source, replaces) in meta.items()]


def selection_input(eng):
    """K5's arguments in ``SparseExecution.time_selection``: every site of
    every layer, importances |sin(i)| over the padded lanes (the engine's
    selection timing, the one K5 launch of a decode call of a family
    without sparsification sites)."""
    import torch

    sp = eng.sparse_ctx
    b = sp.batched
    n_layers = eng.model.cfg.n_layers
    lanes = n_layers * b.n_sites
    n = torch.arange(lanes * b.n_max, dtype=torch.float32, device=eng.torch_device)
    vs = torch.sin(n).abs().reshape(n_layers, b.n_sites, b.n_max)
    starts, sizes = b.sorted_candidates(vs)
    return (starts.reshape(lanes, -1), sizes.reshape(lanes, -1), sp.lane_budgets,
            sp.lane_min_sizes, b.n_max)


def family_consistency(dev, cfg, on_card):
    """The reference suite's consistency of the serving path, in f32 on
    ``dev`` (``models.model.COMPUTE_DTYPE`` set to f32 for the call): Zamba
    prefills all but the last token and decodes it (the reference's
    ``test_zamba_prefill_matches_forward_f32``); xLSTM decodes every token
    from an empty state and Whisper prefills the first and decodes the
    rest (``test_sequential_decode_matches_forward_f32``). Returns (max abs
    error of the last logits against a forward's, max |logit|)."""
    import torch

    import repro_torch.models.model as mm
    from repro_torch.configs.base import InputShape
    from repro_torch.models import build_model
    from repro_torch.models.inputs import make_dummy_batch

    old = mm.COMPUTE_DTYPE
    mm.COMPUTE_DTYPE = torch.float32
    try:
        model = build_model(cfg)
        params = model.init(seed=1, device=dev)
        batch = make_dummy_batch(cfg, InputShape("consist", CONSIST_SEQ, BATCH, "train"), seed=1,
                                 device=dev)
        toks = batch["tokens"]
        if cfg.arch_type == "hybrid":
            _, cache = model.prefill(params, {"tokens": toks[:, :-1]}, 32)
            lg, _ = model.decode_step(params, toks[:, -1:], cache)
        elif cfg.is_encdec:
            lg, cache = model.prefill(params, {**batch, "tokens": toks[:, :1]}, 32)
            for i in range(1, toks.shape[1]):
                lg, _ = model.decode_step(params, toks[:, i: i + 1], cache)
        else:
            cache = model.init_cache(BATCH, 32, dev)
            for i in range(toks.shape[1]):
                lg, _ = model.decode_step(params, toks[:, i: i + 1], cache)
        want = model.logits(params, model.forward(params, batch)[0])[:, -1].to(torch.float32)
        err = float((lg - want).abs().max())
        ok = torch.allclose(lg, want, **CONSIST_TOL)
        big = float(want.abs().max())
        del model, params, cache
        if on_card:
            torch.cuda.empty_cache()
        return err, big, ok
    finally:
        mm.COMPUTE_DTYPE = old


def family_on_cpu(dev, full_cfg):
    """The reduced config with the same seeded weights on ``dev`` and on
    the CPU (made on the CPU, copied to the card): prefill logits and
    CPU_DECODE teacher-forced decode steps. Returns the max abs error over
    them and whether all sit within CPU_TOL."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.models import build_model
    from repro_torch.models.inputs import make_dummy_batch

    cfg = full_cfg.reduced()
    model = build_model(cfg)
    cpu = torch.device("cpu")
    p_cpu = model.init(seed=0, device=cpu)
    p_dev = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev))
             for k, v in p_cpu.items()}
    b_cpu = make_dummy_batch(cfg, InputShape("cpu", PROMPT, BATCH, "train"), seed=0, device=cpu)
    outs = []
    for params, batch in ((p_cpu, b_cpu), (p_dev, {k: v.to(dev) for k, v in b_cpu.items()})):
        last, cache = model.prefill(params, batch, FAMILY_MAX_SEQ)
        lgs = [last.to(torch.float32)]
        for i in range(CPU_DECODE):
            lg, _ = model.decode_step(params, batch["tokens"][:, i: i + 1], cache)
            lgs.append(lg)
        outs.append(torch.stack(lgs).cpu())
    err = float((outs[0] - outs[1]).abs().max())
    return err, torch.allclose(outs[1], outs[0], **CPU_TOL)


def family_path(dev, full_cfg, card, report):
    """Phase 13, one arch of FAMILY_ARCHS: ``full_cfg`` at full width and
    depth, random weights from seed 0, ``ServeEngine`` with ``--method chunk
    --sparsity 0.4 --device nano --backend kernel``, batch BATCH: prefill of
    PROMPT tokens (Whisper's prompt carries its frontend_tokens encoder
    frames), then DECODE decode tokens. The launch counts are set to 0 just
    before the prefill and read just after the decode, and must be exact:
    no K1 or K2 (the family's decode reaches no sparsification site), K5
    TIME_SELECTION_LAUNCHES times (the engine's selection timing). Held:
    tokens in range, the cache length, prefill charged the dense I/O and
    every decode step none, ``dense_free`` giving the same tokens (the
    decode ignores the sparse context); then the wall a step and of the
    prefill, a profiled PROFILE_TOKENS-step call (idle share, host
    launches a step), K5 on the selection timing's input bitwise against its
    plain version and timed, the f32 consistency check
    (``family_consistency``), card against CPU at the reduced config
    (``family_on_cpu``), and the refusals: paged KV, wbits 8 and the frame
    append. Returns the phase's kernel row (K5)."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.models import build_model
    from repro_torch.models.inputs import make_dummy_batch
    from repro_torch.serving import IO_SUMMARY_KEYS, ServeEngine

    on_card = dev.type == "cuda"
    cfg = full_cfg
    tag = f"[family] {cfg.name}"
    t_phase = time.perf_counter()
    shape = {"hybrid": f"{cfg.n_layers} Mamba2 layers (d_state {cfg.ssm_state}, head "
                       f"{cfg.ssm_head_dim}), the shared attention + SwiGLU block after every "
                       f"{cfg.attn_every} ({cfg.n_heads} heads of {cfg.resolved_head_dim}, d_ff "
                       f"{cfg.d_ff})",
             "ssm": f"{cfg.n_layers} blocks (sLSTM at {list(cfg.slstm_layers)}), "
                    f"{cfg.n_heads} heads",
             "audio": f"{cfg.encoder_layers} + {cfg.n_layers} layers, {cfg.frontend_tokens} "
                      f"audio positions of {cfg.d_frontend}"}[cfg.arch_type]
    log(f"{tag}: {shape}, d_model {cfg.d_model}, vocab {cfg.vocab_size}; full width and depth, "
        f"random weights from seed 0; batch {BATCH}, prompt {PROMPT}, {DECODE} decode tokens")
    _, sync = seeded(dev, 1357)
    cuda_ms, host_ms = timers(on_card)
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    batch = make_dummy_batch(cfg, InputShape("family", PROMPT, BATCH, "train"), seed=0,
                             device=dev)
    sync()
    n_bytes = sum(t.numel() * t.element_size() for v in params.values()
                  for t in (v.values() if isinstance(v, dict) else (v,)))
    log(f"{tag} weights made in {time.perf_counter() - t0:.1f} s: {n_bytes / 2**30:.2f} GiB")
    counters = (cg.LAUNCHES, chunking.LAUNCHES)

    def serve(method, n_decode=DECODE):
        eng = ServeEngine(model, params, max_seq=FAMILY_MAX_SEQ, batch_size=BATCH,
                          device="nano", sparsity=0.4, method=method, backend="kernel",
                          torch_device=dev)
        last = eng.prefill(batch)
        out = eng.decode(torch.argmax(last, dim=-1)[:, None], n_decode)
        return eng, out, last

    sync()
    for c in counters:
        for key in c:
            c[key] = 0
    eng, out, last = serve("chunk")
    sync()
    launches = {**cg.LAUNCHES, **chunking.LAUNCHES}
    want = {"chunk_gather_matmul_dma": 0, "chunk_gather_mlp_dma": 0,
            "greedy_select": TIME_SELECTION_LAUNCHES}
    if on_card and launches != want:
        fail(f"{cfg.name}: launch counts {launches} != {want}")
    if not bool(torch.isfinite(last).all()):
        fail(f"{cfg.name}: non-finite prefill logits")
    if out.shape != (BATCH, DECODE + 1) or int(out.min()) < 0 \
            or int(out.max()) >= cfg.vocab_size:
        fail(f"{cfg.name}: bad tokens {out.tolist()}")
    if eng.cache["length"] != PROMPT + DECODE:
        fail(f"{cfg.name}: cache length {eng.cache['length']}")
    st = {k: [x for x in eng.stats if x.kind == k] for k in ("prefill", "decode")}
    io = eng.io_summary()
    if tuple(io) != IO_SUMMARY_KEYS or not st["prefill"][0].io_est_s > 0 \
            or any(x.io_est_s != 0 for x in st["decode"]) or len(st["decode"]) != DECODE:
        fail(f"{cfg.name}: accounting {io}, prefill {st['prefill']}")
    loop_wall = sum(x.wall_s for x in st["decode"])
    free, out_free, _ = serve("dense_free")
    if not torch.equal(out_free, out):
        fail(f"{cfg.name}: dense_free tokens {out_free.tolist()} != chunk's {out.tolist()}")
    free_wall = sum(x.wall_s for x in free.stats if x.kind == "decode")
    free_prefill = free.stats[0].wall_s
    del free
    profile = profile_decode(eng, out[:, -1:].to(dev), card) if on_card else {}
    launch_calls = profile.get("launch_calls", 0) / PROFILE_TOKENS
    log(f"{tag} served: prefill {st['prefill'][0].wall_s * 1e3:.1f} ms (dense_free "
        f"{free_prefill * 1e3:.1f}), decode {loop_wall / DECODE * 1e3:.2f} ms/step (dense_free "
        f"{free_wall / DECODE * 1e3:.2f}), {BATCH * DECODE / loop_wall:.2f} tokens/s, device idle "
        f"{1 - profile.get('device_busy_share', 0.0):.1%} of a profiled {PROFILE_TOKENS}-step "
        f"call, {launch_calls:.0f} host launches a step; launches {launches} (exact); tokens "
        f"of dense_free identical  ({card})")
    log(f"{tag} io_summary: io_est {io['io_est_s'] * 1e3:.3f} ms, io_sim "
        f"{io['io_sim_s'] * 1e3:.3f} ms, io_bytes {io['io_bytes'] / 1e6:.1f} MB (the prefill's), "
        f"steps {io['steps']}, decode_compute {io['decode_compute_s'] * 1e3:.3f} ms, "
        f"decode_overlap {io['decode_overlap_s'] * 1e3:.3f} ms, select_overhead "
        f"{io['select_overhead_s'] * 1e3:.3f} ms")

    # the refusals, on the card as on the CPU
    refusals = []
    for kw, err_type in (({"kv_page_tokens": 16}, ValueError), ({"wbits": 8}, ValueError)):
        try:
            ServeEngine(model, params, max_seq=FAMILY_MAX_SEQ, batch_size=BATCH, method="chunk",
                        backend="kernel", torch_device=dev, **kw)
        except err_type as err:
            refusals.append(f"{next(iter(kw))}: {type(err).__name__}")
        else:
            fail(f"{cfg.name}: ServeEngine({kw}) did not refuse")
    try:
        eng.append_frame(torch.zeros((BATCH, 4, cfg.d_frontend or cfg.d_model), device=dev))
    except NotImplementedError as err:
        refusals.append(f"append_frame: {type(err).__name__}")
    else:
        fail(f"{cfg.name}: append_frame did not refuse")

    # K5 on the selection timing's input: bitwise against the plain walk,
    # then timed
    args = selection_input(eng)
    got, ref = chunking.greedy_select(*args), chunking.greedy_select_plain(*args)
    err5 = max(float((g.to(torch.float64) - r.to(torch.float64)).abs().max())
               for g, r in zip(got, ref))
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        fail(f"{cfg.name}: K5 on the selection input is not bitwise its plain version "
             f"(max abs err {err5:.3e})")
    walked = []
    plain_ms = host_ms(lambda: chunking.greedy_select_plain(*args, walked=walked))
    lanes = len(walked)
    k5_bytes = sum(walked) * 8 + lanes * (args[4] + 12)
    k5 = {"ms": cuda_ms(lambda: chunking.greedy_select(*args), 5), "plain_ms": plain_ms,
          "bound_ms": k5_bytes / HBM_BYTES_PER_S * 1e3, "lanes": lanes,
          "walked_per_lane": sum(walked) / lanes}
    log(f"{tag} greedy_select on the selection timing's {lanes} lanes: {k5['ms'] * 1e3:.1f} "
        f"us/launch, plain {plain_ms * 1e3:.1f} us, bound {k5['bound_ms'] * 1e3:.2f} us "
        f"(bytes; {k5['walked_per_lane']:.0f} candidates walked a lane), bitwise  ({card})")
    del eng, args, got, ref
    if on_card:
        torch.cuda.empty_cache()

    ccfg = dataclasses.replace(cfg, n_layers=CONSIST_ZAMBA_LAYERS) \
        if cfg.arch_type == "hybrid" else cfg
    c_err, c_big, c_ok = family_consistency(dev, ccfg, on_card)
    if not c_ok:
        fail(f"{cfg.name}: f32 prefill + decode vs forward, max abs err {c_err:.3e} over "
             f"{CONSIST_TOL}")
    p_err, p_ok = family_on_cpu(dev, cfg)
    if not p_ok:
        fail(f"{cfg.name}: reduced config, card vs CPU max abs err {p_err:.3e} over {CPU_TOL}")
    depth = (f"{ccfg.n_layers} of {cfg.n_layers} layers" if ccfg.n_layers != cfg.n_layers
             else "all layers")
    log(f"{tag} checks: f32 prefill + sequential decode vs a forward's last logits ({depth}, "
        f"{CONSIST_SEQ} tokens): max abs err {c_err:.2e} (max |logit| {c_big:.2f}; tolerance "
        f"{CONSIST_TOL}); reduced config card vs CPU (prefill + {CPU_DECODE} decode steps, "
        f"bf16): max abs err {p_err:.2e} (tolerance {CPU_TOL}); refused: "
        f"{', '.join(refusals)}; phase {time.perf_counter() - t_phase:.1f} s  ({card})")
    report.setdefault("families", {})[cfg.name] = {
        "config": dataclasses.asdict(cfg), "launches": launches, "tokens": out.tolist(),
        "prefill_wall_s": st["prefill"][0].wall_s, "wall_per_step_s": loop_wall / DECODE,
        "dense_free_wall_per_step_s": free_wall / DECODE, "dense_free_prefill_wall_s":
        free_prefill, "profile": profile, "launch_calls_per_step": launch_calls,
        "io_summary": io, "k5": k5, "consistency": {"layers": ccfg.n_layers, "max_abs_err": c_err,
                                                     "max_logit": c_big},
        "card_vs_cpu_max_abs_err": p_err, "refusals": refusals,
        "phase_s": time.perf_counter() - t_phase}
    del model, params
    return [{"name": f"greedy_select [{cfg.name}, selection timing, {lanes} lanes]",
             "route": "cuda", "source": "src/repro_torch/kernels/csrc/greedy_select.cu",
             "replaces": "src/repro/core/chunking.py:362", "launches": launches["greedy_select"],
             "max_abs_err": err5, "ms": k5["ms"], "plain_ms": plain_ms,
             "bound_ms": k5["bound_ms"], "bound_by": "bytes", "library_ms": None}]


def matmul_params(model) -> int:
    """N of the 6·N·T rule: the weights that enter a matrix product once a
    token — every stacked layer matrix (3 or more dims) and the head (the
    embedding when tied); the embedding lookup and the norms are not
    products."""
    shapes = model.param_shapes()
    n = sum(math.prod(shape) for name, (shape, *_) in shapes.items()
            if name.startswith("layers/") and len(shape) >= 3)
    return n + math.prod(shapes["embed" if model.cfg.tie_embeddings else "head"][0])


def train_path(dev, card, report, cfg=None):
    """Phase 14: TRAIN_ARCH at full width and depth, random weights from
    seed 0, through ``Trainer.train_step`` (the entry point of
    ``python -m repro_torch.launch.train``) with remat: batches of the
    synthetic pipeline drawn first (their host time printed on its own
    line), TRAIN_WARM + TRAIN_TIMED steps each timed by the host clock
    around a synchronised step, one profiled step (its bf16 products
    checked against ``train_gemm_ms``), then the same state
    stepped with remat on and with remat off (the state kept on the host
    between them), each step's peak memory measured from its start. The
    chunk-gather kernels' launch counts are set to 0 before the steps and
    must stay 0: the training path reaches no TPU kernel. ``cfg`` (default:
    TRAIN_ARCH's) lets a CPU rehearsal run a reduced config."""
    import itertools

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import chunking
    from repro_torch.data import DataConfig, lm_batches
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, OptState, Trainer, adamw_update
    from repro_torch.models.common import tree_leaves, tree_map

    on_card = dev.type == "cuda"
    cfg = cfg or get_config(TRAIN_ARCH)
    tag = f"[train] {cfg.name}"
    t_phase = time.perf_counter()
    _, sync = seeded(dev, 0)
    n_steps = TRAIN_WARM + TRAIN_TIMED
    tokens = TRAIN_BATCH * TRAIN_SEQ
    t0 = time.perf_counter()
    host = list(itertools.islice(lm_batches(cfg, DataConfig(batch=TRAIN_BATCH,
                                                             seq_len=TRAIN_SEQ, seed=0)),
                                 n_steps + 2))
    pipe_s = time.perf_counter() - t0
    log(f"{tag} data pipeline: {len(host)} batches of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"{pipe_s:.3f} s on the host ({pipe_s / len(host) * 1e3:.1f} ms a batch: one "
        f"rng.choice a token), drawn before the timed window")
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in host]
    model = build_model(cfg)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=n_steps + 3)
    trainer = Trainer(model, opt, loss_chunk=TRAIN_LOSS_CHUNK)
    t0 = time.perf_counter()
    params, state = trainer.init_state(seed=0, device=dev)
    sync()
    n_mm = matmul_params(model)
    log(f"{tag}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}; random weights from seed 0 made in "
        f"{time.perf_counter() - t0:.1f} s; N = {n_mm / 1e9:.3f}e9 matmul params; batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, loss chunk {TRAIN_LOSS_CHUNK}, remat {cfg.remat}, "
        f"AdamW lr {TRAIN_LR} (warmup {TRAIN_WARMUP})")

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0

    def reset_peak():
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    counters = (cg.LAUNCHES, chunking.LAUNCHES)
    for c in counters:
        for key in c:
            c[key] = 0
    walls, metrics = [], []
    reset_peak()
    for i in range(n_steps):
        sync()
        t0 = time.perf_counter()
        params, state, m = trainer.train_step(params, state, batches[i])
        sync()
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
    peak_on = peak_gb()
    launches = {**cg.LAUNCHES, **chunking.LAUNCHES}
    if any(launches.values()):
        fail(f"training launched chunk-gather kernels: {launches}")
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"training: non-finite loss or grad_norm: {losses} {gnorms}")
    timed = walls[TRAIN_WARM:]
    wall = sum(timed) / len(timed)
    flops = 6 * n_mm * tokens
    rate = flops / wall
    lrs = [float(m["lr"]) for m in metrics]
    log(f"{tag} losses {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(x, 3) for x in gnorms]}, lr {[float(f'{x:.3g}') for x in lrs]}")
    log(f"{tag} {TRAIN_TIMED} timed steps: {wall * 1e3:.2f} ms a step (min "
        f"{min(timed) * 1e3:.2f}, max {max(timed) * 1e3:.2f}; warm-up "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls[:TRAIN_WARM])} ms), "
        f"{tokens / wall:.0f} tokens/s; 6·N·T = {flops:.3e} FLOP a step ({8 * n_mm * tokens:.3e} "
        f"with remat's second forward): {rate / 1e12:.1f} TFLOP/s, {rate / BF16_OPS_PER_S:.1%} "
        f"of the {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s dense bf16 peak; peak memory "
        f"{peak_on:.2f} GB; launches {launches} (none)  ({card})")

    # one more step under FlopCounterMode: the products' FLOPs phase 17's
    # dry run of this step must predict
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as flop_counter:
        params, state, _ = trainer.train_step(params, state, batches[n_steps])
    step_flops = flop_counter.get_total_flops()
    log(f"{tag} FlopCounterMode over one step: {step_flops:.6e} FLOP ({step_flops} exactly)")

    profile = {}
    if on_card:
        wall_us, kernels, cpu_ops = profiled(
            lambda: (trainer.train_step(params, state, batches[n_steps]), sync()))
        busy = sum(kernels.values())
        classes = dict.fromkeys(("bf16 GEMM", "f32 GEMM (attention)", "softmax", "reduction",
                                 "elementwise", "other"), 0.0)
        for name, us in kernels.items():
            classes[train_kernel_class(name)] += us
        profile = {"wall_us": wall_us, "device_busy_us": busy,
                   "device_busy_share": busy / wall_us, "device_us_by_class": classes,
                   "launch_calls": sum(n for k, (_, n) in cpu_ops.items() if "LaunchKernel" in k),
                   "device_us": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])}
    log(f"{tag} profiled step: wall {profile.get('wall_us', 0) / 1e3:.1f} ms, device idle "
        f"{1 - profile.get('device_busy_share', 0.0):.1%}, {profile.get('launch_calls', 0)} host "
        f"launches; device ms by class: " + ", ".join(
            f"{k} {v / 1e3:.1f}" for k, v in profile.get("device_us_by_class", {}).items())
        + f"  ({card})")
    if on_card:
        gemm_ms, gemm_flop = train_gemm_ms(model, dev)
        prof_ms = profile["device_us_by_class"]["bf16 GEMM"] / 1e3
        profile["bf16_gemm_events_ms"] = gemm_ms
        log(f"{tag} bf16 products of a step, each timed alone by CUDA events at the step's "
            f"shapes: {gemm_ms:.1f} ms for {gemm_flop:.3e} FLOP, {gemm_flop / gemm_ms / 1e9:.1f} "
            f"TFLOP/s ({gemm_flop / gemm_ms / 1e-3 / BF16_OPS_PER_S:.1%} of the peak); the "
            f"profiler's bf16 GEMM sum {prof_ms:.1f} ms ({prof_ms / gemm_ms:.0%} of it)  ({card})")
    # the optimizer alone, on zero gradients (its cost does not depend on them)
    zeros = tree_map(torch.zeros_like, params)
    opt_walls = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        params, state, _ = adamw_update(opt, params, zeros, state)
        sync()
        opt_walls.append(time.perf_counter() - t0)
    del zeros
    log(f"{tag} AdamW alone: {opt_walls[-1] * 1e3:.1f} ms a step (first call "
        f"{opt_walls[0] * 1e3:.1f}), of the step's {wall * 1e3:.1f}  ({card})")

    # remat on against off from one state, kept on the host between them
    saved = (tree_map(lambda t: t.to("cpu", copy=True), params),
             tree_map(lambda t: t.to("cpu", copy=True), state.m),
             tree_map(lambda t: t.to("cpu", copy=True), state.v), state.step.clone())
    steps, moments = {}, {}
    for remat in (True, False):
        params = tree_map(lambda t: t.to(dev, copy=True), saved[0])
        state = OptState(step=saved[3].clone(), m=tree_map(lambda t: t.to(dev, copy=True),
                                                            saved[1]),
                         v=tree_map(lambda t: t.to(dev, copy=True), saved[2]))
        tr = trainer if remat else Trainer(build_model(dataclasses.replace(cfg, remat=False)),
                                           opt, loss_chunk=TRAIN_LOSS_CHUNK)
        reset_peak()
        t0 = time.perf_counter()
        params, state, m = tr.train_step(params, state, batches[n_steps + 1])
        sync()
        steps[remat] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                        "wall_s": time.perf_counter() - t0, "peak_gb": peak_gb()}
        moments[remat] = tree_map(lambda t: t.to("cpu"), state.m)  # off the peak
        del params, state
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    on, off = steps[True], steps[False]
    # the first moments after the step: b1·m + (1 - b1)·g·clip from one m,
    # so a leaf differs exactly where its gradient does
    m_on, m_off = dict(tree_leaves(moments[True])), dict(tree_leaves(moments[False]))
    m_gap = {k: float(torch.linalg.vector_norm(m_off[k] - a) / torch.linalg.vector_norm(a))
             for k, a in m_on.items()}
    m_same = all(torch.equal(a, m_off[k]) for k, a in m_on.items())
    del moments, m_on, m_off
    if off["loss"] != on["loss"] or off["grad_norm"] != on["grad_norm"] or not m_same:
        fail(f"training: remat off {off} against remat on {on}: not bitwise; first moments' "
             f"relative L2 gaps by leaf {m_gap}")
    log(f"{tag} one step from one state: remat on loss {on['loss']:.6f}, grad_norm "
        f"{on['grad_norm']:.5f}, {on['wall_s'] * 1e3:.1f} ms, peak {on['peak_gb']:.2f} GB; remat "
        f"off: loss, grad_norm and the first moments of all {len(m_gap)} leaves bitwise equal, "
        f"{off['wall_s'] * 1e3:.1f} ms, peak {off['peak_gb']:.2f} GB; phase "
        f"{time.perf_counter() - t_phase:.1f} s  ({card})")
    report["training"] = {
        "arch": cfg.name, "layers": cfg.n_layers, "slstm_layers": cfg.slstm_layers,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "matmul_params": n_mm,
        "pipeline_s": pipe_s, "walls_s": walls, "wall_per_step_s": wall,
        "tokens_per_s": tokens / wall, "flops_6nt": flops, "flop_rate": rate,
        "peak_share_bf16": rate / BF16_OPS_PER_S, "peak_gb_remat_on": peak_on,
        "peak_bytes_remat_on": peak_on * 1e9, "flop_counter_flops": step_flops,
        "losses": losses, "grad_norms": gnorms, "lrs": lrs, "profile": profile,
        "adamw_s": opt_walls[-1], "remat": steps,
        "launches": launches, "phase_s": time.perf_counter() - t_phase}
    del model, trainer, batches, saved


def train_gemm_ms(model, dev, reps=20):
    """The bf16 products of one train step of ``model`` at TRAIN_BATCH x
    TRAIN_SEQ with remat, each timed alone by CUDA events on random operands
    of the step's shapes, ``reps`` of a product in one CUDA graph: every
    layer's weight products and the head's, each twice forward (the forward and remat's recomputation; the loss chunk is
    recomputed too) and once as each backward product (dX = dY·Wᵀ,
    dW = Xᵀ·dY). A check on the profiler's per-kernel sum, which can miss
    cuBLAS's kernels. Returns (ms, FLOP)."""
    import torch

    t = TRAIN_BATCH * TRAIN_SEQ
    shapes = model.param_shapes()
    products = [(shape[-2:], math.prod(shape[:-2])) for name, (shape, *_) in shapes.items()
                if name.startswith("layers/") and len(shape) >= 3]
    head = shapes["embed"][0][::-1] if model.cfg.tie_embeddings else shapes["head"][0]
    products.append((tuple(head), 1))
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def ms(fn):
        # ``reps`` calls back to back in one CUDA graph, so no launch gap
        # counts
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        del graph
        return a.elapsed_time(b) / reps

    total = flop = 0.0
    for (k, n), count in products:
        x, w, dy = rand(t, k), rand(k, n), rand(t, n)
        total += count * (2 * ms(lambda: x @ w) + ms(lambda: dy @ w.t()) + ms(lambda: x.t() @ dy))
        flop += count * 4 * 2 * t * k * n
        del x, w, dy
    return total, flop


def train_kernel_class(name: str) -> str:
    """The class of a device kernel of a train step, by its name: cuBLAS's
    bf16 products (``nvjet``, ``bf16`` GEMMs), the f32 products of the
    attention (TF32 off), softmax, reductions, elementwise, or other."""
    low = name.lower()
    if "gemm" in low or "nvjet" in low:
        return "f32 GEMM (attention)" if "f32f32" in low or "sgemm" in low else "bf16 GEMM"
    if "softmax" in low:
        return "softmax"
    if "reduce" in low:
        return "reduction"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def train_families(dev, card, report):
    """Phase 14, the families: each of TRAIN_FAMILIES at its reduced
    config, weights made on the CPU from seed 0 and copied to ``dev``, one
    bf16 train step on each with the same batch of the pipeline: loss, ce
    and moe_aux within TRAIN_CPU_RTOL, grad_norm within
    TRAIN_CPU_GNORM_RTOL, lr equal. Then TRAIN_CKPT_ARCH's stepped params
    saved from ``dev`` and loaded into CPU tensors, bitwise."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, lm_batches
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, Trainer, init_opt_state, load_checkpoint,
                                      save_checkpoint)
    from repro_torch.models.common import tree_leaves, tree_map

    cpu = torch.device("cpu")
    rows, stepped = {}, None
    for arch in TRAIN_FAMILIES:
        cfg = get_config(arch).reduced()
        trainer = Trainer(build_model(cfg), AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10),
                          loss_chunk=TRAIN_CPU_CHUNK)
        p_cpu = trainer.model.init(seed=0, device=cpu)
        p_dev = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
        batch = next(lm_batches(cfg, DataConfig(batch=TRAIN_CPU_BATCH, seq_len=TRAIN_CPU_SEQ,
                                                seed=3)))
        out = {}
        for name, where, params in (("cpu", cpu, p_cpu), ("dev", dev, p_dev)):
            b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
            _, _, m = trainer.train_step(params, init_opt_state(params), b)
            out[name] = {k: float(v) for k, v in m.items()}
        got, want = out["dev"], out["cpu"]
        gaps = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                for k in ("loss", "ce", "moe_aux", "grad_norm", "lr")}
        bad = [k for k, g in gaps.items()
               if g > {"grad_norm": TRAIN_CPU_GNORM_RTOL, "lr": 1e-6}.get(k, TRAIN_CPU_RTOL)
               and not (k == "moe_aux" and want[k] == got[k] == 0.0)]
        if bad or not all(math.isfinite(v) for v in got.values()):
            fail(f"training {cfg.name}: card vs CPU {got} vs {want} ({bad})")
        if (got["moe_aux"] > 0) != cfg.has_moe:
            fail(f"training {cfg.name}: moe_aux {got['moe_aux']}")
        rows[cfg.name] = {"card": got, "cpu": want, "gaps": gaps}
        log(f"[train] {cfg.name}: one step card vs CPU (bf16): loss {got['loss']:.5f} / "
            f"{want['loss']:.5f}, moe_aux {got['moe_aux']:.5f}, grad_norm {got['grad_norm']:.4f} / "
            f"{want['grad_norm']:.4f}; relative gaps loss {gaps['loss']:.2e}, grad_norm "
            f"{gaps['grad_norm']:.2e} (tolerances {TRAIN_CPU_RTOL} / {TRAIN_CPU_GNORM_RTOL})")
        if arch == TRAIN_CKPT_ARCH:
            stepped = (trainer.model, p_dev)
    model, p_dev = stepped
    path = OUT / "train_ckpt"
    save_checkpoint(str(path), p_dev, step=1, extra={"saved_on": card})
    loaded, step = load_checkpoint(str(path), model.init(seed=1, device=cpu))
    pairs = list(zip(tree_leaves(loaded), tree_leaves(p_dev)))
    same = step == 1 and all(ka == kb and a.device.type == "cpu" and torch.equal(a, b.cpu())
                             for (ka, a), (kb, b) in pairs)
    shutil.rmtree(path)
    if not same:
        fail(f"training: checkpoint of {model.cfg.name} saved on {dev} does not load bitwise "
             "on the CPU")
    log(f"[train] checkpoint: {model.cfg.name}'s stepped params ({len(pairs)} leaves) saved "
        f"from {dev}, loaded on the CPU: bitwise equal")
    report["training_families"] = rows



def mesh_path(dev, cfg, card, report):
    """Phase 15: ``cfg`` at full width and depth, random weights from seed
    0, batch BATCH, prompt PROMPT, DECODE decode tokens through
    ``ServeEngine`` (chunk, sparsity 0.4, nano, the kernel backend) at
    wbits 16 and 8: without a mesh, on ``ServeMesh.create(1, 1)`` (inert),
    and on a one-rank DeviceMesh in a world-size-1 process group (NCCL on
    the card, gloo on a CPU rehearsal), which runs the sharded code path.
    Its launch counts are set to 0 just before its decode and read just
    after (exact: K1 at q, k, v, o and K2 at every layer a step, K5 once a
    refresh plus the selection timing's). A second decode call of
    PROFILE_TOKENS steps gives the wall a step (warm), a third one on the one-rank mesh
    times the operand gathers by CUDA events around each (their span holds
    the host's issue time too); then one layer's slices are gathered
    GATHER_REPS times alone under the profiler, whose sum is their device
    time. The group is destroyed at the end."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import InputShape
    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.inputs import make_dummy_batch
    from repro_torch.serving import ServeEngine
    from repro_torch.sharding import MESH_AXES, MeshRules, ServeMesh
    from repro_torch.sharding import serve as sserve

    on_card = dev.type == "cuda"
    tag = f"[mesh] {cfg.name}"
    t_phase = time.perf_counter()
    log(f"{tag}: the 2x2 (data, model) mesh runs only on the CPU (four gloo ranks, "
        "tests/test_torch_sharded_serving.py): this machine has one card and NCCL refuses two "
        "ranks on one device, so the card runs the one-rank mesh")
    _, sync = seeded(dev, 0)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    batch = make_dummy_batch(cfg, InputShape("mesh", PROMPT, BATCH, "train"), seed=0, device=dev)
    counters = (cg.LAUNCHES, chunking.LAUNCHES)
    want = {"chunk_gather_matmul_dma": 4 * cfg.n_layers * DECODE,
            "chunk_gather_mlp_dma": cfg.n_layers * DECODE,
            "greedy_select": DECODE + TIME_SELECTION_LAUNCHES}

    def serve(mesh, wbits, count=False, warm=True):
        eng = ServeEngine(model, params, max_seq=64, batch_size=BATCH, method="chunk",
                          sparsity=0.4, device="nano", backend="kernel", wbits=wbits,
                          torch_device=dev, mesh=mesh)
        tok0 = torch.argmax(eng.prefill(batch), dim=-1)[:, None]
        sync()
        if count:
            for c in counters:
                for key in c:
                    c[key] = 0
        out = eng.decode(tok0, DECODE)
        launches = {**cg.LAUNCHES, **chunking.LAUNCHES}
        if not warm:
            return eng, out, launches, None
        eng.decode(out[:, -1:].to(dev), PROFILE_TOKENS)  # warm: its wall a step
        wall = sum(s.wall_s for s in eng.stats[-PROFILE_TOKENS:]) / PROFILE_TOKENS
        return eng, out, launches, wall

    store = tempfile.mkdtemp(prefix="mesh_store_")
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"file://{os.path.join(store, 'store')}", rank=0,
                            world_size=1)
    runs = {}
    try:
        dmesh = make_mesh((1, 1), MESH_AXES, dev.type)
        one_rank = ServeMesh(1, 1, dmesh, MeshRules.for_mesh(dmesh))
        for wbits in (16, 8):
            plain, out_plain, _, wall_plain = serve(None, wbits)
            io = plain.io_summary()["io_bytes"]
            del plain
            inert = ServeMesh.create(1, 1, dev.type)
            eng, out_inert, _, _ = serve(inert, wbits, warm=False)
            ss = eng.shard_summary()
            if inert.is_sharded or not torch.equal(out_inert, out_plain):
                fail(f"{tag} w{wbits}: ServeMesh.create(1, 1) is not inert: tokens "
                     f"{out_inert.tolist()} vs {out_plain.tolist()}")
            if ss["n_shards"] != 1 or ss["io_bytes_per_shard"] != [eng.io_summary()["io_bytes"]] \
                    or any(e.shard_bytes is not None for e in eng.simulator.log):
                fail(f"{tag} w{wbits}: the inert mesh's shard summary {ss}")
            del eng
            eng, out, launches, wall = serve(one_rank, wbits, count=True)
            if on_card and launches != want:
                fail(f"{tag} w{wbits}: one-rank mesh launch counts {launches} != {want}")
            if not torch.equal(out, out_inert):
                fail(f"{tag} w{wbits}: one-rank mesh tokens {out.tolist()} != the unsharded "
                     f"mesh's {out_inert.tolist()}")
            ss = eng.shard_summary()
            io_mesh = eng.io_summary()["io_bytes"]
            sharded = [k for k, v in eng.params["layers"].items()
                       if type(v).__name__ == "DTensor"]
            if not sharded or len(ss["io_bytes_per_shard"]) != 1 \
                    or abs(sum(ss["io_bytes_per_shard"]) - io_mesh) > 1e-6 * io_mesh \
                    or abs(io_mesh - io) > 1e-6 * io \
                    or any(e.shard_bytes is None for e in eng.simulator.log):
                fail(f"{tag} w{wbits}: one-rank mesh accounting: {ss}, io_bytes {io_mesh} vs "
                     f"{io}, sharded leaves {sharded}")
            events = []
            gather = sserve.gather_shards

            def timed(w):
                if not on_card:
                    events.append(None)
                    return gather(w)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                y = gather(w)
                b.record()
                events.append((a, b))
                return y

            sserve.gather_shards = timed
            try:
                eng.decode(out[:, -1:].to(dev), PROFILE_TOKENS)  # a third call
            finally:
                sserve.gather_shards = gather
            sync()
            gather_us = (sum(a.elapsed_time(b) for a, b in events) * 1e3 / PROFILE_TOKENS
                         if on_card else None)
            # one layer's slice of every sharded leaf gathered alone, back to
            # back, under the profiler: every device event of the loop is a
            # gather's (NCCL's kernel and its copies), so their sum over the
            # reps is one layer's gathers' device time; against the copy
            # bound of those bytes (each read once and written once)
            slices = [eng.params["layers"][n][0] for n in sharded]
            n_bytes = sum(t.to_local().numel() * t.to_local().element_size() for t in slices)
            bound_us = 2 * n_bytes / HBM_BYTES_PER_S * 1e6
            layer_us, kinds = None, {}
            if on_card:
                [gather(t) for t in slices]
                _, kern, _ = profiled(lambda: ([gather(t) for t in slices
                                                for _ in range(GATHER_REPS)], sync()))
                layer_us = sum(kern.values()) / GATHER_REPS
                kinds = {k: v / GATHER_REPS for k, v in
                         sorted(kern.items(), key=lambda kv: -kv[1])[:3]}
            runs[wbits] = {"launches": launches, "wall_ms": wall * 1e3,
                           "wall_unsharded_ms": wall_plain * 1e3,
                           "gathers_per_step": len(events) / PROFILE_TOKENS,
                           "gather_event_us_per_step": gather_us,
                           "gather_device_us_per_layer": layer_us,
                           "gather_device_us_per_step": (None if layer_us is None
                                                         else layer_us * cfg.n_layers),
                           "gather_bytes_per_layer": n_bytes, "gather_bound_us_per_layer": bound_us,
                           "gather_device_events": kinds,
                           "io_bytes": io_mesh,
                           "io_bytes_per_shard": ss["io_bytes_per_shard"],
                           "sharded_leaves": len(sharded), "tokens": out.tolist()}
            gtxt = ("n/a" if gather_us is None else
                    f"{gather_us:.1f} us a step between the events around them (the host's issue "
                    f"time too); their device time {layer_us:.1f} us a layer, "
                    f"{layer_us * cfg.n_layers:.1f} us a step (each layer's slices gathered "
                    f"{GATHER_REPS} times alone, the profiler's sum: "
                    + ", ".join(f"{k[:40]} {v:.1f}" for k, v in kinds.items()) + ")")
            log(f"{tag} w{wbits}: one-rank mesh tokens identical to ServeMesh.create(1, 1)'s and "
                f"the unsharded engine's; launches {launches} (exact); io_bytes {io_mesh / 1e6:.1f} "
                f"MB = sum of the per-shard lane {ss['io_bytes_per_shard'][0] / 1e6:.1f} MB; "
                f"{len(sharded)} leaves model-sharded; decode step (warm) {wall * 1e3:.2f} ms sharded "
                f"vs {wall_plain * 1e3:.2f} ms unsharded; {len(events) / PROFILE_TOKENS:.0f} operand "
                f"gathers a step, {gtxt}; a layer's slices {n_bytes / 2**20:.1f} MiB, copy bound "
                f"{bound_us:.1f} us  ({card})")
            del eng
            if on_card:
                torch.cuda.empty_cache()
        runs["paged"] = mesh_paged(dev, cfg, model, params, one_rank, card)
    finally:
        dist.destroy_process_group()
    report["mesh"] = {"arch": cfg.name, "runs": runs, "phase_s": time.perf_counter() - t_phase}
    log(f"{tag}: phase 15 took {time.perf_counter() - t_phase:.1f} s")


def mesh_paged(dev, cfg, model, params, one_rank, card):
    """Phase 15 (c): slot mode on the one-rank mesh with the paged KV cache
    (MESH_PAGE_TOKENS a page), two requests of MESH_PAGED_PROMPT tokens
    admitted into the two slots, MESH_PAGED_TOKENS tokens decoded at wbits
    16 on the kernel backend; the same with the dense slot cache on the
    mesh and with the paged cache unsharded. The paged mesh run's K1/K2
    launches are counted from just before its decode to just after."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core import chunking
    from repro_torch.kernels import chunk_gather_dma as cg
    from repro_torch.models.inputs import make_dummy_batch
    from repro_torch.serving import ServeEngine

    tag = f"[mesh-paged] {cfg.name}"
    t0 = time.perf_counter()
    prompts = [make_dummy_batch(cfg, InputShape("req", MESH_PAGED_PROMPT, 1, "train"),
                                seed=seed, device=dev) for seed in (1, 2)]
    want = {"chunk_gather_matmul_dma": 4 * cfg.n_layers * MESH_PAGED_TOKENS,
            "chunk_gather_mlp_dma": cfg.n_layers * MESH_PAGED_TOKENS}

    def slots(mesh, page_tokens):
        eng = ServeEngine(model, params, max_seq=64, batch_size=BATCH, method="chunk",
                          sparsity=0.4, device="nano", backend="kernel", wbits=16,
                          torch_device=dev, mesh=mesh, kv_page_tokens=page_tokens)
        eng.enable_slots()
        toks = torch.cat([torch.argmax(eng.admit_slot(slot, p)[0], dim=-1)[:, None]
                          for slot, p in enumerate(prompts)])
        for c in (cg.LAUNCHES, chunking.LAUNCHES):
            for key in c:
                c[key] = 0
        out, _ = eng.decode_slots(toks, MESH_PAGED_TOKENS)
        launches = {k: cg.LAUNCHES[k] for k in want}
        return eng, out, launches

    eng, paged, launches = slots(one_rank, MESH_PAGE_TOKENS)
    ss = eng.shard_summary()
    eng.kv_pool.check()
    del eng
    _, dense, _ = slots(one_rank, None)
    _, unsharded, _ = slots(None, MESH_PAGE_TOKENS)
    if not torch.equal(paged, dense) or not torch.equal(paged, unsharded):
        fail(f"{tag}: paged tokens on the one-rank mesh {paged.tolist()} != the dense slot "
             f"cache's {dense.tolist()} or the unsharded paged engine's {unsharded.tolist()}")
    if dev.type == "cuda" and launches != want:
        fail(f"{tag}: launch counts {launches} != {want}")
    if sum(ss["kv_pages_per_shard"]) != ss["kv_pages_in_use"] or not ss["kv_pages_in_use"]:
        fail(f"{tag}: kv_pages_per_shard {ss['kv_pages_per_shard']} does not sum to "
             f"kv_pages_in_use {ss['kv_pages_in_use']}")
    out = {"tokens": paged.tolist(), "launches": launches,
           "kv_pages_per_shard": ss["kv_pages_per_shard"],
           "kv_pages_in_use": ss["kv_pages_in_use"], "s": time.perf_counter() - t0}
    log(f"{tag}: 2 slots x {MESH_PAGED_TOKENS} tokens, {MESH_PAGE_TOKENS}-token pages: tokens "
        f"equal the dense slot cache's on the mesh and the unsharded paged engine's; launches "
        f"{launches} (exact); kv_pages_per_shard {ss['kv_pages_per_shard']} = "
        f"{ss['kv_pages_in_use']} pages in use; {out['s']:.1f} s  ({card})")
    return out


def dry_steps():
    """Phase 14's step and phase 18's two as their reports name them
    (DRYRUN_CODE's ``steps``), known before they run."""
    from repro_torch.configs import get_config

    train = get_config(TRAIN_ARCH)
    xlstm = dataclasses.replace(get_config(XLSTM_TRAIN_ARCH), n_layers=XLSTM_TRAIN_LAYERS,
                                slstm_layers=XLSTM_TRAIN_SLSTM)
    return [{"arch": c.name, "batch": b, "seq": s, "layers": c.n_layers,
             "slstm_layers": list(c.slstm_layers)}
            for c, b, s in ((train, TRAIN_BATCH, TRAIN_SEQ),
                            (xlstm, XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ),
                            (xlstm, XLSTM_CHECK_BATCH, XLSTM_CHECK_SEQ))]


def start_dryrun(steps):
    """Phase 17's subprocess on DRYRUN_PAIRS and ``steps``, started now
    (DRYRUN_CODE; the fake process group is its process's one default
    group), its output into temporary files: (its start, the process,
    ``steps``, the files). It is killed at exit if it still runs (a phase
    failed first)."""
    import atexit
    import os
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_CODE, json.dumps(DRYRUN_PAIRS),
                             json.dumps(steps)], env=env, stdout=out, stderr=err, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return time.perf_counter(), proc, steps, (out, err)


def shape_cache_bytes(cfg, shape, dp=16, tp=16):
    """A prefill pair's whole cache and one rank's share of it, in bytes,
    from the config's shapes alone (not from the port's cache layout or
    its placements): a dense or MoE decoder's K and V, (L, b, S, kv, hd)
    in bf16, the batch over 'data' where dp divides it and the kv heads
    over 'model' where tp divides them, else the sequence; xLSTM's states
    in f32, mLSTM (C (b, h, dh, dh), n (b, h, dh), m (b, h)) with the heads
    over 'model' where tp divides them, the sLSTM's four (b, d), the batch
    over 'data'."""
    b, seq = shape.global_batch, shape.seq_len
    rows = dp if b % dp == 0 else 1
    leaves = []  # (whole bytes, ranks)
    if cfg.slstm_layers or cfg.name.startswith("xlstm"):
        d, h = cfg.d_model, cfg.n_heads
        dh = 2 * d // h
        heads = tp if h % tp == 0 else 1
        for i in range(cfg.n_layers):
            if i in cfg.slstm_layers:
                leaves += [(b * d * 4, rows)] * 4
            else:
                leaves += [(b * h * dh * dh * 4, rows * heads), (b * h * dh * 4, rows * heads),
                           (b * h * 4, rows * heads)]
    else:
        kv, hd = cfg.n_cache_kv_heads, cfg.resolved_head_dim
        over = tp if kv % tp == 0 or seq % tp == 0 else 1
        leaves += [(cfg.n_layers * b * seq * kv * hd * 2, rows * over)] * 2
    return sum(n for n, _ in leaves), sum(n // r for n, r in leaves)


def dryrun_path(card, report, started=None):
    """Phase 17: the dry run (``start_dryrun``'s subprocess: ``started``,
    begun before the card's phases on ``dry_steps()``, or begun now):
    DRYRUN_PAIRS, then phase 14's step and phase 18's (where they ran) on a
    fake 1×1 mesh. Each report is printed with its per-rank peak; a
    prefill's output bytes a rank are held to its cache's bytes over
    DRYRUN_CACHE_RANKS plus the last logits; for the steps the predicted
    FLOPs must equal the real step's FlopCounterMode count and the
    predicted peak memory must lie within DRYRUN_PEAK_RATIO of the
    measured one."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import get_shape

    tag = "[dryrun]"
    t0 = time.perf_counter()
    real = [(name, report[name]) for name in ("training", "xlstm_training", "xlstm_check")
            if name in report]
    steps = json.loads(json.dumps([{k: r[k] for k in ("arch", "batch", "seq", "layers",
                                                      "slstm_layers")} for _, r in real]))
    t_start, proc, planned, (out_f, err_f) = started or start_dryrun(steps)
    if planned != steps:
        fail(f"{tag} the dry run was started on the steps {planned}, not on those that ran: "
             f"{steps}")
    try:
        proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"{tag} the dry run did not finish within 900 s of phase 17's start")
    out_f.seek(0)
    err_f.seek(0)
    out, err = out_f.read(), err_f.read()
    if proc.returncode != 0:
        fail(f"{tag} the dry run failed (rc {proc.returncode}): {err[-3000:]}")
    reps = [json.loads(line[len("DRYRUN "):]) for line in out.splitlines()
            if line.startswith("DRYRUN ")]
    if len(reps) != len(DRYRUN_PAIRS) + len(steps):
        fail(f"{tag} expected {len(DRYRUN_PAIRS) + len(steps)} reports: {out[-3000:]}")
    log(f"{tag} the subprocess started {time.perf_counter() - t_start:.1f} s before phase 17 "
        f"read its reports, having waited {time.perf_counter() - t0:.1f} s for it; its traces "
        f"took {sum(r['trace_s'] for r in reps):.1f} s")
    for rep in reps:
        log(f"{tag} {json.dumps(rep)}")
    for rep in reps[:len(DRYRUN_PAIRS)]:
        log(f"{tag} {rep['arch']}/{rep['shape']} at {rep['n_layers']} layers, fake (16, 16): "
            f"per-rank peak {rep['memory']['peak_bytes'] / 1e9:.3f} GB, "
            f"{rep['flops_per_device']:.4e} FLOP, {rep['collective_bytes_per_device'] / 1e9:.3f} "
            f"GB of collectives, trace {rep['trace_s']:.1f} s")
        key = (rep["arch"], rep["shape"], rep["n_layers"])
        if rep.get("slstm_flops"):
            # the sLSTM scans' forward products (the backward runs outside
            # the region), split over all 256 ranks
            xc, shp = get_config(rep["arch"]), get_shape(rep["shape"])
            n_s = sum(1 for i in xc.slstm_layers if i < rep["n_layers"])
            sdh = xc.d_model // xc.n_heads
            n_steps = 1 if shp.kind == "decode" else shp.seq_len
            one = n_s * 2 * shp.global_batch * n_steps * xc.n_heads * sdh * 4 * sdh
            log(f"{tag} {rep['arch']}/{rep['shape']}: the sLSTM scans' forward "
                f"{rep['slstm_flops']:.4e} FLOP a rank; at 1x1 {one:.4e}, over 256 "
                f"{one / 256:.4e}")
            if rep["slstm_flops"] * 256 != one:
                fail(f"{tag} {rep['arch']}/{rep['shape']}: the sLSTM scans count "
                     f"{rep['slstm_flops']} FLOP a rank, not 1/256 of {one}")
        if key in DRYRUN_REF_FLOPS:
            ref = DRYRUN_REF_FLOPS[key]
            gap = rep["flops_per_device"] / ref - 1
            log(f"{tag} {rep['arch']}/{rep['shape']} at {rep['n_layers']} layers: "
                f"{rep['flops_per_device']:.6e} FLOP a rank against the reference's "
                f"{ref:.6e}: {100 * gap:+.3f} % (allowed {100 * DRYRUN_REF_RTOL:.1f} %)")
            if abs(gap) > DRYRUN_REF_RTOL:
                fail(f"{tag} {rep['arch']}/{rep['shape']}: FLOPs a rank "
                     f"{rep['flops_per_device']} are {100 * gap:+.3f} % off the reference's "
                     f"{ref}")
        if "cache_block_bytes" in rep:
            # a prefill's output: its cache, the whole over the ranks its
            # shapes divide it over, and the last logits (the peak printed
            # beside the whole cache)
            name = f"{rep['arch']}/{rep['shape']}"
            ranks = DRYRUN_CACHE_RANKS.get((rep["arch"], rep["shape"]))
            if ranks is None:
                fail(f"{tag} {name}: no entry in DRYRUN_CACHE_RANKS")
            out, whole = rep["memory"]["output_bytes"], rep["cache_whole_bytes"]
            allowed = whole / ranks + rep["logits_bound_bytes"]
            log(f"{tag} {name}: output {out / 1e9:.4f} GB a rank against the whole cache over "
                f"{ranks} ranks {whole / ranks / 1e9:.4f} GB (the placements' blocks "
                f"{rep['cache_block_bytes'] / 1e9:.4f} GB) + the logits' bound "
                f"{rep['logits_bound_bytes'] / 1e9:.4f} GB; peak "
                f"{rep['memory']['peak_bytes'] / 1e9:.3f} GB against the whole cache's "
                f"{whole / 1e9:.3f} GB")
            if rep["cache_block_bytes"] * ranks != whole:
                fail(f"{tag} {name}: the placements' blocks ({rep['cache_block_bytes']} bytes) "
                     f"are not the whole cache ({whole}) over {ranks} ranks")
            # the same from the shapes alone, leaf by leaf
            cfg = dataclasses.replace(get_config(rep["arch"]), n_layers=rep["n_layers"])
            s_whole, s_block = shape_cache_bytes(cfg, get_shape(rep["shape"]))
            log(f"{tag} {name}: from the shapes alone the cache is {s_whole / 1e9:.4f} GB, "
                f"{s_block / 1e9:.4f} GB a rank")
            if (s_whole, s_block) != (whole, rep["cache_block_bytes"]) or \
                    s_block * ranks != s_whole:
                fail(f"{tag} {name}: the shapes give the cache {s_whole} bytes and a rank "
                     f"{s_block}; the port's layout {whole} and its placements' blocks "
                     f"{rep['cache_block_bytes']}; DRYRUN_CACHE_RANKS {ranks}")
            if out > allowed:
                fail(f"{tag} {name}: a rank's output holds {out} bytes, more than the whole "
                     f"cache over {ranks} ranks and the logits ({allowed:.0f})")
    ratios = {}
    for (name, r), step, mine in zip(real, steps, reps[len(DRYRUN_PAIRS):]):
        predicted, measured = mine["memory"]["peak_bytes"], r["peak_bytes_remat_on"]
        ratio = ratios[name] = predicted / measured
        log(f"{tag} the {name} step ({step['arch']} at {step['layers']} layers, batch "
            f"{step['batch']} x {step['seq']}, remat, 1x1): predicted {mine['flops_per_device']} "
            f"FLOP against FlopCounterMode's {r['flop_counter_flops']} on the real step; "
            f"predicted peak {predicted / 1e9:.3f} GB against the measured max_memory_allocated "
            f"{measured / 1e9:.3f} GB: ratio {ratio:.4f}; trace {mine['trace_s']:.1f} s  ({card})")
        if r["flop_counter_flops"] is not None and \
                mine["flops_per_device"] != r["flop_counter_flops"]:
            fail(f"{tag} {name}: predicted FLOPs {mine['flops_per_device']} != the real step's "
                 f"{r['flop_counter_flops']}")
        if not DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1]:
            fail(f"{tag} {name}: peak-memory ratio {ratio:.4f} outside {DRYRUN_PEAK_RATIO}")
    log(f"{tag} phase 17 took {time.perf_counter() - t0:.1f} s  ({card})")
    report["dryrun"] = {"reports": reps, "peak_ratio": ratios,
                        "phase_s": time.perf_counter() - t0}


def xlstm_train_path(dev, card, report, cfg=None, batch=XLSTM_TRAIN_BATCH, seq=XLSTM_TRAIN_SEQ,
                     check=(XLSTM_CHECK_BATCH, XLSTM_CHECK_SEQ)):
    """Phase 18: XLSTM_TRAIN_ARCH at full width and XLSTM_TRAIN_LAYERS blocks
    through ``Trainer.train_step``, random weights from seed 0: one step at
    batch x seq with the config's chunk, timed by the host clock around a
    synchronised step, its peak memory from its start; then at ``check``
    one step with the config's chunk under FlopCounterMode and one with a
    single chunk as long as the sequence, from the seed-0 state: loss,
    grad_norm and the first moments bitwise equal. ``cfg`` lets a CPU
    rehearsal run a reduced config."""
    import itertools

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, lm_batches
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import AdamWConfig, Trainer

    on_card = dev.type == "cuda"
    cfg = cfg or dataclasses.replace(get_config(XLSTM_TRAIN_ARCH), n_layers=XLSTM_TRAIN_LAYERS,
                                     slstm_layers=XLSTM_TRAIN_SLSTM)
    tag = f"[xlstm-train] {cfg.name}"
    t_phase = time.perf_counter()
    _, sync = seeded(dev, 0)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)

    def step_from_seed(b, s, chunk=None, count=False):
        """One step at b x s from the seed-0 state (the model's scans at
        ``chunk``, default the config's), timed from a synchronised start:
        its metrics, wall, peak memory from its start, FLOPs (``count``)
        and first moments on the host."""
        model = build_model(cfg)
        if chunk is not None:
            model._impl.xcfg = dataclasses.replace(model._impl.xcfg, chunk=chunk)
        trainer = Trainer(model, opt, loss_chunk=TRAIN_LOSS_CHUNK)
        host = next(itertools.islice(lm_batches(cfg, DataConfig(batch=b, seq_len=s, seed=0)), 1))
        data = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        params, state = trainer.init_state(seed=0, device=dev)
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        counter = FlopCounterMode(display=False) if count else contextlib.nullcontext()
        t0 = time.perf_counter()
        with counter:
            _, state, m = trainer.train_step(params, state, data)
        sync()
        out = {"arch": cfg.name, "layers": cfg.n_layers, "slstm_layers": cfg.slstm_layers,
               "batch": b, "seq": s, "chunk": model._impl.xcfg.chunk,
               "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "wall_s": time.perf_counter() - t0,
               "peak_bytes_remat_on": torch.cuda.max_memory_allocated() if on_card else 0,
               "flop_counter_flops": counter.get_total_flops() if count else None}
        if not (math.isfinite(out["loss"]) and math.isfinite(out["grad_norm"])):
            fail(f"{tag}: non-finite loss or grad_norm at {b} x {s}: {out}")
        return out, {k: v.to("cpu") for k, v in tree_leaves(state.m)}

    main, _ = step_from_seed(batch, seq)
    log(f"{tag}: {cfg.n_layers} blocks (sLSTM at {list(cfg.slstm_layers)}), d_model "
        f"{cfg.d_model}, batch {batch} x {seq}, chunk {main['chunk']}: one step "
        f"{main['wall_s']:.2f} s, loss {main['loss']:.4f}, grad_norm {main['grad_norm']:.4f}, "
        f"peak memory {main['peak_bytes_remat_on'] / 1e9:.3f} GB from the step's start  ({card})")

    # the config's chunk against one chunk as long as the sequence
    b, s = check
    grain, grain_m = step_from_seed(b, s, count=True)
    whole_seq, whole_m = step_from_seed(b, s, chunk=s)
    same = (grain["loss"] == whole_seq["loss"] and grain["grad_norm"] == whole_seq["grad_norm"]
            and all(torch.equal(v, whole_m[k]) for k, v in grain_m.items()))
    if not same:
        gaps = {k: float((v - whole_m[k]).abs().max()) for k, v in grain_m.items()}
        fail(f"{tag}: chunk {grain['chunk']} against one chunk of {s} at {b} x {s}: loss "
             f"{grain['loss']} / {whole_seq['loss']}, grad_norm {grain['grad_norm']} / "
             f"{whole_seq['grad_norm']}, first moments' max abs gaps {gaps}")
    log(f"{tag}: {b} x {s}, chunk {grain['chunk']} against one chunk of {s}: loss "
        f"{grain['loss']:.6f}, grad_norm {grain['grad_norm']:.6f} and the first moments of all "
        f"{len(grain_m)} leaves bitwise equal; peak {grain['peak_bytes_remat_on'] / 1e9:.3f} / "
        f"{whole_seq['peak_bytes_remat_on'] / 1e9:.3f} GB, {whole_seq['wall_s']:.2f} s a step "
        f"with one chunk; FlopCounterMode over the chunk-{grain['chunk']} step: "
        f"{grain['flop_counter_flops']} FLOP ({grain['wall_s']:.1f} s under the counter); phase "
        f"{time.perf_counter() - t_phase:.1f} s  ({card})")
    report["xlstm_training"] = main
    report["xlstm_check"] = {**grain, "one_chunk": whole_seq}
    report["xlstm_phase_s"] = time.perf_counter() - t_phase


def mesh_train_path(dev, card, report, cfgs=None, attn_shape=SEQ_ATTN_SHAPE,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """Phase 16: training on a (1, 1) ("data", "model") DeviceMesh in a
    world-size-1 process group (NCCL on the card, gloo on a CPU rehearsal),
    through ``Trainer`` under ``use_rules`` (the entry point of ``python -m
    repro_torch.launch.train --mesh``). ``cfgs`` = (dense, MoE) configs
    (default: MESH_TRAIN_ARCH, and MESH_MOE_ARCH cut to MESH_MOE_LAYERS
    layers) lets a CPU rehearsal run reduced ones.

    1. The dense model with FSDP rules: MESH_TRAIN_STEPS steps on the mesh
       (params placed by ``param_axes()``) and as many unsharded, same seed
       and batches; each step's metrics against the unsharded step's (the
       max abs difference printed; each within METRIC_RTOL), its wall and
       its peak memory from its start; the DTensor leaves counted; the
       host's kernel launches of one profiled mesh step.
    2. The MoE model with the ``ep_shard_map`` dispatch, one step at
       capacity factor 8.0 (no drops) against the ``gather`` dispatch's
       unsharded step on the same weights and batch; the all_to_all
       launches counted (zero means the gather fallback ran); then both at
       the config's own factor, their losses and dropped assignments.
    3. ``_seq_sharded_attention`` on q, k, v of ``attn_shape`` bf16 against
       ``_blockwise_attention`` at offset 0: max abs error, device µs."""
    import dataclasses
    import itertools
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, lm_batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, build_model, moe
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding import MeshRules, use_rules
    from repro_torch.training import AdamWConfig, Trainer

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    dense_cfg, moe_cfg = cfgs or (get_config(MESH_TRAIN_ARCH), dataclasses.replace(
        get_config(MESH_MOE_ARCH), n_layers=MESH_MOE_LAYERS))
    _, sync = seeded(dev, 0)
    out = {}

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0

    def run(cfg, rules, batches, lr=TRAIN_LR, warmup=TRAIN_WARMUP):
        """Steps of a fresh seed-0 state over ``batches``: (metrics per
        step as floats, wall per step s, peak GB per step, the trainer, the
        state)."""
        trainer = Trainer(build_model(cfg), AdamWConfig(lr=lr, warmup_steps=warmup,
                                                        total_steps=len(batches) + 3),
                          loss_chunk=TRAIN_LOSS_CHUNK)
        with use_rules(rules):
            params, state = trainer.init_state(seed=0, device=dev, rules=rules)
            metrics, walls, peaks = [], [], []
            for b in batches:
                sync()
                if on_card:
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                params, state, m = trainer.train_step(params, state, b)
                sync()
                walls.append(time.perf_counter() - t0)
                peaks.append(peak_gb())
                metrics.append({k: float(v) for k, v in m.items()})
        return metrics, walls, peaks, trainer, (params, state)

    def held(name, got, want, keys):
        """The max abs difference of each metric over the steps; fails past
        METRIC_RTOL or on a non-finite value."""
        diffs = {}
        for k in keys:
            for g, w in zip(got, want):
                if not (math.isfinite(g[k]) and math.isfinite(w[k])):
                    fail(f"[mesh-train] {name}: non-finite {k}: {g[k]} vs {w[k]}")
                if abs(g[k] - w[k]) > METRIC_RTOL[k] * abs(w[k]) + 1e-12:
                    fail(f"[mesh-train] {name}: {k} {g[k]} vs {w[k]} beyond rel "
                         f"{METRIC_RTOL[k]}")
            diffs[k] = max(abs(g[k] - w[k]) for g, w in zip(got, want))
        return diffs

    store = tempfile.mkdtemp(prefix="mesh_train_store_")
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"file://{os.path.join(store, 'store')}", rank=0,
                            world_size=1)
    try:
        dmesh = make_mesh((1, 1), ("data", "model"), dev.type)

        # 1. the dense model, FSDP rules, against the unsharded steps
        tag = f"[mesh-train] {dense_cfg.name}"
        host = itertools.islice(lm_batches(dense_cfg, DataConfig(batch=batch, seq_len=seq,
                                                                 seed=0)), MESH_TRAIN_STEPS)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in host]
        def launches(trainer, params, opt, rules):
            """The host's kernel launches in one profiled step."""
            if not on_card:
                return None
            with use_rules(rules):
                _, _, cpu_ops = profiled(lambda: (trainer.train_step(params, opt, batches[0]),
                                                  sync()))
            return sum(n for k, (_, n) in cpu_ops.items() if "LaunchKernel" in k)

        plain, walls_plain, peaks_plain, trainer, state = run(dense_cfg, None, batches)
        launches_plain = launches(trainer, *state, None)
        del state, trainer
        rules = MeshRules.for_mesh(dmesh, fsdp=True)
        mesh, walls_mesh, peaks_mesh, trainer, (params, opt) = run(dense_cfg, rules, batches)
        diffs = held(dense_cfg.name, mesh, plain, ("loss", "ce", "grad_norm"))
        n_dt = sum(isinstance(v, DTensor) for _, v in tree_leaves(params))
        n_leaves = len(list(tree_leaves(params)))
        if n_dt != n_leaves:
            fail(f"{tag}: {n_dt} of {n_leaves} param leaves are DTensors")
        launches_mesh = launches(trainer, params, opt, rules)
        del params, opt, trainer
        if on_card:
            torch.cuda.empty_cache()
        log(f"{tag}: {dense_cfg.n_layers} layers, batch {batch} x {seq}, remat, FSDP rules on the "
            f"(1, 1) mesh; {n_dt} of {n_leaves} leaves DTensors; losses mesh "
            f"{[m['loss'] for m in mesh]} vs unsharded {[m['loss'] for m in plain]}; max abs "
            f"diff " + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
            + f"; wall a step mesh {[round(w * 1e3, 1) for w in walls_mesh]} ms vs unsharded "
            f"{[round(w * 1e3, 1) for w in walls_plain]} ms; peak memory mesh "
            f"{[round(x, 2) for x in peaks_mesh]} GB vs {[round(x, 2) for x in peaks_plain]} GB; "
            f"host kernel launches of one profiled step mesh {launches_mesh} vs unsharded "
            f"{launches_plain}  ({card})")
        out["dense"] = {"arch": dense_cfg.name, "mesh": mesh, "unsharded": plain,
                        "max_abs_diff": diffs, "wall_ms_mesh": [w * 1e3 for w in walls_mesh],
                        "wall_ms_unsharded": [w * 1e3 for w in walls_plain],
                        "peak_gb_mesh": peaks_mesh, "peak_gb_unsharded": peaks_plain,
                        "dtensor_leaves": n_dt, "launches_profiled_step_mesh": launches_mesh,
                        "launches_profiled_step_unsharded": launches_plain}

        # 2. expert parallelism over all_to_all against the gather dispatch
        ep_cfg = moe_cfg.optimized_for(1)
        tag = f"[mesh-train] {ep_cfg.name} ({ep_cfg.n_layers} layers)"
        if ep_cfg.moe_dispatch != "ep_shard_map":
            fail(f"{tag}: optimized_for(1) gives dispatch {ep_cfg.moe_dispatch!r}")
        mb = next(lm_batches(ep_cfg, DataConfig(batch=MESH_MOE_BATCH, seq_len=seq, seed=0)))
        moe_batches = [{k: torch.from_numpy(v).to(dev) for k, v in mb.items()}]
        ep_rules = MeshRules.for_mesh(dmesh)
        runs = {}
        for factor in (8.0, ep_cfg.moe_capacity_factor):
            for name, cfg, r in (("ep", ep_cfg, ep_rules),
                                 ("gather", dataclasses.replace(ep_cfg, moe_dispatch="gather"),
                                  None)):
                cfg = dataclasses.replace(cfg, moe_capacity_factor=factor)
                for key in moe.ALL_TO_ALL_COUNT:
                    moe.ALL_TO_ALL_COUNT[key] = 0
                moe.DROP_LOG = []
                try:
                    m, w, pk, _, state = run(cfg, r, moe_batches)
                    drops = int(sum(int(x) for x in moe.DROP_LOG))
                finally:
                    moe.DROP_LOG = None
                del state
                runs[(factor, name)] = {"metrics": m[0], "wall_ms": w[0] * 1e3, "peak_gb": pk[0],
                                        "all_to_all": dict(moe.ALL_TO_ALL_COUNT),
                                        "dropped": drops}
                if on_card:
                    torch.cuda.empty_cache()
        a2a = runs[(8.0, "ep")]["all_to_all"]
        if a2a["forward"] == 0:
            fail(f"{tag}: no all_to_all launched: the gather fallback ran")
        # 3 a MoE layer forward, 3 more in remat's recomputation, 2 backward
        want_a2a = {"forward": 6 * ep_cfg.n_layers, "backward": 2 * ep_cfg.n_layers}
        if runs[(8.0, "gather")]["all_to_all"]["forward"]:
            fail(f"{tag}: the gather dispatch launched all_to_all")
        moe_diffs = held(f"{ep_cfg.name} ep vs gather at capacity 8.0",
                         [runs[(8.0, "ep")]["metrics"]], [runs[(8.0, "gather")]["metrics"]],
                         ("loss", "ce", "moe_aux", "grad_norm"))
        own = ep_cfg.moe_capacity_factor
        log(f"{tag}: batch {MESH_MOE_BATCH} x {seq}, {ep_cfg.n_experts} experts top-"
            f"{ep_cfg.moe_top_k}; ep_shard_map on the (1, 1) mesh: all_to_all_single "
            f"{a2a['forward']} forward + {a2a['backward']} backward a step (predicted {want_a2a}: "
            f"3 a layer forward, 3 in remat's recomputation, 2 backward); at capacity 8.0 against "
            f"gather: max abs diff " + ", ".join(f"{k} {v:.3e}" for k, v in moe_diffs.items())
            + f", dropped {runs[(8.0, 'ep')]['dropped']} / {runs[(8.0, 'gather')]['dropped']}; "
            f"at {own}: loss ep {runs[(own, 'ep')]['metrics']['loss']:.5f} gather "
            f"{runs[(own, 'gather')]['metrics']['loss']:.5f}, dropped assignments ep "
            f"{runs[(own, 'ep')]['dropped']} gather {runs[(own, 'gather')]['dropped']}; step wall "
            f"ep {runs[(8.0, 'ep')]['wall_ms']:.1f} ms gather "
            f"{runs[(8.0, 'gather')]['wall_ms']:.1f} ms at 8.0, peak "
            f"{runs[(8.0, 'ep')]['peak_gb']:.2f} / {runs[(8.0, 'gather')]['peak_gb']:.2f} GB  "
            f"({card})")
        out["moe"] = {"arch": ep_cfg.name, "layers": ep_cfg.n_layers, "max_abs_diff": moe_diffs,
                      "runs": {f"{f}/{n}": v for (f, n), v in runs.items()}}

        # 3. the sequence-sharded attention at StarCoder2-7B's shape
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(attn_shape, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        seq_rules = dataclasses.replace(MeshRules.for_mesh(dmesh), seq_shard_attention=True)
        with use_rules(seq_rules):
            qd, kd, vd = (seq_rules.distribute(t, ("batch", "act_seq", "heads", "head_dim"))
                          for t in (q, k, v))

            def sharded():
                return attention._seq_sharded_attention(qd, kd, vd, None)

            got = sharded().full_tensor()
        want = attention._blockwise_attention(q, k, v, 0, True, None)
        err = float((got.float() - want.float()).abs().max())
        if not math.isfinite(err) or err > 0:
            fail(f"[mesh-train] sequence-sharded attention {attn_shape}: max abs err {err} on "
                 "one rank, where the local computation is the blockwise one's")
        us = {}
        if on_card:
            with use_rules(seq_rules):
                _, kern_s, _ = profiled(lambda: (sharded(), sync()))
            _, kern_b, _ = profiled(lambda: (attention._blockwise_attention(q, k, v, 0, True,
                                                                            None), sync()))
            us = {"seq_sharded": sum(kern_s.values()), "blockwise": sum(kern_b.values())}
        log(f"[mesh-train] sequence-sharded attention q, k, v {attn_shape} bf16 causal on the "
            f"(1, 1) mesh against the blockwise attention at offset 0: max abs err {err:.3e}; "
            f"device us {us or 'n/a'}  ({card})")
        out["seq_attention"] = {"shape": attn_shape, "max_abs_err": err, "device_us": us}
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    report["mesh_train"] = out
    log(f"[mesh-train]: phase 16 took {out['phase_s']:.1f} s  ({card})")


if __name__ == "__main__":
    main()
