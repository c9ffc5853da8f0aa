"""The rank side of tests/test_torch_sharded_serving.py: what each of the
four spawned gloo ranks of a 2×2 (data, model) serve mesh runs, the 1×1
runs the test module holds them to, and the settings both share. It
imports only the port (a spawned rank imports this module, not the test
module, whose recount tests import the JAX package), so chip_smoke.py's
phase 19 runs it too.

The settings are the reference's ``tests/test_sharded_serving.py``:
reduced InternVL2-76B, ``max_seq`` 64, batch 2, ``nano``, sparsity 0.5,
chunk, seed 5, refresh every 2, ``cache_mb`` 2.0, 6 tokens, both backends
(their plain versions on CPU tensors) at wbits 16 and 8. The full-width
cases of ``tests/test_torch_sharded_full_width.py`` (``WIDE_CASES``,
``_wide_serve``, ``hold_wide``) live here too, for phase 19.
"""
import contextlib
import dataclasses
import datetime
import io
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.inputs import make_dummy_batch
from repro_torch.serving import (
    PoissonArrivalDriver,
    Request,
    Scheduler,
    ServeEngine,
    SparseExecution,
)
from repro_torch.serving.sparse_exec import plan_transfer_bytes
from repro_torch.sharding import ServeMesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_procs import drain  # noqa: E402

WORLD = 4
CASES = [(b, w) for b in ("reference", "kernel") for w in (16, 8)]
SMOKE = InputShape(name="smoke", seq_len=16, global_batch=2, kind="train")
ENGINE = dict(max_seq=64, batch_size=2, device="nano", sparsity=0.5, method="chunk", seed=5,
              plan_refresh_interval=2, cache_mb=2.0, torch_device="cpu")
N_TOKENS = 6
# byte totals are f32 counter sums
RTOL = 1e-6
CLI = ["--arch", "internvl2-76b", "--reduced", "--torch-device", "cpu", "--decode-tokens", "3",
       "--max-seq", "64", "--prompt-len", "8", "--frames", "1", "--backend", "kernel"]
# the CLI's continuous batching with paged KV, on a MoE arch
CLI_STREAMS = ["--arch", "olmoe-1b-7b", "--reduced", "--torch-device", "cpu", "--streams", "4",
               "--batch", "2", "--kv-page-tokens", "8", "--max-seq", "32", "--prompt-len", "8",
               "--decode-tokens", "3", "--arrival-rate", "300"]
MOE_CASES = [(a, w) for a in ("olmoe-1b-7b", "llama4-scout-17b-a16e") for w in (16, 8)]


def _vlm():
    cfg = get_config("internvl2-76b").reduced()
    model = build_model(cfg)
    return cfg, model, model.init(seed=0, device="cpu")


def _run(cfg, model, params, mesh, backend, wbits):
    """Prefill → 6 greedy tokens; the engine and the tokens, with every
    refresh's pre-refresh residency scores and post-refresh masks captured
    (the recount's inputs)."""
    eng = ServeEngine(model, params, backend=backend, wbits=wbits, mesh=mesh, **ENGINE)
    ctx = eng.sparse_ctx
    captured = []
    refresh_step = ctx.refresh_step

    def capture(plan, refresh, weights=None):
        pre = {k: plan[k]["score"].clone() for k in plan} if refresh else None
        lat = refresh_step(plan, refresh, weights)
        if refresh:
            captured.append({k: (pre[k].numpy(), plan[k]["mask"].numpy().copy()) for k in plan})
        return lat

    ctx.refresh_step = capture
    last = eng.prefill(make_dummy_batch(cfg, SMOKE, seed=0, device="cpu"))
    out = eng.decode(torch.argmax(last, -1)[:, None], N_TOKENS)
    return eng, out.numpy(), captured


def _summary(eng, out, captured):
    ctx = eng.sparse_ctx
    plan = eng._plan
    return {
        "tokens": out,
        "selection": {k: (v["pending"].numpy(), v["mask"].numpy()) for k, v in plan.items()},
        "io_bytes": eng.io_summary()["io_bytes"],
        "shard": eng.shard_summary(),
        "n_shards": eng.n_shards,
        "row_shards": dict(ctx.row_shards),
        "lanes": {k: {key: tuple(v[key].shape) for key in ("hit_shard", "miss_shard")
                      if key in v} for k, v in plan.items()},
        "plan_shard_bytes": ctx.plan_shard_bytes(plan).numpy(),
        "plan_bytes": float(plan_transfer_bytes(plan)),
        "events": [(e.name, e.nbytes, e.shard_bytes) for e in eng.simulator.log],
        "captured": captured,
        "caps": dict(ctx.cache_caps),
        "row_bytes": {k: ctx.site_row_bytes(k) for k in ctx.site_order},
        "prefill_bytes": ctx.sparsifiable_bytes(eng.model.cfg.n_layers),
    }


def _refusals(cfg, mesh):
    """The messages of what a sharded mesh refuses."""
    out = {}
    for name, fn in (
        ("reorderings", lambda: SparseExecution(cfg, sparsity=0.5, reorderings={"ffn": object()},
                                                mesh=mesh, torch_device="cpu")),
        ("corruption", lambda: SparseExecution(cfg, sparsity=0.5, corruption_profile="bit_rot",
                                               mesh=mesh, torch_device="cpu")),
    ):
        try:
            fn()
            out[name] = None
        except ValueError as err:
            out[name] = str(err)
    return out


def _slots(cfg, model, params, mesh):
    """Continuous batching on the dense slot cache: four requests of a
    vision + text prompt through the two slots (one per data rank on the
    2×2 mesh), the kernel backend at wbits 8. Each request's tokens, the
    scheduler's row and the shard summary."""
    eng = ServeEngine(model, params, backend="kernel", wbits=8, mesh=mesh, **ENGINE)
    base = make_dummy_batch(cfg, InputShape("req", 8, 1, "train"), seed=0, device="cpu")
    rng = np.random.default_rng(0)

    def make_request(rid):
        prompt = dict(base)
        prompt["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                         tuple(base["tokens"].shape)))
        return Request(rid=rid, prompt=prompt, max_new_tokens=4)

    sched = Scheduler(eng, round_tokens=2)
    sched.submit(PoissonArrivalDriver(300.0, make_request, seed=1).generate(4))
    stats = sched.run()
    return {"tokens": {r.rid: list(r.tokens_out) for r in sched.finished}, "row": stats.row(),
            "io_bytes": eng.io_summary()["io_bytes"], "shard": eng.shard_summary()}


def _lm(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    return cfg, model, model.init(seed=0, device="cpu")


def _paged_prompts(cfg):
    """The reference's ``test_paged_vs_dense_identity_2x2_mesh`` prompts (12
    tokens each from seeds 100 and 101), then two that share a 16-token
    prefix (two full pages: the second slot, on the other data rank, reads
    the first slot's pages)."""
    out = []
    for seed in (100, 101):
        rng = np.random.default_rng(seed)
        out.append({"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 12)))})
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (1, 16))
    for _ in range(2):
        t = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, (1, 4))], axis=1)
        out.append({"tokens": torch.from_numpy(t)})
    return out


def _paged(cfg, model, params, mesh, backend, wbits):
    """The reference's 2×2 paged flow on reduced TinyLlama (max_seq 32, 8-token
    pages, two slots, six tokens), dense and paged, for each pair of
    prompts: (dense tokens, paged tokens, the paged pool's table, its shard
    summary) a pair; ``kv_pool.check()`` runs after each."""
    out = []
    for pair in (_paged_prompts(cfg)[:2], _paged_prompts(cfg)[2:]):
        toks = []
        for pages in (None, 8):
            eng = ServeEngine(model, params, max_seq=32, batch_size=2, device="nano",
                              sparsity=0.4, method="chunk", seed=5, cache_mb=64.0,
                              backend=backend, wbits=wbits, torch_device="cpu",
                              kv_page_tokens=pages, mesh=mesh)
            eng.enable_slots()
            lasts = [torch.argmax(eng.admit_slot(slot, p)[0], -1)[:, None]
                     for slot, p in enumerate(pair)]
            toks.append(eng.decode_slots(torch.cat(lasts), N_TOKENS)[0].numpy())
        eng.kv_pool.check()
        out.append((toks[0], toks[1], eng.kv_pool.table.copy(), eng.shard_summary()))
    return out


def _moe(arch, mesh, wbits):
    """A MoE decoder's prefill → 6 greedy tokens (the kernel backend's plain
    versions), at the reduced config's capacity factor (8.0: nothing drops)
    and at the full configs' 1.25, where the prefill's capacity binds and
    drops depend on every row of the batch."""
    out = []
    cfg, model, params = _lm(arch)
    for factor in (cfg.moe_capacity_factor, 1.25):
        model = build_model(dataclasses.replace(cfg, moe_capacity_factor=factor))
        eng = ServeEngine(model, params, backend="kernel", wbits=wbits, mesh=mesh, **ENGINE)
        last = eng.prefill(make_dummy_batch(cfg, SMOKE, seed=0, device="cpu"))
        out.append(eng.decode(torch.argmax(last, -1)[:, None], N_TOKENS).numpy())
    return out


def _extra(mesh):
    """The paged and MoE cases: {("paged", backend, wbits): _paged(...),
    (arch, wbits): tokens}."""
    res = {}
    cfg, model, params = _lm("tinyllama-1.1b")
    for backend, wbits in CASES:
        res[("paged", backend, wbits)] = _paged(cfg, model, params, mesh, backend, wbits)
    for arch, wbits in MOE_CASES:
        res[(arch, wbits)] = _moe(arch, mesh, wbits)
    return res


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng, out = tserve.main(argv)
    if not isinstance(out, torch.Tensor):  # --streams: the scheduler's stats
        return buf.getvalue(), out.row(), eng.shard_summary()
    return buf.getvalue(), out.numpy(), eng.shard_summary()


def _wide_prefill(mesh):
    """A prefill of batch 2 on TinyLlama-1.1B at full width (its first
    layer; at these widths the CPU's products round by how many rows they
    multiply): the last logits and this rank's rows of the K and V cache,
    as f32 numpy."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=1)
    model = build_model(cfg)
    eng = ServeEngine(model, model.init(seed=0, device="cpu"), backend="kernel", wbits=16,
                      mesh=mesh, **ENGINE)
    last = eng.prefill(make_dummy_batch(cfg, SMOKE, seed=0, device="cpu"))
    return {"last": last.float().numpy(), "rows": list(eng._local_rows),
            **{key: eng.cache[key].float().numpy() for key in ("k", "v")}}


# the full-width serve cases: (arch, the layers kept, method, the token
# counts of the frames appended between the prefill and the decode; a
# frame's attention rounds by its row count at a few tokens).
# Depth is cut, never width: one layer of TinyLlama-1.1B and StarCoder2-3B
# (whose 3072 → 49152 head rounds by its row count; StarCoder2-7B's 1-layer
# process peaked at 2.45 GB), Zamba2-7B as one group of 2 Mamba2 layers and
# the shared block once (attn_every 2; its group of 6 peaked at 3.14 GB),
# xLSTM-125M and Whisper-small whole
WIDE_CASES = {
    "tinyllama-chunk-frames": ("tinyllama-1.1b", 1, "chunk", (8, 8, 1)),
    "tinyllama-dense": ("tinyllama-1.1b", 1, "dense", ()),
    "tinyllama-dense_free": ("tinyllama-1.1b", 1, "dense_free", ()),
    "starcoder2-3b-chunk": ("starcoder2-3b", 1, "chunk", ()),
    "starcoder2-3b-dense_free": ("starcoder2-3b", 1, "dense_free", ()),
    "zamba2-7b": ("zamba2-7b", 2, "chunk", ()),
    "xlstm-125m": ("xlstm-125m", None, "chunk", ()),
    "whisper-small": ("whisper-small", None, "chunk", ()),
}
# Whisper's encoder frames a prompt carries (the input's length, not a width)
WIDE_AUDIO_FRAMES = 16


def _wide_cfg(arch, layers):
    cfg = get_config(arch)
    if layers is None:
        return cfg
    if cfg.attn_every:  # one group of ``layers`` Mamba2 layers
        return dataclasses.replace(cfg, n_layers=layers, attn_every=layers)
    return dataclasses.replace(cfg, n_layers=layers)


# the last case's weights, {(arch, layers): params}
_WIDE_PARAMS = {}


def _wide_params(arch, layers):
    """The seed-0 weights of a case's model, shared by the consecutive
    cases of one model (the engine does not change them); the previous
    model's are dropped before the next one's are made."""
    if (arch, layers) not in _WIDE_PARAMS:
        _WIDE_PARAMS.clear()
        _WIDE_PARAMS[(arch, layers)] = build_model(_wide_cfg(arch, layers)).init(
            seed=0, device="cpu")
    return _WIDE_PARAMS[(arch, layers)]


def _cache_rows(eng):
    """{path: (its batch dim, this rank's rows as f32 numpy)} of every
    tensor of the engine's cache."""
    out = {}

    def walk(c, axes, path):
        if isinstance(c, dict):
            for k, v in c.items():
                walk(v, axes[k], f"{path}/{k}")
        elif isinstance(c, (tuple, list)):
            for i, (v, a) in enumerate(zip(c, axes, strict=True)):
                walk(v, a, f"{path}/{i}")
        elif isinstance(c, torch.Tensor):
            out[path] = (list(axes).index("batch"), c.float().numpy())

    walk(eng.cache, eng.model.cache_axes(), "")
    return out


def _wide_serve(mesh, case):
    """One full-width case of ``WIDE_CASES`` at batch 2 (wbits 16, the
    kernel backend's plain versions): prefill, the frames, then N_TOKENS
    greedy tokens. Returns this rank's batch rows, each frame's returned
    hidden states (the whole batch), every decode step's logits (this
    rank's rows), the tokens (the whole batch) and this rank's rows of
    every cache tensor after the last step, as numpy."""
    arch, layers, method, frame_tokens = WIDE_CASES[case]
    cfg = _wide_cfg(arch, layers)
    model = build_model(cfg)
    eng = ServeEngine(model, _wide_params(arch, layers), backend="kernel", wbits=16, mesh=mesh,
                      **{**ENGINE, "method": method})
    logits = []
    step = model.decode_step_planned

    def recorded(*args, **kw):
        out, io = step(*args, **kw)
        logits.append(out.float().numpy().copy())
        return out, io

    model.decode_step_planned = recorded
    prompt = (dataclasses.replace(cfg, frontend_tokens=WIDE_AUDIO_FRAMES) if cfg.is_encdec
              else cfg)
    last = eng.prefill(make_dummy_batch(prompt, SMOKE, seed=0, device="cpu"))
    rng = np.random.default_rng(1)
    frames = [eng.append_frame(torch.from_numpy(rng.normal(
        0, 1, (ENGINE["batch_size"], n, cfg.d_frontend or cfg.d_model)))
        .to(torch.bfloat16)).float().numpy() for n in frame_tokens]
    tokens = eng.decode(torch.argmax(last, -1)[:, None], N_TOKENS).numpy()
    del model.decode_step_planned  # (the recorder refers to the model)
    return {"rows": list(eng._local_rows), "frames": frames, "logits": logits,
            "tokens": tokens, "cache": _cache_rows(eng)}


def wide_diffs(got, want) -> dict:
    """A rank's full-width case (``_wide_serve``) against the 1×1 mesh's:
    the largest absolute difference of the frames' hidden states, of this
    rank's cache rows and of the decode steps' logits, and how many tokens
    differ."""
    rows = got["rows"]

    def worst(pairs):
        return max((float(np.abs(g - w).max()) for g, w in pairs), default=0.0)

    return {
        "frames": worst(zip(got["frames"], want["frames"], strict=True)),
        "cache": worst((rows_g, np.take(want["cache"][path][1], rows, axis=dim))
                       for path, (dim, rows_g) in got["cache"].items()),
        "logits": worst((g, w[rows]) for g, w in zip(got["logits"], want["logits"],
                                                      strict=True)),
        "tokens": int((got["tokens"] != want["tokens"]).sum()),
    }


def hold_wide(ranks, want) -> dict:
    """Every rank's full-width case bitwise the 1×1 mesh's: each frame's
    hidden states, the rank's rows of every cache tensor, every decode
    step's logits and the tokens (``wide_diffs``, all 0). Returns the
    largest of each over the ranks."""
    for got in ranks:
        assert sorted(got["cache"]) == sorted(want["cache"])
        assert len(got["logits"]) == N_TOKENS
    diffs = [wide_diffs(got, want) for got in ranks]
    worst = {k: max(d[k] for d in diffs) for k in diffs[0]}
    assert not any(worst.values()), worst
    return worst


def hold_tokens(got, want) -> float:
    """A rank's prefill → decode (``_summary``) against the 1×1 mesh's:
    byte-identical greedy tokens, the last importances and masks of every
    site equal (selection is replicated, from the whole batch), the bytes
    within RTOL; their relative difference."""
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for kind, (pending, mask) in want["selection"].items():
        np.testing.assert_array_equal(got["selection"][kind][0], pending)
        np.testing.assert_array_equal(got["selection"][kind][1], mask)
    b1, b2 = want["io_bytes"], got["io_bytes"]
    assert abs(b1 - b2) <= RTOL * max(b1, 1.0), (b1, b2)
    return abs(b1 - b2) / max(b1, 1.0)


def hold_paged(got, want) -> float:
    """Paged KV (``_paged``) on a rank (``got``) against the 1×1 mesh
    (``want``): for each pair of prompts, the 1×1 paged tokens equal its
    dense ones, and the rank's dense and paged tokens equal those; the
    largest difference, 0."""
    for (dense1, paged1, _, _), (dense, paged, _, _) in zip(want, got, strict=True):
        for tokens in (paged1, dense, paged):
            np.testing.assert_array_equal(tokens, dense1)
    return 0.0


def hold_moe(got, want) -> float:
    """A MoE decoder's tokens (``_moe``) on a rank against the 1×1 mesh's,
    at each capacity factor; the largest difference, 0."""
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    return 0.0


def _rank_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = ServeMesh.create(2, 2, "cpu")
        res = {"coords": (mesh.rank("data"), mesh.rank("model"))}
        cfg, model, params = _vlm()
        for backend, wbits in CASES:
            res[(backend, wbits)] = _summary(*_run(cfg, model, params, mesh, backend, wbits))
        res["refusals"] = _refusals(cfg, mesh)
        res["slots"] = _slots(cfg, model, params, mesh)
        res["cli"] = _cli(CLI + ["--mesh", "2,2"])
        res.update(_extra(mesh))
        res["cli_streams"] = _cli(CLI_STREAMS + ["--mesh", "2,2"])
        res["wide_prefill"] = _wide_prefill(mesh)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        drain()
    finally:
        dist.destroy_process_group()
