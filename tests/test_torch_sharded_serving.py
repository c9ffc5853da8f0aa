"""Sharded serving on a 2×2 (data, model) mesh of four gloo ranks on the
CPU, against the same settings on the 1×1 mesh (which the other tests hold
to the JAX package) and against a recount of the per-shard bytes through
the JAX package's ``shard_block_tables``.

One module-scoped ``torch.multiprocessing`` spawn of four ranks (a file
store under ``tmp_path_factory``, no TCP port) runs every case; each rank
writes its results to a file and the tests read them. While the ranks run,
this process serves the 1×1 runs. The settings are the reference's
``tests/test_sharded_serving.py``: reduced InternVL2-76B, ``max_seq`` 64,
batch 2, ``nano``, sparsity 0.5, chunk, seed 5, refresh every 2,
``cache_mb`` 2.0, 6 tokens, both backends (their plain versions here) at
wbits 16 and 8.

Tolerances: tokens, row counts, lane shapes and refusals are exact. Byte
totals are f32 counter sums (the 1×1 and 2×2 totals, the lanes against
their sum, the recount in f64 against the engine's f32 lanes): rtol 1e-6.

The ``slow`` test runs the JAX package itself on a 2×2 mesh of four
simulated host devices (a subprocess with ``XLA_FLAGS``) and the port's
four ranks on the reference's weights and prompt, and compares their
per-shard bytes.
"""
import contextlib
import datetime
import io
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

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

WORLD = 4
CASES = [(b, w) for b in ("reference", "kernel") for w in (16, 8)]
CASE_IDS = [f"{b}-{w}" for b, w in CASES]
SMOKE = InputShape(name="smoke", seq_len=16, global_batch=2, kind="train")
ENGINE = dict(max_seq=64, batch_size=2, device="nano", sparsity=0.5, method="chunk", seed=5,
              plan_refresh_interval=2, cache_mb=2.0, torch_device="cpu")
N_TOKENS = 6
CLI = ["--arch", "internvl2-76b", "--reduced", "--torch-device", "cpu", "--decode-tokens", "3",
       "--max-seq", "64", "--prompt-len", "8", "--frames", "1", "--backend", "kernel"]
RTOL = 1e-6


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


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng, out = tserve.main(argv)
    return buf.getvalue(), out.numpy(), eng.shard_summary()


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
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _join(procs, seconds=600):
    """Wait for spawned ranks (a rank's exception re-raises here); kill them
    and fail past ``seconds``."""
    deadline = time.monotonic() + seconds
    while not procs.join(timeout=5):
        if time.monotonic() > deadline:
            for p in procs.processes:
                p.kill()
            pytest.fail(f"the 2x2 ranks did not finish within {seconds} s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the four ranks' results, the 1×1 runs): the ranks spawn first and
    this process serves the 1×1 runs while they work."""
    tmp = tmp_path_factory.mktemp("mesh")
    procs = mp.start_processes(_rank_main, args=(WORLD, str(tmp / "store"), str(tmp)),
                               nprocs=WORLD, join=False, start_method="spawn")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, model, params = _vlm()
        single = {case: _summary(*_run(cfg, model, params, None, *case)) for case in CASES}
        single["slots"] = _slots(cfg, model, params, None)
        single["cli"] = _cli(CLI)
    finally:
        torch.set_num_threads(n)
    _join(procs)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, single


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_tokens_equal_single_mesh(runs, case):
    """THE invariant: greedy tokens on the 2×2 mesh byte-identical to the
    1×1 mesh's, on every rank; the mesh repartitions the I/O and never
    rescales it."""
    ranks, single = runs
    assert sorted(r["coords"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        np.testing.assert_array_equal(r[case]["tokens"], single[case]["tokens"])
        # selection is replicated: every rank's last importances and masks
        # are the 1×1 mesh's, from the whole batch
        for kind, (pending, mask) in single[case]["selection"].items():
            np.testing.assert_array_equal(r[case]["selection"][kind][0], pending)
            np.testing.assert_array_equal(r[case]["selection"][kind][1], mask)
    b1, b2 = single[case]["io_bytes"], ranks[0][case]["io_bytes"]
    assert abs(b1 - b2) <= RTOL * max(b1, 1.0)
    assert all(r[case]["shard"] == ranks[0][case]["shard"] for r in ranks)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_shard_summary(runs, case):
    ranks, single = runs
    ss = ranks[0][case]["shard"]
    assert (ss["mesh_data"], ss["mesh_model"], ss["n_shards"]) == (2, 2, 2)
    assert len(ss["io_bytes_per_shard"]) == 2
    assert abs(sum(ss["io_bytes_per_shard"]) - ss["io_bytes"]) <= RTOL * ss["io_bytes"]
    assert all(b > 0 for b in ss["io_bytes_per_shard"])
    assert ss["slots_per_data_shard"] == 1 and ss["cache_mb_per_shard"] == 1.0
    # the unsharded engine keeps the one-device surface: no shard lanes
    one = single[case]
    assert one["n_shards"] == 1 and one["shard"]["io_bytes_per_shard"] == [one["io_bytes"]]
    assert all(sb is None for _, _, sb in one["events"])
    assert all(sb is not None and len(sb) == 2 for _, _, sb in ranks[0][case]["events"])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_plan_lanes(runs, case):
    """Only the row-sharded sites (attn_out streams wo's rows, ffn
    w_down's) carry per-shard hit/miss lanes, shaped (layers, 2);
    ``plan_shard_bytes`` sums to ``plan_transfer_bytes``."""
    ranks, _ = runs
    r = ranks[0][case]
    assert r["n_shards"] == 2
    for kind, ns in r["row_shards"].items():
        assert ns == (2 if kind in ("attn_out", "ffn") else 1), kind
        want = {"hit_shard": (2, 2), "miss_shard": (2, 2)} if ns > 1 else {}
        assert r["lanes"][kind] == want, kind
    per = r["plan_shard_bytes"]
    assert per.shape == (2,)
    assert abs(float(per.sum()) - r["plan_bytes"]) <= RTOL * max(r["plan_bytes"], 1.0)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_shard_bytes_equal_reference_recount(runs, case):
    """Every shard's bytes recounted in numpy from the plan's masks: each
    refresh's miss rows (selected, not resident by the JAX package's
    ``residency_from_score`` on the pre-refresh scores) as chunks, clipped to
    the shards' row ranges by the JAX package's ``shard_block_tables`` on the
    row-sharded sites and split evenly elsewhere, plus the prefill's even
    split."""
    import jax.numpy as jnp

    from repro.core.contiguity import mask_to_chunks_np
    from repro.serving.sparse_exec import residency_from_score
    from repro.sharding.serve import shard_block_tables

    ranks, _ = runs
    r = ranks[0][case]
    per = np.full(2, r["prefill_bytes"] / 2)
    for refresh in r["captured"]:
        for kind, (score, mask) in refresh.items():
            rb = r["row_bytes"][kind]
            for layer in range(mask.shape[0]):
                res = np.asarray(residency_from_score(jnp.asarray(score[layer]),
                                                      r["caps"][kind]))
                miss = (mask[layer] > 0) & ~res
                if r["row_shards"][kind] == 1:
                    per += miss.sum() * rb / 2
                    continue
                chunks = mask_to_chunks_np(miss)
                if not chunks:
                    continue
                starts = np.array([c.start for c in chunks], np.int32)
                sizes = np.array([c.size for c in chunks], np.int32)
                _, csz = shard_block_tables(starts, sizes, miss.shape[0], 2)
                per += np.asarray(csz).sum(axis=1) * rb
    np.testing.assert_allclose(r["shard"]["io_bytes_per_shard"], per, rtol=RTOL)


def test_sharded_refusals(runs):
    """Per-shard tables and counters assume selection row order equals
    storage order, and the integrity ladder edits tables it cannot see:
    reorderings and corruption injection fail at construction on a
    sharded mesh, with the reference's messages."""
    ranks, _ = runs
    for r in ranks:
        assert "does not support reorderings" in r["refusals"]["reorderings"]
        assert "corruption injection does not support sharded serving" in \
            r["refusals"]["corruption"]


def test_sharded_slot_mode_equals_single_mesh(runs):
    """Slot mode on the mesh (each data rank holds one slot's KV; every rank
    runs each admission's prefill and keeps the KV of its own slot): every
    request's tokens, the scheduler's row and the bytes of the 1×1 run."""
    ranks, single = runs
    one = single["slots"]
    assert len(one["tokens"]) == 4 and all(len(t) == 4 for t in one["tokens"].values())
    for r in ranks:
        assert r["slots"]["tokens"] == one["tokens"]
        assert r["slots"]["row"] == one["row"]
        ss = r["slots"]["shard"]
        assert abs(ss["io_bytes"] - one["io_bytes"]) <= RTOL * one["io_bytes"]
        assert ss["slots_per_data_shard"] == 1 and len(ss["io_bytes_per_shard"]) == 2


def test_cli_mesh_in_ranks(runs):
    """``--mesh 2,2`` inside the ranks (a frame appended, the kernel
    backend): the [mesh] line, and the tokens of the 1,1 CLI."""
    ranks, single = runs
    text1, out1, ss1 = single["cli"]
    assert "[mesh]" not in text1 and ss1["n_shards"] == 1
    for r in ranks:
        text, out, ss = r["cli"]
        assert "[mesh] data=2 model=2  slots/data_shard=1" in text
        np.testing.assert_array_equal(out, out1)
        assert abs(sum(ss["io_bytes_per_shard"]) - ss1["io_bytes"]) <= RTOL * ss1["io_bytes"]


ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_MESH = r"""
import pickle, sys
sys.path.insert(0, sys.argv[1])
import conftest  # noqa: F401  (the Pallas aliases the reference needs under jax 0.9)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType

# jax 0.9's make_mesh types its axes Explicit, under which the reference's
# embedding gather on data-sharded tokens raises ShardingTypeError; its
# meshes were Auto (GSPMD propagation) when it was written, so make them so
_make_mesh = jax.make_mesh
def _auto_mesh(shape, names, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(shape))
    return _make_mesh(shape, names, **kw)
jax.make_mesh = _auto_mesh
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.models import build_model
from repro.models.inputs import make_dummy_batch
from repro.serving import ServeEngine
from repro.sharding.serve import ServeMesh

cfg = get_config("internvl2-76b").reduced()
model = build_model(cfg)
params = model.init(jax.random.key(0))
batch = make_dummy_batch(cfg, InputShape(name="smoke", seq_len=16, global_batch=2, kind="train"))
out = {"params": jax.device_get(params), "batch": jax.device_get(batch)}
for name, mesh in (("1x1", ServeMesh.single()), ("2x2", ServeMesh.create(2, 2))):
    eng = ServeEngine(model, params, max_seq=64, batch_size=2, device="nano", sparsity=0.5,
                      method="chunk", seed=5, plan_refresh_interval=2, cache_mb=2.0,
                      backend="reference", wbits=16, mesh=mesh)
    last = eng.prefill(batch)
    toks = eng.decode(jnp.argmax(last, -1)[:, None].astype(jnp.int32), 6)
    out[name] = {"tokens": np.asarray(toks), "shard": eng.shard_summary()}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _reference_rank_main(rank, world, store, out_dir, ref_path):
    """A rank of the port's 2×2 mesh on the reference's weights and prompt."""
    from repro_torch.models import params_from_reference

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
        cfg = get_config("internvl2-76b").reduced()
        model = build_model(cfg)
        params = params_from_reference(ref["params"], cfg, "cpu")
        eng = ServeEngine(model, params, backend="reference", wbits=16,
                          mesh=ServeMesh.create(2, 2, "cpu"), **ENGINE)
        batch = {k: (torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
                     if str(np.asarray(v).dtype) == "bfloat16" else torch.from_numpy(np.asarray(v)))
                 for k, v in ref["batch"].items()}
        last = eng.prefill(batch)
        out = eng.decode(torch.argmax(last, -1)[:, None], N_TOKENS)
        with open(os.path.join(out_dir, f"ref_rank{rank}.pkl"), "wb") as f:
            pickle.dump({"tokens": out.numpy(), "shard": eng.shard_summary()}, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_reference_mesh_per_shard_bytes_equal_port(tmp_path):
    """The JAX package on its own 2×2 mesh (four simulated host devices)
    and the port's four gloo ranks, on the reference's weights and prompt:
    the same per-shard bytes, and each package's 2×2 tokens equal its 1×1
    tokens."""
    ref_path = tmp_path / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", JAX_MESH, str(ROOT), str(ref_path)], env=env,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stdout + res.stderr
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    np.testing.assert_array_equal(ref["2x2"]["tokens"], ref["1x1"]["tokens"])
    _join(mp.start_processes(_reference_rank_main,
                             args=(WORLD, str(tmp_path / "store"), str(tmp_path), str(ref_path)),
                             nprocs=WORLD, join=False, start_method="spawn"))
    with open(tmp_path / "ref_rank0.pkl", "rb") as f:
        port = pickle.load(f)
    np.testing.assert_allclose(port["shard"]["io_bytes_per_shard"],
                               ref["2x2"]["shard"]["io_bytes_per_shard"], rtol=RTOL)
    np.testing.assert_allclose(port["shard"]["io_bytes"], ref["2x2"]["shard"]["io_bytes"],
                               rtol=RTOL)
