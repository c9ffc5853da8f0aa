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
wbits 16 and 8. Besides, one prefill of TinyLlama-1.1B at full width (one
layer), where the CPU's products round by how many rows they multiply:
its logits and each rank's rows of the cache bitwise the 1×1 mesh's. What
the ranks and the 1×1 runs serve, and the checks of tokens, paged KV and
MoE tokens, live in ``tests/torch_serve_ranks.py``, which imports only
the port: chip_smoke.py's phase 19 runs them on the card's machine.

Tolerances: tokens, row counts, lane shapes and refusals are exact. Byte
totals are f32 counter sums (the 1×1 and 2×2 totals, the lanes against
their sum, the recount in f64 against the engine's f32 lanes): rtol 1e-6.

The ``slow`` test runs the JAX package itself on a 2×2 mesh of four
simulated host devices (a subprocess with ``XLA_FLAGS``) and the port's
four ranks on the reference's weights and prompt, and compares their
per-shard bytes.
"""
import datetime
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine
from repro_torch.sharding import ServeMesh

sys.path.insert(0, os.path.dirname(__file__))
import torch_procs as procs  # noqa: E402
from torch_procs import drain  # noqa: E402
from torch_serve_ranks import (CASES, CLI, CLI_STREAMS, ENGINE, MOE_CASES, N_TOKENS,  # noqa: E402
                               RTOL, WORLD, _cli, _extra, _paged_prompts, _rank_main, _run,
                               _slots, _summary, _vlm, _wide_prefill, hold_moe,
                               hold_paged, hold_tokens)

CASE_IDS = [f"{b}-{w}" for b, w in CASES]
MOE_IDS = [f"{a}-{w}" for a, w in MOE_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the four ranks' results, the 1×1 runs): the ranks spawn first and
    this process serves the 1×1 runs while they work."""
    tmp = tmp_path_factory.mktemp("mesh")
    rank_procs = procs.Ranks(_rank_main, (WORLD, str(tmp / "store"), str(tmp)), WORLD, tmp,
                             "serve_mesh")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, model, params = _vlm()
        single = {case: _summary(*_run(cfg, model, params, None, *case)) for case in CASES}
        single["slots"] = _slots(cfg, model, params, None)
        single["cli"] = _cli(CLI)
        single.update(_extra(None))
        single["cli_streams"] = _cli(CLI_STREAMS)
        single["wide_prefill"] = _wide_prefill(None)
    finally:
        torch.set_num_threads(n)
    rank_procs.wait()
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
        hold_tokens(r[case], single[case])
    assert all(r[case]["shard"] == ranks[0][case]["shard"] for r in ranks)


def test_sharded_prefill_is_the_single_mesh_prefill_at_full_width(runs):
    """At TinyLlama-1.1B's full width the CPU's product of a data rank's
    rows alone rounds otherwise than that of the whole batch, so every rank
    runs the whole batch's prompt and keeps its rows of the cache: the last
    logits and each rank's rows of K and V bitwise the 1×1 mesh's."""
    ranks, single = runs
    want = single["wide_prefill"]
    for r in ranks:
        got = r["wide_prefill"]
        assert got["rows"] == [r["coords"][0]]
        np.testing.assert_array_equal(got["last"], want["last"])
        for key in ("k", "v"):
            np.testing.assert_array_equal(got[key], want[key][:, got["rows"]])


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


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_paged_tokens_equal_dense_and_single_mesh(runs, case):
    """Paged KV on the 2×2 mesh (the pool split by page over the data ranks,
    a slot's pages wherever the global allocator put them): its tokens
    equal the dense cache's on the same mesh and the 1×1 mesh's, for the
    reference's two prompts and for two that share their first two pages
    across the data ranks."""
    ranks, single = runs
    key = ("paged",) + case
    for r in ranks:
        hold_paged(r[key], single[key])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_paged_pages_per_shard_equal_reference(runs, case):
    """``kv_pages_per_shard`` sums to ``kv_pages_in_use`` and equals the JAX
    package's ``KVPagePool(n_data_shards=2)`` after the same admissions and
    decode growth; the tables equal it too (``kv_pool.check()`` ran in the
    ranks)."""
    import jax.numpy as jnp

    from repro.serving.kv_pool import KVPagePool as RefPool
    from repro.serving.kv_pool import prompt_prefix_hashes as ref_hashes

    ranks, single = runs
    cfg = get_config("tinyllama-1.1b").reduced()
    prompts = _paged_prompts(cfg)
    for pair, i in enumerate((0, 2)):
        ref = RefPool(2, 32, 8, 10, 1.0, n_data_shards=2)
        for slot, p in enumerate(prompts[i:i + 2]):
            n, hashes = ref_hashes({"tokens": jnp.asarray(p["tokens"].numpy(), jnp.int32)}, 8)
            ref.admit(slot, n, hashes)
        for slot, p in enumerate(prompts[i:i + 2]):
            ref.ensure(slot, p["tokens"].shape[1] + N_TOKENS - 1)
        ref.check()
        for r in ranks:
            _, _, table, ss = r[("paged",) + case][pair]
            np.testing.assert_array_equal(table, ref.table)
            assert ss["kv_pages_per_shard"] == ref.pages_per_shard()
            assert sum(ss["kv_pages_per_shard"]) == ss["kv_pages_in_use"] == ref.pages_in_use
            assert ss["mesh_data"] == 2
        assert single[("paged",) + case][pair][3]["kv_pages_per_shard"] == [ref.pages_in_use]
    # the shared-prefix pair shares pages across the data ranks
    assert ranks[0][("paged",) + case][1][2][1, 0] == ranks[0][("paged",) + case][1][2][0, 0]


@pytest.mark.parametrize("case", MOE_CASES, ids=MOE_IDS)
def test_sharded_moe_data2_equals_single_mesh(runs, case):
    """Reduced OLMoE and Scout on the 2×2 mesh, one batch row a data rank:
    each MoE layer routes the whole batch (its capacity and drops), so the
    greedy tokens equal the 1×1 mesh's, at either capacity factor."""
    ranks, single = runs
    for r in ranks:
        hold_moe(r[case], single[case])


def test_cli_mesh_paged_moe_streams_in_ranks(runs):
    """``--mesh 2,2 --streams 4 --kv-page-tokens 8`` on reduced OLMoE (a MoE
    arch at data 2 with paged KV): the scheduler's row of the 1,1 CLI, and
    the [mesh] line with the pool's pages per data shard."""
    ranks, single = runs
    text1, row1, ss1 = single["cli_streams"]
    assert "[mesh]" not in text1 and ss1["kv_pages_per_shard"] == [ss1["kv_pages_in_use"]]
    for r in ranks:
        text, row, ss = r["cli_streams"]
        assert row == row1
        assert "[mesh] data=2 model=2" in text and "kv_pages/data_shard=[" in text
        assert sum(ss["kv_pages_per_shard"]) == ss["kv_pages_in_use"]


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
        drain()
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
    procs.Ranks(_reference_rank_main, (WORLD, str(tmp_path / "store"), str(tmp_path),
                                       str(ref_path)), WORLD, tmp_path, "ref_ranks").wait()
    with open(tmp_path / "ref_rank0.pkl", "rb") as f:
        port = pickle.load(f)
    np.testing.assert_allclose(port["shard"]["io_bytes_per_shard"],
                               ref["2x2"]["shard"]["io_bytes_per_shard"], rtol=RTOL)
    np.testing.assert_allclose(port["shard"]["io_bytes"], ref["2x2"]["shard"]["io_bytes"],
                               rtol=RTOL)
