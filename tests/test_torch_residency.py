"""The port's dynamic residency cache (paper §5) and the serving pieces that
came with it, against the JAX reference on the CPU at ``tinyllama-1.1b
--reduced`` with carried-over parameters: the cases of
``tests/test_residency.py`` (rank eviction under the cap, the byte budget,
I/O against the budget, hits, fused against per-token decode, the hit-rate
accounting, marginal-cost selection, pinned ``cached`` rows), the
all-layer refresh with the cache against the reference's per-layer
refreshes, ``mask_latency_miss``, ``mask_to_runs`` and the contiguity
helpers, the sparsity allocator, reorderings on the reference backend,
``reprice_timeline`` and the CLI's ``--cache-mb`` / ``--per-token``.

Tolerances. Masks, resident sets, kernel tables, hit/miss rows and bytes
are compared exactly where both packages select from the same importances
— dyadic (k/8) ones in the refresh replays, whose prefix sums are exact in
both summation orders. The residency score is not bitwise equal: the
reference's CPU XLA contracts ``0.9 · score + pending`` into one fused
multiply-add and the port rounds twice, so the scores differ by an ulp per
update (checked: up to 4e-6 after eight refreshes); they are held at rtol
1e-6, while the resident sets and masks derived from them stay exactly
equal. Latency estimates are f32 sums taken in another order: rtol 1e-6.
Engines are held token for token to the reference only while their masks
come from the shared bootstrap and the first step's importances (two
steps; top-k one): later refreshes rank importances of bf16 activations,
whose last bits differ across the frameworks (see ``test_torch_serve``),
and the residency score compounds that; their invariants are checked on
the port itself.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import InputShape as JShape
from repro.core import chunking as jchunk
from repro.core import contiguity as jcontig
from repro.core import latency_model as jlat
from repro.core import reorder as jreorder
from repro.core import sparsity_alloc as jalloc
from repro.models import build_model as jbuild
from repro.models.inputs import make_dummy_batch as jbatch
from repro.serving import ServeEngine as JEngine
from repro.serving import sparse_exec as jse
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape as TShape
from repro_torch.core import LayerProfile, allocate_sparsity, budgets_from_sparsity
from repro_torch.core import chunking as tchunk
from repro_torch.core import contiguity as tcontig
from repro_torch.core import latency_model as tlat
from repro_torch.core import reorder as treorder
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.models.inputs import make_dummy_batch as tbatch
from repro_torch.serving import ServeEngine as TEngine
from repro_torch.serving import sparse_exec as tse

DECODE_TOKENS = 10
BUDGETS_MB = (0.0, 1.0, 4.0)
EXACT_KEYS = ("mask", "pending", "hit", "miss", "bytes", "kstarts", "ksizes")


@pytest.fixture(scope="module")
def lm():
    jcfg, tcfg = jget("tinyllama-1.1b").reduced(), tget("tinyllama-1.1b").reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    jb = jbatch(jcfg, JShape("res", 8, 2, "train"))
    tb = tbatch(tcfg, TShape("res", 8, 2, "train"), device="cpu")
    return tcfg, tm, tp, tb, jm, jp, jb


def _decode_engine(lm, cache_mb, method="chunk", per_token=False, refresh=2,
                   n_tokens=DECODE_TOKENS, backend="reference"):
    cfg, model, params, batch = lm[:4]
    eng = TEngine(model, params, max_seq=64, batch_size=2, device="nano", sparsity=0.4,
                  method=method, seed=1, plan_refresh_interval=refresh, cache_mb=cache_mb,
                  backend=backend, torch_device="cpu")
    eng.simulator.noise = 0.0  # deterministic simulated measurements
    tok0 = torch.argmax(eng.prefill(batch), dim=-1)[:, None]
    fn = eng.decode_per_token if per_token else eng.decode
    return eng, fn(tok0, n_tokens)


@pytest.fixture(scope="module")
def swept(lm):
    """One decode per cache budget, shared by the assertions below."""
    return {mb: _decode_engine(lm, mb) for mb in BUDGETS_MB}


def _decode_io_est(eng):
    return sum(s.io_est_s for s in eng.stats if s.kind == "decode")


# -- byte budget ---------------------------------------------------------------


def test_residency_rank_eviction_never_exceeds_cap():
    """``residency_from_score`` equals the reference's: a stable top-cap rank
    that never exceeds the cap (ties included) and never holds a row that
    was not inserted; one call over padded lanes equals one per lane."""
    rng = np.random.default_rng(0)
    for cap in (0, 1, 7, 64, 200):
        score = rng.normal(0, 1, (200,)).astype(np.float32)
        res = tse.residency_from_score(torch.from_numpy(score), cap)
        np.testing.assert_array_equal(
            res.numpy(), np.asarray(jse.residency_from_score(jnp.asarray(score), cap)))
        assert int(res.sum()) <= cap
        assert not bool((res & (torch.from_numpy(score) <= 0.0)).any())
    res = tse.residency_from_score(torch.ones(50), 10)
    assert int(res.sum()) == 10
    # three lanes of 40, 64 and 17 rows padded to 64 with zeros, caps per lane
    ns, caps = (40, 64, 17), torch.tensor([12, 64, 30])
    scores = torch.zeros((2, 3, 64))
    for i, n in enumerate(ns):
        scores[:, i, :n] = torch.from_numpy(
            (rng.integers(0, 5, (2, n)) / 4.0).astype(np.float32))
    batched = tse.residency_from_score(scores, caps)
    for layer in range(2):
        for i, n in enumerate(ns):
            one = tse.residency_from_score(scores[layer, i, :n], int(caps[i]))
            assert torch.equal(batched[layer, i, :n], one)
            assert not bool(batched[layer, i, n:].any())


def test_engine_residency_stays_under_byte_budget(swept):
    for mb, (eng, _) in swept.items():
        ctx = eng.sparse_ctx
        if mb == 0.0:
            assert not ctx.cache_enabled and ctx.cache_caps is None
            continue
        caps = ctx.cache_caps
        used = 0.0
        for kind, state in eng._plan.items():
            res = tse.residency_from_score(state["score"], caps[kind])
            assert int(res.sum(dim=1).max()) <= caps[kind]
            used += float(res.sum()) * ctx.site_row_bytes(kind)
        assert used <= mb * 1024 * 1024 * (1 + 1e-6), (used, mb)


# -- I/O against the budget ---------------------------------------------------------


def test_io_monotone_non_increasing_in_cache_budget(swept):
    ios = [_decode_io_est(swept[mb][0]) for mb in BUDGETS_MB]
    assert all(b <= a + 1e-12 for a, b in zip(ios, ios[1:])), ios
    assert all(io < ios[0] for io in ios[1:]), ios


def test_positive_budget_reports_hits(swept):
    s = swept[1.0][0].io_summary()
    assert s["hit_rows"] > 0 and 0.0 < s["cache_hit_rate"] < 1.0
    s0 = swept[0.0][0].io_summary()
    assert s0["hit_rows"] == 0 and s0["cache_hit_rate"] == 0.0


# -- fused against per-token --------------------------------------------------------


@pytest.mark.parametrize("method,backend", [("chunk", "reference"), ("chunk", "kernel"),
                                            ("topk", "reference")])
def test_scan_vs_per_token_identical_with_cache(lm, method, backend):
    eng_s, out_s = _decode_engine(lm, 1.0, method=method, backend=backend)
    eng_p, out_p = _decode_engine(lm, 1.0, method=method, backend=backend, per_token=True)
    assert torch.equal(out_s, out_p), "tokens diverged with the cache enabled"
    np.testing.assert_allclose(_decode_io_est(eng_s), _decode_io_est(eng_p), rtol=1e-6)
    ss, sp = eng_s.io_summary(), eng_p.io_summary()
    assert ss["hit_rows"] == sp["hit_rows"] and ss["miss_rows"] == sp["miss_rows"]
    assert ss["io_bytes"] == sp["io_bytes"]
    np.testing.assert_allclose(sp["decode_overlap_s"], ss["decode_overlap_s"], rtol=1e-6)
    for kind in eng_s._plan:
        assert torch.equal(eng_s._plan[kind]["score"], eng_p._plan[kind]["score"])


# -- hit-rate accounting -------------------------------------------------------------


def test_hit_rate_accounting_sums_consistently(swept):
    eng, _ = swept[1.0]
    hit, miss = tse.plan_hit_miss(eng._plan)
    s = eng.io_summary()
    np.testing.assert_allclose(float(hit), s["hit_rows"], rtol=1e-6)
    np.testing.assert_allclose(float(miss), s["miss_rows"], rtol=1e-6)
    dec = [st for st in eng.stats if st.kind == "decode" and st.io_est_s > 0]
    events = [e for e in eng.simulator.log if e.name.startswith("decode")]
    assert len(events) == len(dec)
    for st, ev in zip(dec, events):
        rows = st.hit_rows + st.miss_rows
        np.testing.assert_allclose(ev.hit_rate, st.hit_rows / rows if rows else 0.0,
                                   rtol=1e-6)
        assert 0.0 <= ev.hit_rate <= 1.0


# -- marginal-cost selection ----------------------------------------------------------


def _pair_selectors(n, row_bytes, cfg):
    js = jchunk.ChunkSelector.build(n, row_bytes, device="nano",
                                    cfg=jchunk.ChunkConfig(**vars(cfg)))
    ts = tchunk.ChunkSelector.build(n, row_bytes, device="nano", cfg=cfg)
    return js, ts


def test_selector_marginal_cost_free_when_fully_resident():
    """A fully resident window costs T[0] = 0 (the padded table's row 0 is
    the reference's ``lookup(0)``): the estimate is 0, as the reference's."""
    n = 256
    js, ts = _pair_selectors(n, 64, tchunk.ChunkConfig(8.0, 32.0, 8.0, 8.0))
    assert float(ts.table.padded_table(4)[0]) == float(js.table.lookup(jnp.int32(0))) == 0.0
    v = np.random.default_rng(3).random(n).astype(np.float32)
    mask, selected, est = ts.select(torch.from_numpy(v), 128, torch.ones(n, dtype=torch.bool))
    jmask, jsel, jest = js.select(jnp.asarray(v), jnp.int32(128), jnp.ones((n,), bool))
    assert int(selected) > 0 and float(est) == 0.0 == float(jest)
    assert int(selected) == int(jsel)


@pytest.mark.parametrize("seed", range(3))
def test_selector_matches_numpy_oracle_with_residency(seed):
    """Random floats against the port's oracle and the reference's oracle;
    dyadic importances against the reference's selector, mask and
    miss-only estimate."""
    n = 256
    cfg = tchunk.ChunkConfig(8.0, 32.0, 8.0, 8.0)
    js, ts = _pair_selectors(n, 64, cfg)
    rng = np.random.default_rng(7 + seed)
    v = rng.random(n).astype(np.float32)
    resident = np.zeros(n, bool)
    resident[32:96] = True
    resident[rng.integers(0, n, 20)] = True
    m_np = tchunk.select_chunks_np(v, 64, 64, ts.table, cfg, resident=resident)
    np.testing.assert_array_equal(
        m_np, jchunk.select_chunks_np(v, 64, 64, js.table, jchunk.ChunkConfig(**vars(cfg)),
                                      resident=resident))
    m_t, _, _ = ts.select(torch.from_numpy(v), 64, torch.from_numpy(resident))
    np.testing.assert_array_equal(m_t.numpy(), m_np)
    vd = (rng.integers(0, 64, n) / 8.0).astype(np.float32)
    m_t, sel_t, est_t = ts.select(torch.from_numpy(vd), 64, torch.from_numpy(resident))
    m_j, sel_j, est_j = js.select(jnp.asarray(vd), jnp.int32(64), jnp.asarray(resident))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert int(sel_t) == int(sel_j)
    np.testing.assert_allclose(float(est_t), float(est_j), rtol=1e-6)


def test_static_cached_prewarm_is_pinned(lm):
    cfg = lm[0]
    n = cfg.d_model
    cached = torch.zeros(n, dtype=torch.bool)
    cached[::8] = True
    ctx = tse.SparseExecution(cfg, device="nano", sparsity=0.4, method="chunk",
                              cached={"hidden_attn": cached}, cache_mb=1.0, torch_device="cpu")
    plan = ctx.init_plan(cfg.n_layers)
    score = plan["hidden_attn"]["score"]
    assert bool((score[:, ::8] == tse.PIN_SCORE).all())
    assert bool((score[:, 1::8] == 0.0).all())
    jctx = jse.SparseExecution(jget("tinyllama-1.1b").reduced(), device="nano", sparsity=0.4,
                               method="chunk", cached={"hidden_attn": jnp.asarray(cached.numpy())},
                               cache_mb=1.0)
    jplan = jctx.init_plan(cfg.n_layers)
    for kind in plan:
        np.testing.assert_array_equal(plan[kind]["score"].numpy(),
                                      np.asarray(jplan[kind]["score"]))
    assert ctx.cache_caps == jctx.cache_caps
    # pinned rows stay resident across refreshes
    for _ in range(3):
        ctx.refresh_step(plan, True)
    res = tse.residency_from_score(plan["hidden_attn"]["score"], ctx.cache_caps["hidden_attn"])
    assert bool(res[:, ::8].all())


# -- the all-layer refresh with the cache against the reference -------------------------


CFG3 = dataclasses.replace(tget("tinyllama-1.1b").reduced(), n_layers=3)
JCFG3 = dataclasses.replace(jget("tinyllama-1.1b").reduced(), n_layers=3)


def _replay(sp, js, steps, interval, seed):
    """Run the port's refresh_step and the reference's per-layer
    refresh_layer side by side on the same dyadic importances; yields
    (step, port plan, reference plans, port io, reference io)."""
    refresh_layer = jax.jit(lambda pl, r: js.refresh_layer(pl, r))
    plan = sp.init_plan(CFG3.n_layers)
    jfull = js.init_plan(JCFG3.n_layers)
    jplans = [jax.tree_util.tree_map(lambda a, i=layer: a[i], jfull)
              for layer in range(JCFG3.n_layers)]
    rng = np.random.default_rng(seed)
    for step in range(steps):
        refresh = step % interval == 0
        io = sp.refresh_step(plan, refresh)
        want = []
        for layer in range(JCFG3.n_layers):
            jplans[layer], lat = refresh_layer(jplans[layer], jnp.bool_(refresh))
            want.append(np.asarray(lat))
        yield step, plan, jplans, io, np.stack(want)
        for kind, entry in plan.items():
            v = (rng.integers(0, 64, tuple(entry["pending"].shape)) / 8.0).astype(np.float32)
            entry["pending"].copy_(sp._to_selection(kind, torch.from_numpy(v)))
            for layer, jplan in enumerate(jplans):
                jv = jnp.asarray(v[layer])
                if kind in js.reorderings:
                    jv = js.reorderings[kind].apply_to_acts(jv)
                jplan[kind] = {**jplan[kind], "pending": jv}


def _assert_plans_equal(plan, jplans, step):
    for kind, entry in plan.items():
        for key, leaf in entry.items():
            ref = np.stack([np.asarray(jp[kind][key]) for jp in jplans])
            if key in EXACT_KEYS:
                np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=f"{step} {kind} {key}")
            else:  # the residency score: an ulp per update (module docstring)
                np.testing.assert_allclose(leaf.numpy(), ref, rtol=1e-6, atol=0,
                                           err_msg=f"{step} {kind} {key}")


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("interval", [1, 3])
@pytest.mark.parametrize("method", ["chunk", "topk"])
def test_refresh_with_cache_equals_reference(method, interval, cached):
    """Eight refreshes (every ``interval`` steps) at a 0.5 MB budget, with
    and without pinned ``cached`` rows: masks, kernel tables, hits, misses
    and bytes equal the reference's exactly, the scores to an ulp per
    update, the I/O estimates at rtol 1e-6; reuse steps cost nothing and
    keep the score."""
    kw = {}
    if cached:
        m = np.zeros(CFG3.d_model, bool)
        m[5:40] = True
        kw = {"cached": {"hidden_mlp": m}}
    sp = tse.SparseExecution(CFG3, sparsity=0.4, method=method, cache_mb=0.5,
                             torch_device="cpu",
                             **{k: {s: torch.from_numpy(v) for s, v in d.items()}
                                for k, d in kw.items()})
    js = jse.SparseExecution(JCFG3, device="nano", sparsity=0.4, method=method, cache_mb=0.5,
                             **{k: {s: jnp.asarray(v) for s, v in d.items()}
                                for k, d in kw.items()})
    hits = 0.0
    for step, plan, jplans, io, want in _replay(sp, js, 8, interval, 20 + interval):
        np.testing.assert_allclose(io.numpy(), want, rtol=1e-6)
        assert bool((io > 0).all()) == (step % interval == 0)
        _assert_plans_equal(plan, jplans, step)
        hits += float(tse.plan_hit_miss(plan)[0])
    assert hits > 0
    assert sp.cache_caps == js.cache_caps


@pytest.mark.parametrize("method", ["chunk", "topk"])
def test_static_cached_without_cache_equals_reference(method):
    """``cached`` masks with ``cache_mb == 0`` (the legacy static path): zero
    importance, OR'd into the compute masks and the kernel tables — equal
    to the reference's refresh, and on the unplanned ``mask`` path."""
    m = np.zeros(CFG3.d_model, bool)
    m[::3] = True
    sp = tse.SparseExecution(CFG3, sparsity=0.4, method=method, torch_device="cpu",
                             cached={"hidden_attn": torch.from_numpy(m)})
    js = jse.SparseExecution(JCFG3, device="nano", sparsity=0.4, method=method,
                             cached={"hidden_attn": jnp.asarray(m)})
    for step, plan, jplans, io, want in _replay(sp, js, 3, 1, 5):
        np.testing.assert_allclose(io.numpy(), want, rtol=1e-6)
        _assert_plans_equal(plan, jplans, step)
        assert bool((plan["hidden_attn"]["mask"][:, ::3] == 1.0).all())
    acts = (np.random.default_rng(9).integers(0, 64, (2, CFG3.d_model)) / 8.0).astype(np.float32)
    tm, tl = sp.mask("hidden_attn", torch.from_numpy(acts))
    jm, jl = js.mask("hidden_attn", jnp.asarray(acts))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


# -- reorderings on the reference backend ---------------------------------------------


def _reorderings(n_rows, seed):
    cal = (np.random.default_rng(seed).integers(0, 64, (12, n_rows)) / 8.0).astype(np.float32)
    return (treorder.hot_cold_reordering(cal), jreorder.hot_cold_reordering(cal))


@pytest.mark.parametrize("cache_mb", [0.0, 0.5])
@pytest.mark.parametrize("method", ["chunk", "topk"])
def test_reorderings_equal_reference(method, cache_mb):
    """Selection in the reordered row order, masks back through the inverse
    permutation: the refresh and the unplanned ``mask`` path equal the
    reference's; the kernel backend refuses reorderings, as the
    reference's does."""
    pairs = {"hidden_attn": _reorderings(CFG3.d_model, 1), "ffn": _reorderings(CFG3.d_ff, 2)}
    for tr, jr in pairs.values():
        np.testing.assert_array_equal(tr.perm, jr.perm)
    sp = tse.SparseExecution(CFG3, sparsity=0.4, method=method, cache_mb=cache_mb,
                             torch_device="cpu", reorderings={k: v[0] for k, v in pairs.items()})
    js = jse.SparseExecution(JCFG3, device="nano", sparsity=0.4, method=method,
                             cache_mb=cache_mb, reorderings={k: v[1] for k, v in pairs.items()})
    for step, plan, jplans, io, want in _replay(sp, js, 4, 1, 31):
        np.testing.assert_allclose(io.numpy(), want, rtol=1e-6)
        _assert_plans_equal(plan, jplans, step)
    acts = (np.random.default_rng(4).integers(0, 64, (2, CFG3.d_ff)) / 8.0).astype(np.float32)
    tm, tl = sp.mask("ffn", torch.from_numpy(acts))
    jm, jl = js.mask("ffn", jnp.asarray(acts))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    with pytest.raises(ValueError, match="reorderings"):
        tse.SparseExecution(CFG3, backend="kernel", torch_device="cpu",
                            reorderings={k: v[0] for k, v in pairs.items()})


def test_engine_with_reorderings_runs(lm):
    """The engine serves with reorderings on the reference backend: the
    masks it computes on are the selection-order masks mapped back."""
    cfg, model, params, batch = lm[:4]
    reo = {"hidden_mlp": _reorderings(cfg.d_model, 3)[0]}
    eng = TEngine(model, params, max_seq=64, batch_size=2, reorderings=reo, cache_mb=1.0,
                  torch_device="cpu")
    out = eng.decode(torch.argmax(eng.prefill(batch), -1)[:, None], 3)
    assert out.shape == (2, 4) and eng.io_summary()["hit_rows"] > 0
    with pytest.raises(ValueError, match="reorderings"):
        TEngine(model, params, max_seq=64, batch_size=2, reorderings=reo, backend="kernel",
                torch_device="cpu")


# -- the engine against the reference ---------------------------------------------------


@pytest.mark.parametrize("method,n_tokens", [("chunk", 2), ("topk", 1)])
@pytest.mark.parametrize("per_token", [False, True])
def test_engine_with_cache_matches_reference(lm, method, n_tokens, per_token):
    """``ServeEngine(cache_mb=1)`` against the reference engine while the
    masks come from the shared bootstrap and the first step's importances:
    tokens, masks, resident sets (through hits/misses) and every summary
    key; the score, which adds importances of bf16 activations, at the
    activations' tolerance (atol = rtol = 4e-2, as ``test_torch_model``)."""
    cfg, tm, tp, tb, jm, jp, jb = lm
    kw = dict(max_seq=64, batch_size=2, device="nano", sparsity=0.4, method=method, seed=3,
              cache_mb=1.0)
    jeng = JEngine(jm, jp, **kw)
    teng = TEngine(tm, tp, torch_device="cpu", **kw)
    jt = jnp.argmax(jeng.prefill(jb), -1)[:, None].astype(jnp.int32)
    tt = torch.argmax(teng.prefill(tb), -1)[:, None]
    jout = np.asarray((jeng.decode_per_token if per_token else jeng.decode)(jt, n_tokens))
    tout = (teng.decode_per_token if per_token else teng.decode)(tt, n_tokens)
    np.testing.assert_array_equal(tout.numpy(), jout)
    for kind, entry in teng._plan.items():
        np.testing.assert_array_equal(entry["mask"].numpy(),
                                      np.asarray(jeng._plan[kind]["mask"]))
        np.testing.assert_allclose(entry["score"].numpy(), np.asarray(jeng._plan[kind]["score"]),
                                   atol=4e-2, rtol=4e-2)
    ts, js = teng.io_summary(), jeng.io_summary()
    assert teng.cache_mb == jeng.cache_mb == 1.0
    for key in ts:
        if key == "select_overhead_s":
            continue
        np.testing.assert_allclose(ts[key], js[key], rtol=1e-6, err_msg=key)
    assert ts["hit_rows"] > 0 if n_tokens > 1 else ts["hit_rows"] == 0


def test_cache_mb_defaults_to_the_profile(lm):
    cfg, model, params = lm[:3]
    eng = TEngine(model, params, max_seq=32, batch_size=2, torch_device="cpu")
    assert eng.cache_mb == tlat.get_profile("nano").dram_cache_mb == 0.0
    assert not eng.sparse_ctx.cache_enabled
    assert tlat.JETSON_NANO.cache_capacity_bytes(2.0) == jlat.JETSON_NANO.cache_capacity_bytes(2.0)
    with pytest.raises(ValueError):
        TEngine(model, params, max_seq=32, batch_size=2, cache_mb=-1.0, torch_device="cpu")
    dense = TEngine(model, params, max_seq=32, batch_size=2, method="dense", cache_mb=1.0,
                    torch_device="cpu")
    assert not dense.sparse_ctx.cache_enabled  # dense streams everything whatever the budget


# -- the prefetch timeline at other depths ------------------------------------------------


def test_reprice_timeline_equals_reference_and_a_deeper_engine(lm):
    """Both packages' engines log the same per-layer I/O on equal masks
    (chunk, no cache, the shared-bootstrap steps), so their repriced
    timelines agree at every depth; and the port's repricing at depth d
    equals what an engine built at depth d logs."""
    cfg, tm, tp, tb, jm, jp, jb = lm
    kw = dict(max_seq=64, batch_size=2, device="nano", sparsity=0.4, seed=3)
    jeng, teng = JEngine(jm, jp, **kw), TEngine(tm, tp, torch_device="cpu", **kw)
    jt = jnp.argmax(jeng.prefill(jb), -1)[:, None].astype(jnp.int32)
    tt = torch.argmax(teng.prefill(tb), -1)[:, None]
    for _ in range(2):  # two calls: each repriced as its own cold pipeline
        jeng.decode(jt, 3)
        teng.decode(tt, 3)
    with pytest.raises(RuntimeError):
        TEngine(tm, tp, torch_device="cpu", **kw).reprice_timeline(1)
    for depth in range(5):
        got, want = teng.reprice_timeline(depth), jeng.reprice_timeline(depth)
        for f in ("io_s", "serial_s", "overlap_s", "stall_s", "bubble_s"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-6,
                                       err_msg=f"{depth} {f}")
    deep = TEngine(tm, tp, torch_device="cpu", prefetch_depth=3, **kw)
    tok = torch.argmax(deep.prefill(tb), -1)[:, None]
    deep.decode(tok, 3)
    deep.decode(tok, 3)
    got = teng.reprice_timeline(3)
    np.testing.assert_allclose(got.overlap_s, [s.overlap_s for s in deep.stats
                                               if s.kind == "decode"], rtol=1e-12)


def test_refresh_hit_rows_per_site_stay_within_cap(lm):
    """Each refresh step charges, per (layer, site), at most the site's cap
    of hit rows: the number the refresh itself produced (the growth of the
    plan's per-site ``hit`` over the step), not a rank recomputed from the
    scores. The steps' hits add up to ``io_summary``'s."""
    cfg, model, params, batch = lm[:4]
    eng = TEngine(model, params, max_seq=64, batch_size=2, sparsity=0.4, seed=1,
                  cache_mb=1.0, torch_device="cpu")
    sp = eng.sparse_ctx
    inner, steps = sp.refresh_step, []

    def refresh_step(plan, refresh):
        before = torch.stack([plan[k]["hit"].clone() for k in sp.site_order], dim=1)
        io = inner(plan, refresh)
        steps.append(torch.stack([plan[k]["hit"] for k in sp.site_order], dim=1) - before)
        return io

    sp.refresh_step = refresh_step
    tok0 = torch.argmax(eng.prefill(batch), dim=-1)[:, None]
    eng.decode(tok0, 6)
    hits = torch.stack(steps)
    caps = torch.tensor([sp.cache_caps[k] for k in sp.site_order], dtype=torch.float32)
    assert hits.shape == (6, cfg.n_layers, len(sp.site_order))
    assert bool((hits >= 0).all()) and bool((hits <= caps).all()), (hits.amax((0, 1)), caps)
    assert float(hits.sum()) > 0
    assert float(hits.sum()) == eng.io_summary()["hit_rows"]


# -- run helpers and latency -----------------------------------------------------------------


@pytest.mark.parametrize("density", [0.0, 0.3, 0.7, 1.0])
def test_mask_to_runs_and_helpers_equal_reference(density):
    rng = np.random.default_rng(int(density * 10))
    masks = rng.random((3, 96)) < density
    t_starts, t_sizes, t_n = tcontig.mask_to_runs(torch.from_numpy(masks))
    for i, m in enumerate(masks):
        js, jz, jn = jcontig.mask_to_runs_jax(jnp.asarray(m))
        np.testing.assert_array_equal(t_starts[i].numpy(), np.asarray(js))
        np.testing.assert_array_equal(t_sizes[i].numpy(), np.asarray(jz))
        assert int(t_n[i]) == int(jn)
        np.testing.assert_array_equal(
            tcontig.contiguity_histogram(torch.from_numpy(m), 8).numpy(),
            np.asarray(jcontig.contiguity_histogram_jax(jnp.asarray(m), 8)))
        np.testing.assert_allclose(float(tcontig.average_chunk_size(torch.from_numpy(m))),
                                   float(jcontig.average_chunk_size_jax(jnp.asarray(m))),
                                   rtol=1e-6)
        starts = rng.integers(0, 80, 20).astype(np.int32)
        sizes = rng.integers(0, 17, 20).astype(np.int32)
        res = rng.random(96) < 0.5
        np.testing.assert_array_equal(
            tcontig.resident_rows_in_windows(torch.from_numpy(starts), torch.from_numpy(sizes),
                                             torch.from_numpy(res)).numpy(),
            np.asarray(jlat.resident_rows_in_windows(jnp.asarray(starts), jnp.asarray(sizes),
                                                     jnp.asarray(res))))


@pytest.mark.parametrize("wbits", [16, 8])
@pytest.mark.parametrize("density", [0.2, 0.6, 0.95])
def test_mask_latency_miss_equals_reference(density, wbits):
    """One request per selected run, charged for its miss rows: equal to the
    reference's at rtol 1e-6; nothing resident gives ``mask_latency``,
    everything resident gives 0; batched equals row by row."""
    rng = np.random.default_rng(int(density * 100) + wbits)
    rb = tlat.row_stream_bytes(256, wbits)
    tt = tlat.profile_table("nano", rb, max_rows=32, torch_device="cpu")
    jt = jlat.profile_table("nano", rb, max_rows=32)
    masks = rng.random((4, 200)) < density
    res = rng.random((4, 200)) < 0.4
    got = tt.mask_latency_miss(torch.from_numpy(masks), torch.from_numpy(res))
    for i in range(4):
        want = float(jt.mask_latency_miss(jnp.asarray(masks[i]), jnp.asarray(res[i])))
        np.testing.assert_allclose(float(got[i]), want, rtol=1e-6)
        m = torch.from_numpy(masks[i])
        assert float(tt.mask_latency_miss(m, torch.zeros(200, dtype=torch.bool))) == \
            float(tt.mask_latency(m))
        assert float(tt.mask_latency_miss(m, torch.ones(200, dtype=torch.bool))) == 0.0


def test_sparsity_allocator_equals_reference():
    rng = np.random.default_rng(5)
    imps = [np.abs(rng.normal(0, s, 64)).astype(np.float32) for s in (0.5, 1.0, 2.0, 4.0)]
    tprof = [LayerProfile(f"l{i}", v) for i, v in enumerate(imps)]
    jprof = [jalloc.LayerProfile(f"l{i}", v) for i, v in enumerate(imps)]
    for target in (0.0, 0.3, 0.5, 0.8):
        got = allocate_sparsity(tprof, target)
        assert got == jalloc.allocate_sparsity(jprof, target)
        sizes = {k: 64 for k in got}
        assert budgets_from_sparsity(got, sizes) == jalloc.budgets_from_sparsity(got, sizes)
        assert abs(np.mean(list(got.values())) - target) < 0.05 + 1e-9
    assert [p.error_at(0.4) for p in tprof] == [p.error_at(0.4) for p in jprof]
    with pytest.raises(ValueError):
        allocate_sparsity(tprof, 1.0)


# -- the CLI ---------------------------------------------------------------------------------


def test_cli_cache_and_per_token(capsys):
    eng, out = tserve.main(["--arch", "tinyllama-1.1b", "--reduced", "--torch-device", "cpu",
                            "--cache-mb", "1", "--per-token", "--decode-tokens", "4",
                            "--max-seq", "48", "--prompt-len", "8"])
    text = capsys.readouterr().out
    assert out.shape == (2, 5) and eng.cache_mb == 1.0
    assert "[decode:per-token]" in text and "cache_mb=1 " in text
    assert "cache_hit_rate" in text and eng.io_summary()["hit_rows"] > 0
    for bad in (["--cache-mb", "-1"], ["--prefetch-depth", "-2"]):
        with pytest.raises(SystemExit):
            tserve.parse_args(["--reduced"] + bad)
    assert tserve.parse_args(["--prefetch-depth", "7"]).prefetch_depth == 7


def test_greedy_false_raises(lm):
    cfg, model, params = lm[:3]
    eng = TEngine(model, params, max_seq=64, batch_size=2, torch_device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="sampled decoding"):
        eng.decode(tok, 4, greedy=False)
    with pytest.raises(NotImplementedError, match="sampled decoding"):
        eng.decode_per_token(tok, 4, greedy=False)
