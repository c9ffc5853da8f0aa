"""The port's continuous-batching serve stack, on the CPU at
``tinyllama-1.1b --reduced``: the reference suite's scheduler tests
(``tests/test_scheduler.py``: lifecycle, fused decode against the per-token
loop, plan reuse, slot-mode invariants, EDF admission and preemption) and
its two deadline scenarios of ``tests/test_faults.py``, ported — then
whole ``Scheduler.run``s of the port against the JAX package on the same
Poisson arrivals, prompts and carried-over weights, paged and dense, at
wbits 16 and 8.

Tolerances: every request's tokens and the integer ``SchedulerStats``
fields are compared exactly; the float fields (the simulated clock, its
percentiles and the hidden stall seconds) are sums of f32 per-layer
estimates taken in another order, run through the same numpy simulator and
pipeline: rtol 1e-6, as in ``tests/test_torch_serve.py``. The runs start
from the shared uniform bootstrap and select on importances of bf16
activations; at these settings no near tie tips a mask, so no mask is
replayed from the reference. A request's first token is the argmax of its
bf16 prefill logits, which the two packages reduce in different orders (a
few bf16 ulps apart, ``BF16_TOL``): the prompts are drawn from a seed
whose three prefills each keep a top-2 margin above that tolerance in the
reference, and the test checks that margin first — a prompt whose two best
logits lie within one ulp would tip either way, in either package.

The port runs single-threaded here (a module fixture, restored after): the
CPU's intra-op threads cost ten times the arithmetic at these widths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.serving import PoissonArrivalDriver as JDriver
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.models import build_model, params_from_reference
from repro_torch.models.inputs import make_dummy_batch
from repro_torch.serving import (
    IO_SUMMARY_KEYS,
    PoissonArrivalDriver,
    Request,
    RequestState,
    Scheduler,
    ServeEngine,
)

SMOKE = InputShape(name="smoke", seq_len=16, global_batch=2, kind="train")
BF16_TOL = 4e-2
# the seed of the parity runs' three prompts (see the module docstring)
PROMPT_SEED = 2
INT_STATS = ("finished", "decode_tokens", "admitted_during_stall", "deadlines",
             "deadlines_met", "preempted")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    jcfg = jget("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    jm, model = jbuild(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(0))
    params = params_from_reference(jax.device_get(jp), cfg, "cpu")
    return cfg, model, params, jm, jp


def _engine(model, params, method="chunk", refresh=1, batch=2, seed=1, **kw):
    return ServeEngine(model, params, max_seq=64, batch_size=batch, device="nano",
                       sparsity=0.4, method=method, seed=seed,
                       plan_refresh_interval=refresh, torch_device="cpu", **kw)


def _requests(cfg, n, max_new=4, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    return [Request(rid=rid, prompt={"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 8)))}, max_new_tokens=max_new)
        for rid in range(n)]


def _batch(cfg):
    return make_dummy_batch(cfg, SMOKE, device="cpu")


# -- scheduler lifecycle -----------------------------------------------------


def test_admission_eviction_more_requests_than_slots(lm):
    cfg, model, params, *_ = lm
    eng = _engine(model, params, batch=2)
    sched = Scheduler(eng, round_tokens=2)
    reqs = _requests(cfg, 5, max_new=3)
    for i, r in enumerate(reqs):
        r.arrival_s = 0.001 * i
    sched.submit(reqs)
    # the first iteration can admit at most the 2 slots
    assert sched.step()
    assert sched.num_running() <= 2
    stats = sched.run()
    assert stats.finished == 5
    assert all(r.state is RequestState.FINISHED for r in reqs)
    assert all(len(r.tokens_out) == 3 for r in reqs)
    # FCFS: finish order respects arrival order for equal-length requests
    assert [r.rid for r in sched.finished] == [0, 1, 2, 3, 4]
    # slots were recycled (eviction worked): all free at drain
    assert sched.free_slots() == [0, 1]
    # timing marks are causally ordered on the simulated clock
    for r in reqs:
        assert r.arrival_s <= r.admitted_s <= r.first_token_s <= r.finished_s
        assert r.latency_s() > 0 and r.ttft_s() > 0


def test_poisson_driver_monotone_arrivals(lm):
    cfg, *_ = lm
    driver = PoissonArrivalDriver(100.0, lambda rid: _requests(cfg, 1)[0], seed=4)
    reqs = driver.generate(10)
    arrivals = [r.arrival_s for r in reqs]
    assert all(a < b for a, b in zip(arrivals, arrivals[1:]))
    assert arrivals[0] > 0
    with pytest.raises(ValueError):
        PoissonArrivalDriver(0.0, lambda rid: None)


def test_poisson_driver_arrivals_equal_reference(lm):
    """numpy's ``default_rng`` draws the same gaps in both packages."""
    cfg, *_ = lm
    mk = lambda rid: _requests(cfg, 1)[0]  # noqa: E731
    got = [r.arrival_s for r in PoissonArrivalDriver(37.0, mk, seed=9).generate(12)]
    jmk = lambda rid: JRequest(rid=rid, prompt={"tokens": jnp.zeros((1, 2), jnp.int32)},  # noqa: E731
                               max_new_tokens=1)
    want = [r.arrival_s for r in JDriver(37.0, jmk, seed=9).generate(12)]
    assert got == want


def test_scheduler_idle_fast_forwards_to_arrival(lm):
    cfg, model, params, *_ = lm
    sched = Scheduler(_engine(model, params, batch=2), round_tokens=2)
    reqs = _requests(cfg, 1, max_new=2)
    reqs[0].arrival_s = 5.0  # far in the simulated future
    sched.submit(reqs)
    stats = sched.run()
    assert stats.finished == 1
    assert reqs[0].admitted_s >= 5.0


# -- fused decode vs per-token loop ------------------------------------------


@pytest.mark.parametrize("method", ["chunk", "topk", "dense", "dense_free"])
def test_fused_decode_matches_per_token(lm, method):
    cfg, model, params, *_ = lm
    batch = _batch(cfg)
    eng_f = _engine(model, params, method=method, seed=3)
    eng_l = _engine(model, params, method=method, seed=3)
    tok0 = torch.argmax(eng_f.prefill(batch), dim=-1)[:, None]
    eng_l.prefill(batch)
    out_f = eng_f.decode(tok0, 6)
    out_l = eng_l.decode_per_token(tok0, 6)
    assert torch.equal(out_f, out_l), "tokens must be byte-identical"
    io_f = [s.io_est_s for s in eng_f.stats if s.kind == "decode"]
    io_l = [s.io_est_s for s in eng_l.stats if s.kind == "decode"]
    np.testing.assert_allclose(io_f, io_l, rtol=1e-6)
    np.testing.assert_allclose(sum(io_f), sum(io_l), rtol=1e-6)


def test_fused_decode_matches_per_token_with_plan_reuse(lm):
    """At refresh>1 the two modes agree on tokens, estimates AND simulated
    measurements — the batch simulator path consumes the RNG stream and
    event log exactly as the scalar path does."""
    cfg, model, params, *_ = lm
    batch = _batch(cfg)
    eng_f = _engine(model, params, refresh=2, seed=3)
    eng_l = _engine(model, params, refresh=2, seed=3)
    tok0 = torch.argmax(eng_f.prefill(batch), dim=-1)[:, None]
    eng_l.prefill(batch)
    out_f = eng_f.decode(tok0, 6)
    out_l = eng_l.decode_per_token(tok0, 6)
    assert torch.equal(out_f, out_l)
    sim_f = [s.io_sim_s for s in eng_f.stats if s.kind == "decode"]
    sim_l = [s.io_sim_s for s in eng_l.stats if s.kind == "decode"]
    np.testing.assert_allclose(sim_f, sim_l, rtol=1e-9)
    assert len(eng_f.simulator.log) == len(eng_l.simulator.log)


def test_fused_decode_single_host_sync_accounting(lm):
    """The fused path logs one StepStats per token (the loop's granularity)
    from ONE transfer of the loop's estimates."""
    cfg, model, params, *_ = lm
    eng = _engine(model, params)
    tok0 = torch.argmax(eng.prefill(_batch(cfg)), dim=-1)[:, None]
    out = eng.decode(tok0, 5)
    assert tuple(out.shape) == (2, 6)
    steps = [s for s in eng.stats if s.kind == "decode"]
    assert len(steps) == 5
    assert all(s.io_sim_s > 0 and s.io_est_s > 0 for s in steps)


# -- chunk-plan reuse --------------------------------------------------------


def test_plan_reuse_refresh_cadence_and_latency_bound(lm):
    """With plan_refresh_interval=k, selection I/O is paid on exactly
    ceil(n/k) steps; reuse steps are free and no reuse-mode step exceeds
    the per-step refresh-mode estimate."""
    cfg, model, params, *_ = lm
    batch = _batch(cfg)
    n = 8
    eng1 = _engine(model, params, refresh=1, seed=3)
    tok0 = torch.argmax(eng1.prefill(batch), dim=-1)[:, None]
    eng1.decode(tok0, n)
    io1 = [s.io_est_s for s in eng1.stats if s.kind == "decode"]
    engk = _engine(model, params, refresh=3, seed=3)
    engk.prefill(batch)
    engk.decode(tok0, n)
    iok = [s.io_est_s for s in engk.stats if s.kind == "decode"]
    refresh_steps = [i for i, v in enumerate(iok) if v > 0]
    assert refresh_steps == [0, 3, 6]  # every k-th step
    assert all(v == 0.0 for i, v in enumerate(iok) if i not in refresh_steps)
    assert max(iok) <= max(io1) * 1.25 + 1e-12
    assert sum(iok) < sum(io1)


def test_plan_reuse_interval_one_is_identity(lm):
    cfg, model, params, *_ = lm
    eng1 = _engine(model, params, refresh=1, seed=3)
    tok0 = torch.argmax(eng1.prefill(_batch(cfg)), dim=-1)[:, None]
    out1 = eng1.decode(tok0, 5)
    io1 = [s.io_est_s for s in eng1.stats if s.kind == "decode"]
    assert all(v > 0 for v in io1)  # every step refreshes → every step pays
    assert tuple(out1.shape) == (2, 6)


def test_plan_refresh_interval_validation(lm):
    cfg, model, params, *_ = lm
    with pytest.raises(ValueError):
        _engine(model, params, refresh=0)


# -- slot-mode engine invariants ---------------------------------------------


def test_admit_slot_isolates_requests(lm):
    """Admitting into one slot does not disturb the other slot's length,
    and per-slot lengths advance together under decode_slots."""
    cfg, model, params, *_ = lm
    eng = _engine(model, params, batch=2)
    eng.enable_slots()
    reqs = _requests(cfg, 2, max_new=2)
    last0, _ = eng.admit_slot(0, reqs[0].prompt)
    assert eng.slot_lengths().tolist() == [8, 0]
    last1, _ = eng.admit_slot(1, reqs[1].prompt)
    assert eng.slot_lengths().tolist() == [8, 8]
    toks = torch.cat([torch.argmax(last0, dim=-1)[:, None], torch.argmax(last1, dim=-1)[:, None]])
    new_toks, sims = eng.decode_slots(toks, 3)
    assert tuple(new_toks.shape) == (2, 3)
    assert eng.slot_lengths().tolist() == [11, 11]
    assert eng.cache["length"].dtype == torch.int32
    with pytest.raises(ValueError):
        eng.admit_slot(7, reqs[0].prompt)


def test_slot_calls_need_slot_mode(lm):
    """The slot calls refuse a single-stream engine (its cache length is a
    host int) until ``enable_slots``; a single-stream prefill leaves slot
    mode again."""
    cfg, model, params, *_ = lm
    eng = _engine(model, params, batch=2)
    req = _requests(cfg, 1)[0]
    for call in (lambda: eng.admit_slot(0, req.prompt), lambda: eng.release_slot(0),
                 lambda: eng.decode_slots(torch.zeros((2, 1), dtype=torch.int64), 1)):
        with pytest.raises(RuntimeError, match="enable_slots"):
            call()
    eng.enable_slots()
    eng.admit_slot(0, req.prompt)
    eng.prefill(_batch(cfg))
    assert eng.cache["length"] == 16
    with pytest.raises(RuntimeError, match="enable_slots"):
        eng.release_slot(0)


def test_dense_free_validated_in_one_place(lm):
    """``dense_free`` is an engine-level policy: ServeEngine accepts it and
    skips SparseExecution; SparseExecution only knows the streaming
    methods. Both validate against the shared method tuples."""
    from repro_torch.serving import SERVE_METHODS, SPARSE_METHODS, SparseExecution
    from repro_torch.serving.sparse_exec import validate_method

    cfg, model, params, *_ = lm
    assert set(SERVE_METHODS) == set(SPARSE_METHODS) | {"dense_free"}
    assert validate_method("dense_free", allow_dense_free=True) == "dense_free"
    with pytest.raises(ValueError):
        validate_method("dense_free")  # streaming contexts reject it
    with pytest.raises(ValueError):
        validate_method("bogus", allow_dense_free=True)
    with pytest.raises(ValueError):
        SparseExecution(cfg, method="dense_free", torch_device="cpu")
    with pytest.raises(ValueError):
        _engine(model, params, method="bogus")
    eng = _engine(model, params, method="dense_free")
    assert eng.sparse_ctx is None
    tok0 = torch.argmax(eng.prefill(_batch(cfg)), dim=-1)[:, None]
    out = eng.decode(tok0, 3)
    assert tuple(out.shape) == (2, 4)
    s = eng.io_summary()
    assert s["io_est_s"] == 0.0 and s["io_sim_s"] == 0.0  # no flash tier


def test_slot_decode_matches_single_stream(lm):
    """A request decoded in slot mode gives the tokens of the same prompt
    decoded through the single-stream path."""
    cfg, model, params, *_ = lm
    req = _requests(cfg, 1, max_new=4)[0]
    eng_s = _engine(model, params, batch=1, seed=3)
    eng_s.enable_slots()
    last, _ = eng_s.admit_slot(0, req.prompt)
    tok0 = torch.argmax(last, dim=-1)[:, None]
    slot_toks, _ = eng_s.decode_slots(tok0, 4)
    eng_c = _engine(model, params, batch=1, seed=3)
    _, eng_c.cache = model.prefill(params, req.prompt, 64)
    out_c = eng_c.decode(tok0, 4)
    assert torch.equal(slot_toks, out_c[:, 1:])


# -- failure paths and SLO machinery -----------------------------------------


def test_stats_empty_is_nan_not_zero(lm):
    """Zero finished requests yield NaN percentiles (and finished=0), never
    a fabricated 0.0 a latency floor could pass vacuously."""
    cfg, model, params, *_ = lm
    s = Scheduler(_engine(model, params), round_tokens=2).stats()
    assert s.finished == 0 and s.decode_tokens == 0
    assert np.isnan(s.latency_p50_s) and np.isnan(s.latency_p95_s)
    assert np.isnan(s.latency_p99_s) and np.isnan(s.ttft_p50_s)
    assert np.isnan(s.slo_attainment) and s.deadlines == 0
    assert s.preempted == 0


def test_run_drain_timeout_raises(lm):
    """run(max_rounds) fails loudly when the workload cannot drain in the
    allotted rounds instead of spinning forever."""
    cfg, model, params, *_ = lm
    sched = Scheduler(_engine(model, params), round_tokens=1)
    sched.submit(_requests(cfg, 1, max_new=8))  # needs >= 8 rounds
    with pytest.raises(RuntimeError, match="did not drain in 2 rounds"):
        sched.run(max_rounds=2)


def test_over_decode_tokens_dropped(lm):
    """A request finishing mid-round keeps none of the round's filler
    tokens: max_new is exact even when round_tokens over-decodes."""
    cfg, model, params, *_ = lm
    sched = Scheduler(_engine(model, params), round_tokens=4)
    reqs = _requests(cfg, 2, max_new=3)
    sched.submit(reqs)
    stats = sched.run()
    assert stats.finished == 2
    assert all(len(r.tokens_out) == 3 for r in reqs)
    assert stats.decode_tokens == 6  # dropped filler never counted


def test_edf_admission_orders_by_deadline(lm):
    """With deadlines attached, admission is earliest-deadline-first; the
    latest-deadline request waits for a recycled slot."""
    cfg, model, params, *_ = lm
    sched = Scheduler(_engine(model, params, batch=2), round_tokens=2)
    reqs = _requests(cfg, 3, max_new=4)
    for r, d in zip(reqs, [10.0, 1.0, 5.0]):
        r.deadline_s = d  # all arrive at t=0
    sched.submit(reqs)
    assert sched.step()  # 4 tokens at round_tokens=2: nobody finishes yet
    assert sorted(r.rid for r in sched.running if r is not None) == [1, 2]
    stats = sched.run()
    assert stats.finished == 3 and stats.deadlines == 3
    assert [r.rid for r in sched.finished] == [1, 2, 0]


def test_preemption_recycles_slots_and_drains(lm):
    """Deadline-blown requests are evicted and requeued (at most once), the
    freed slots are reused, and every request still finishes with exactly
    its max_new tokens."""
    cfg, model, params, *_ = lm
    eng = _engine(model, params, fault_profile="thermal_throttle", fault_seed=0)
    eng.simulator.noise = 0.0
    sched = Scheduler(eng, round_tokens=2)
    reqs = _requests(cfg, 8, max_new=6)
    for i, r in enumerate(reqs):
        r.arrival_s = 0.002 * i
        r.deadline_s = 0.03
    sched.submit(reqs)
    stats = sched.run()
    assert stats.finished == 8
    assert stats.preempted >= 1
    pre = [r for r in reqs if r.preemptions > 0]
    assert pre and all(r.preemptions == 1 for r in pre)  # capped at one
    assert all(r.state is RequestState.FINISHED for r in reqs)
    assert all(len(r.tokens_out) == 6 for r in reqs)
    assert sched.free_slots() == [0, 1]
    for r in pre:
        assert r.arrival_s <= r.admitted_s <= r.finished_s


# -- deadlines under a sustained throttle (tests/test_faults.py) -------------


def _deadline_requests(cfg, n, max_new=6, deadline=0.03, gap=0.002):
    rng = np.random.default_rng(0)
    return [Request(rid=rid, prompt={"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 8)))}, max_new_tokens=max_new,
        arrival_s=gap * rid, deadline_s=deadline) for rid in range(n)]


def _run_throttled(cfg, model, params, degrade):
    eng = _engine(model, params, fault_profile="thermal_throttle", fault_seed=0,
                  degrade=degrade)
    eng.simulator.noise = 0.0  # fully deterministic under the fault seed
    sched = Scheduler(eng, round_tokens=2)
    reqs = _deadline_requests(cfg, 8)
    sched.submit(reqs)
    return sched.run(), eng, reqs


def test_controller_on_beats_off_on_slo(lm):
    """Sustained thermal throttle, per-request deadlines: the controller ON
    gives strictly higher attainment and strictly lower p99; the degraded
    baseline blows deadlines and preempts (the preempted request is
    requeued, readmitted and still finishes)."""
    cfg, model, params, *_ = lm
    off, _, _ = _run_throttled(cfg, model, params, degrade=False)
    on, eng_on, _ = _run_throttled(cfg, model, params, degrade=True)
    assert off.finished == on.finished == 8  # both drained completely
    assert on.slo_attainment > off.slo_attainment
    assert on.latency_p99_s < off.latency_p99_s
    assert off.preempted >= 1
    assert eng_on.fault_summary()["degrade_scale"] < 1.0
    # deterministic: the same seeds replay the exact same stats
    off2, _, _ = _run_throttled(cfg, model, params, degrade=False)
    assert off2 == off


def test_preempted_run_replays_token_identical(lm):
    """Evict-and-requeue restarts generation from the prompt; under a fixed
    fault seed the whole preempting run — every restarted request's final
    tokens included — replays bit-identically."""
    cfg, model, params, *_ = lm
    _, _, a = _run_throttled(cfg, model, params, degrade=False)
    pre = [r for r in a if r.preemptions > 0]
    assert pre, "scenario must exercise preemption"
    assert all(len(r.tokens_out) == r.max_new_tokens for r in a)
    _, _, b = _run_throttled(cfg, model, params, degrade=False)
    for ra, rb in zip(a, b):
        assert ra.tokens_out == rb.tokens_out
        assert ra.preemptions == rb.preemptions


# -- whole scheduler runs against the JAX package ----------------------------


def _parity_prompts(cfg):
    rng = np.random.default_rng(PROMPT_SEED)
    return [rng.integers(0, cfg.vocab_size, (1, 12)) for _ in range(3)]


def test_parity_prompts_have_clear_first_tokens(lm):
    """The precondition of the parity runs: each prompt's reference prefill
    logits keep a top-2 margin above the frameworks' bf16 difference, and
    the port's first token is the reference's."""
    cfg, model, params, jm, jp = lm
    for t in _parity_prompts(cfg):
        jl = np.asarray(jm.prefill(jp, {"tokens": jnp.asarray(t, jnp.int32)}, 32)[0],
                        np.float32)[0]
        tl = model.prefill(params, {"tokens": torch.from_numpy(t)}, 32)[0].float().numpy()[0]
        top2 = np.sort(jl)[-2:]
        assert top2[1] - top2[0] > BF16_TOL
        assert int(tl.argmax()) == int(jl.argmax())
        np.testing.assert_allclose(tl, jl, atol=BF16_TOL, rtol=BF16_TOL)


def _poisson_run(side, lm, paged, wbits, deadline=None, rate=300.0, **kw):
    """6 Poisson arrivals (``rate``/s, seed 1) of 12-token prompts, three of
    them repeated (prefix sharing when paged), 4 new tokens each, through 2
    slots at round_tokens 2, on the port or the reference; ``deadline``
    gives every request that SLO, ``kw`` goes to the engine."""
    cfg, model, params, jm, jp = lm
    toks = _parity_prompts(cfg)
    common = dict(max_seq=32, batch_size=2, device="nano", sparsity=0.4, method="chunk",
                  seed=5, cache_mb=64.0, wbits=wbits, kv_page_tokens=8 if paged else None,
                  **kw)
    if side == "jax":
        eng = JEngine(jm, jp, **common)
        mk = lambda rid: JRequest(rid=rid, max_new_tokens=4, deadline_s=deadline,  # noqa: E731
                                  prompt={"tokens": jnp.asarray(toks[rid % 3], jnp.int32)})
        sched = JScheduler(eng, round_tokens=2)
        sched.submit(JDriver(rate, mk, seed=1).generate(6))
    else:
        eng = ServeEngine(model, params, torch_device="cpu", **common)
        mk = lambda rid: Request(rid=rid, max_new_tokens=4, deadline_s=deadline,  # noqa: E731
                                 prompt={"tokens": torch.from_numpy(toks[rid % 3])})
        sched = Scheduler(eng, round_tokens=2)
        sched.submit(PoissonArrivalDriver(rate, mk, seed=1).generate(6))
    stats = sched.run()
    return eng, stats, {r.rid: list(r.tokens_out) for r in sched.finished}


@pytest.mark.parametrize("paged,wbits,deadline", [
    (False, 16, None), (True, 16, None), (False, 8, None), (True, 8, None),
    # a sustained throttle, arrivals at 1000/s and a 2 ms deadline that
    # every request blows: EDF admission and deadline preemption
    (True, 16, 0.002)], ids=["dense-16", "paged-16", "dense-8", "paged-8", "paged-16-slo"])
def test_scheduler_run_equals_reference(lm, paged, wbits, deadline):
    """Every request's tokens equal the reference's, the integer stats are
    exact and the float stats within rtol 1e-6; so is the engine's
    ``io_summary`` (bar the wall-clock ``select_overhead_s``), its
    admission lanes and paged-KV lanes included."""
    kw = {} if deadline is None else dict(fault_profile="thermal_throttle", fault_seed=0,
                                          rate=1000.0)
    jeng, jstats, jtoks = _poisson_run("jax", lm, paged, wbits, deadline, **kw)
    teng, tstats, ttoks = _poisson_run("torch", lm, paged, wbits, deadline, **kw)
    assert ttoks == jtoks and tstats.finished == 6
    if deadline is not None:
        assert tstats.preempted >= 1 and tstats.deadlines == 6
    for f in dataclasses.fields(tstats):
        got, want = getattr(tstats, f.name), getattr(jstats, f.name)
        if f.name in INT_STATS:
            assert got == want, f.name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f.name)
    js, ts = jeng.io_summary(), teng.io_summary()
    assert set(ts) == set(IO_SUMMARY_KEYS) == set(js)
    assert list(IO_SUMMARY_KEYS) == list(js)
    for key in IO_SUMMARY_KEYS:
        if key != "select_overhead_s":
            np.testing.assert_allclose(ts[key], js[key], rtol=1e-6, err_msg=key)
    if paged:
        assert teng.kv_pool.summary() == jeng.kv_pool.summary()
