"""Storage fault injection and adaptive degradation in the port against
the JAX reference (``tests/test_faults.py``'s counterparts, less the
scheduler's), on the CPU at ``tinyllama-1.1b --reduced``.

Tolerances: the fault model and the degradation controller are numpy in
both packages and are compared exactly, outcome for outcome, as is the
simulator's event log on equal estimates. Between engines of the two
packages the estimates are f32 sums taken in another order (rtol 1e-6,
as in ``tests/test_torch_serve.py``); token, row, byte and event counts are
exact. ``select_overhead_s`` is a wall-clock time and is never compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.faults import FAULT_PROFILES as J_FAULT_PROFILES
from repro.core.faults import FaultModel as JFaultModel
from repro.core.faults import ThermalTrajectory as JThermal
from repro.core.offload import FlashOffloadSimulator as JSim
from repro.models import build_model as jbuild
from repro.serving import DegradationController as JController
from repro.serving import ServeEngine as JEngine
from repro.configs import get_config as jget
from repro_torch.configs import get_config as tget
from repro_torch.core import faults as tf
from repro_torch.core.offload import FlashOffloadSimulator as TSim
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.serving import IO_SUMMARY_KEYS, ServeEngine as TEngine
from repro_torch.serving.degrade import DegradationController as TController
from repro_torch.serving.sparse_exec import (
    SparseExecution as TSparse,
    plan_budget_scale,
    set_plan_budget_scale,
)
from torch_threads import one_thread  # noqa: F401

# the reference suite's aggressive profile: the throttle engages at once,
# spikes and retries land often
HAMMER = dict(spike_prob=0.3, spike_scale=4.0, fail_prob=0.2, max_retries=3)
HAMMER_THROTTLE = dict(onset_s=0.0, ramp_s=1e-6, floor=0.5)


def _hammer(mod):
    return mod.FaultProfile("hammer", **HAMMER,
                            throttle=mod.ThermalTrajectory(**HAMMER_THROTTLE))


def _profiles():
    import repro.core.faults as jf

    return {name: (J_FAULT_PROFILES[name], tf.FAULT_PROFILES[name])
            for name in tf.FAULT_PROFILES} | {"hammer": (_hammer(jf), _hammer(tf))}


# ---------------------------------------------------------------------------
# the fault model and the simulator's measurement boundary
# ---------------------------------------------------------------------------


def test_profiles_and_trajectories_equal_reference():
    assert set(tf.FAULT_PROFILES) == set(J_FAULT_PROFILES)
    for name, p in tf.FAULT_PROFILES.items():
        jp = dataclasses.asdict(J_FAULT_PROFILES[name])
        assert dataclasses.asdict(p) == jp
    for kw in (dict(onset_s=2e-3, ramp_s=10e-3, floor=0.25),
               dict(onset_s=0.0, ramp_s=10e-3, floor=0.4, period_s=40e-3),
               dict(onset_s=1e-3, ramp_s=0.0, floor=0.3)):
        jt, tt = JThermal(**kw), tf.ThermalTrajectory(**kw)
        for t in np.linspace(0.0, 0.2, 401):
            assert tt.scale(t) == jt.scale(t)
    for kw in (dict(floor=0.0), dict(onset_s=-1.0)):
        with pytest.raises(ValueError):
            tf.ThermalTrajectory(**kw)
    for kw in (dict(spike_prob=1.0), dict(spike_scale=0.5), dict(fail_prob=-0.1),
               dict(max_retries=-1), dict(backoff_mult=0.5)):
        with pytest.raises(ValueError):
            tf.FaultProfile("x", **kw)
    with pytest.raises(KeyError):
        tf.get_fault_profile("melted")


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("name", sorted(set(tf.FAULT_PROFILES) | {"hammer"}))
def test_fault_model_outcomes_equal_reference(name, seed):
    """Event by event on the same latencies and busy clocks: the same
    charge, retries, spike, throttle scale and backoff, and the same
    lifetime summary."""
    jp, tp = _profiles()[name]
    jm, tm = JFaultModel(jp, seed=seed), tf.FaultModel(tp, seed=seed)
    assert tm.enabled == jm.enabled
    rng = np.random.default_rng(seed)
    busy = 0.0
    for lat in rng.exponential(4e-4, 300):
        lat = float(lat) if rng.random() > 0.05 else 0.0
        a, b = jm.perturb(lat, busy), tm.perturb(lat, busy)
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        busy += a.charged_s
    assert tm.summary() == jm.summary()
    with pytest.raises(ValueError):
        tm.perturb(-1.0, 0.0)


@pytest.mark.parametrize("name", ["none", "tail_spikes", "flaky_reads", "thermal_cycle",
                                  "degraded_nvme", "hammer"])
def test_simulator_event_log_equals_reference(name):
    """The simulator with a fault model, on the same estimate arrays (zero
    steps and re-read seconds among them), through the batched and the
    scalar path: the reference's charged latencies and event log, field by
    field, and its busy clock."""
    jp, tp = _profiles()[name]
    js = JSim("nano", seed=5, faults=JFaultModel(jp, seed=2))
    ts = TSim("nano", seed=5, faults=tf.FaultModel(tp, seed=2))
    rng = np.random.default_rng(3)
    for call in range(4):
        est = rng.exponential(1e-3, 12) * (rng.random(12) > 0.25)
        extra = rng.exponential(1e-4, 12) * (rng.random(12) > 0.6)
        kw = dict(name="decode", hit_rates=rng.random(12), nbytes=rng.random(12) * 1e6,
                  integrity_s=extra)
        np.testing.assert_array_equal(ts.measure_from_estimate_batch(est, **kw),
                                      js.measure_from_estimate_batch(est, **kw))
        for e, x in ((float(est[0]), 0.0), (0.0, 2e-4), (0.0, 0.0), (3e-4, 1e-4)):
            assert ts.measure_from_estimate(e, name="step", integrity_s=x, nbytes=7.0) == \
                js.measure_from_estimate(e, name="step", integrity_s=x, nbytes=7.0)
    fields = ("name", "nbytes", "n_chunks", "latency_s", "hit_rate", "retries", "fault_s",
              "integrity_s")
    assert [tuple(getattr(e, f) for f in fields) for e in ts.log] == \
        [tuple(getattr(e, f) for f in fields) for e in js.log]
    assert ts.device_time_s == js.device_time_s


def test_simulator_fault_off_log_identical():
    """An inert fault model, or re-read seconds of 0, shift neither the
    jitter stream nor the event log."""
    a = TSim("nano", seed=5)
    b = TSim("nano", seed=5, faults=tf.FaultModel("none", seed=9))
    est = np.array([1e-4, 0.0, 3e-4, 2e-4])
    np.testing.assert_array_equal(a.measure_from_estimate_batch(est, name="x"),
                                  b.measure_from_estimate_batch(est, name="x",
                                                                integrity_s=np.zeros(4)))
    assert a.log == b.log and len(a.log) == 3
    assert a.measure_from_estimate(1e-4) == b.measure_from_estimate(1e-4)
    assert a.rng.random() == b.rng.random()


# ---------------------------------------------------------------------------
# the degradation controller
# ---------------------------------------------------------------------------


def _streams():
    """Ratio streams exercising every branch: healthy, sustained throttle
    and recovery, the hysteresis dead band, clamping at the floor, a
    non-step-aligned floor, non-finite entries, and seeded gamma noise."""
    out = {
        "healthy": [np.full(8, 1.0)] * 20,
        "throttle_then_recover": [np.full(16, 4.0)] * 3 + [np.full(16, 1.0)] * 10,
        "dead_band": [[1.4]] * 30 + [np.full(32, 4.0)] + [[1.4]] * 60,
        "clamp": [[4.0]] * 25,
        "garbage": [[np.nan, np.inf, 0.0, -1.0]] * 3 + [[2.0, np.nan]] * 4,
    }
    rng = np.random.default_rng(7)
    noisy = []
    for _ in range(60):
        r = rng.gamma(2.0, rng.choice([0.4, 1.2]), size=6)
        r[rng.integers(0, 6)] = rng.choice([np.nan, np.inf, 0.0, -2.0])
        noisy.append(r)
    out["noisy"] = noisy
    return out


@pytest.mark.parametrize("kw", [{}, dict(min_scale=0.5), dict(alpha=1.0, step=0.35)])
@pytest.mark.parametrize("stream", sorted(_streams()))
def test_controller_scale_sequences_equal_reference(stream, kw):
    jc, tc = JController(**kw), TController(**kw)
    for ratios in _streams()[stream]:
        assert tc.observe(ratios) == jc.observe(ratios)
        assert (tc.scale, tc.ewma, tc.degraded) == (jc.scale, jc.ewma, jc.degraded)
    assert tc.summary() == jc.summary()


def test_controller_observe_corruption_equals_reference():
    for gain in (20.0, 0.0, 200.0):
        jc, tc = JController(corruption_ratio_gain=gain), TController(corruption_ratio_gain=gain)
        for rate in [0.0] * 5 + [np.nan, -0.1] + [0.05] * 10 + [0.0] * 10 + [0.5]:
            assert tc.observe_corruption(rate) == jc.observe_corruption(rate)
        assert tc.summary() == jc.summary()
    for kw, match in ((dict(degrade_ratio=1.0, recover_ratio=1.2), "hysteresis"),
                      (dict(alpha=0.0), "alpha"), (dict(step=0.0), "step"),
                      (dict(min_scale=1.5), "min_scale"),
                      (dict(corruption_ratio_gain=-1.0), "corruption_ratio_gain")):
        with pytest.raises(ValueError, match=match):
            TController(**kw)


def test_budget_scale_lane():
    """``set_plan_budget_scale`` writes the lane of every site in place,
    refuses scales outside (0, 1], and leaves a plan without it alone;
    the refresh's budgets are the reference's ``clip(floor(b · s),
    min(b, 1), b)``."""
    cfg = tget("tinyllama-1.1b").reduced()
    sp = TSparse(cfg, degradable=True, torch_device="cpu")
    plan = sp.init_plan(cfg.n_layers)
    assert plan_budget_scale(plan) == 1.0
    assert torch.equal(sp._lane_budgets(plan), sp.lane_budgets)
    set_plan_budget_scale(plan, 0.37)
    assert all(float(e["bscale"].min()) == np.float32(0.37) for e in plan.values())
    b = np.array([sp.sites[k].budget() for k in sp.site_order])
    want = np.clip(np.floor(b.astype(np.float32) * np.float32(0.37)).astype(np.int32),
                   np.minimum(b, 1), b)
    np.testing.assert_array_equal(sp._lane_budgets(plan).numpy(), np.tile(want, cfg.n_layers))
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="scale"):
            set_plan_budget_scale(plan, bad)
    plain = TSparse(cfg, torch_device="cpu").init_plan(cfg.n_layers)
    set_plan_budget_scale(plain, 0.5)
    assert plan_budget_scale(plain) is None and "bscale" not in plain["ffn"]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    jcfg, tcfg = jget("tinyllama-1.1b").reduced(), tget("tinyllama-1.1b").reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    return jm, tm, jp, tp


def _engine(cls, model, params, **kw):
    kw.setdefault("method", "chunk")
    if cls is TEngine:
        kw.setdefault("torch_device", "cpu")
    return cls(model, params, max_seq=64, batch_size=2, device="nano", sparsity=0.4, seed=1,
               **kw)


def _tok0(cls):
    return (jnp.ones((2, 1), jnp.int32) if cls is JEngine
            else torch.ones((2, 1), dtype=torch.int64))


def _sim_summary(eng):
    s = eng.io_summary()
    s.pop("select_overhead_s")
    return s


@pytest.mark.parametrize("backend,wbits", [("reference", 16), ("kernel", 8)])
def test_engine_defaults_are_the_unfaulted_engine(lm, backend, wbits):
    """Every new argument at its default, or its inert value: the tokens,
    ``io_summary``, event log and plan lanes of an engine without the
    robustness layer (the plan carries no new lane; the fault and
    corruption keys read their quiescent values)."""
    _, tm, _, tp = lm
    base = _engine(TEngine, tm, tp, backend=backend, wbits=wbits)
    t_base = base.decode(_tok0(TEngine), 5)
    off = _engine(TEngine, tm, tp, backend=backend, wbits=wbits, fault_profile="none",
                  fault_seed=123, corruption_profile="none", degrade=False, max_reread=0)
    t_off = off.decode(_tok0(TEngine), 5)
    assert torch.equal(t_base, t_off)
    assert _sim_summary(base) == _sim_summary(off)
    assert base.simulator.log == off.simulator.log
    for plan in (base._plan, off._plan):
        assert all(set(e) == {"mask", "pending", "hit", "miss", "bytes", "kstarts", "ksizes"}
                   for e in plan.values())
    s = base.io_summary()
    assert set(s) == set(IO_SUMMARY_KEYS)
    assert s["min_throttle_scale"] == 1.0 and s["fault_events"] == 0
    assert s["corruptions_detected"] == 0.0 == s["integrity_reread_s"]
    assert "_ck" not in "".join(base.params["layers"])
    fs = off.fault_summary()
    assert not fs["fault_enabled"] and fs["fault_events"] == 0 and fs["degrade_scale"] == 1.0


@pytest.mark.parametrize("name", sorted(set(tf.FAULT_PROFILES) - {"none"}))
def test_engine_fault_run_equals_reference(lm, name):
    """A fault profile on both engines: the same tokens (faults change time
    only), the same fault counts, and the same charged time."""
    jm, tm, jp, tp = lm
    jeng = _engine(JEngine, jm, jp, fault_profile=name, fault_seed=3)
    teng = _engine(TEngine, tm, tp, fault_profile=name, fault_seed=3)
    jt, tt = jeng.decode(_tok0(JEngine), 5), teng.decode(_tok0(TEngine), 5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    js, ts = jeng.io_summary(), teng.io_summary()
    for key in IO_SUMMARY_KEYS:
        if key == "select_overhead_s":
            continue
        if key in ("steps", "hit_rows", "miss_rows", "io_bytes", "fault_events",
                   "fault_spikes", "fault_retries"):
            assert ts[key] == js[key], key
        else:
            np.testing.assert_allclose(ts[key], js[key], rtol=1e-6, err_msg=key)
    assert ts["fault_events"] > 0
    clean = _engine(TEngine, tm, tp)
    assert torch.equal(clean.decode(_tok0(TEngine), 5), tt)
    # the charged time moves exactly when the model perturbed an event (five
    # events may draw no spike or failure at 5 % or 8 %)
    perturbed = ts["fault_spikes"] + ts["fault_retries"] > 0 or ts["min_throttle_scale"] < 1.0
    assert (ts["io_sim_s"] > clean.io_summary()["io_sim_s"]) == perturbed
    assert ts["io_sim_s"] >= clean.io_summary()["io_sim_s"]


@pytest.mark.parametrize("backend,wbits", [("reference", 16), ("kernel", 8)])
def test_engine_faults_perturb_time_never_tokens(lm, backend, wbits):
    _, tm, _, tp = lm
    base = _engine(TEngine, tm, tp, backend=backend, wbits=wbits)
    t_base = base.decode(_tok0(TEngine), 5)
    faulty = _engine(TEngine, tm, tp, backend=backend, wbits=wbits,
                     fault_profile=_hammer(tf), fault_seed=3)
    assert torch.equal(t_base, faulty.decode(_tok0(TEngine), 5))
    sb, sf = _sim_summary(base), _sim_summary(faulty)
    assert sf["io_est_s"] == sb["io_est_s"] and sf["io_bytes"] == sb["io_bytes"]
    assert sf["io_sim_s"] > sb["io_sim_s"]
    assert faulty.fault_summary()["fault_events"] > 0
    runs = []
    for seed in (3, 3, 4):
        e = _engine(TEngine, tm, tp, fault_profile=_hammer(tf), fault_seed=seed)
        e.decode(_tok0(TEngine), 5)
        runs.append((_sim_summary(e), e.fault_summary()))
    assert runs[0] == runs[1]
    assert runs[2][0]["io_sim_s"] != runs[0][0]["io_sim_s"]


def test_engine_degrade_clean_device_identity(lm):
    """The controller on a healthy device never leaves scale 1.0, and the
    run is bit-identical to one without it."""
    _, tm, _, tp = lm
    base = _engine(TEngine, tm, tp)
    on = _engine(TEngine, tm, tp, degrade=True)
    assert torch.equal(base.decode(_tok0(TEngine), 6), on.decode(_tok0(TEngine), 6))
    assert _sim_summary(base) == _sim_summary(on)
    assert on.fault_summary()["degrade_scale"] == 1.0


@pytest.mark.parametrize("per_token", [False, True])
def test_engine_degrade_tightens_under_throttle_like_reference(lm, per_token):
    """``thermal_throttle`` with and without the controller, four calls of
    four tokens (noise off, as in the reference suite): the controller
    tightens the budget, which cuts the bytes and the simulated I/O; the
    port's scale sequence and byte counts are the reference engine's."""
    jm, tm, jp, tp = lm

    def run(cls, model, params, degrade):
        e = _engine(cls, model, params, fault_profile="thermal_throttle", degrade=degrade)
        e.simulator.noise = 0.0
        scales, tok = [], _tok0(cls)
        for _ in range(4):
            (e.decode_per_token if per_token else e.decode)(tok, 4)
            scales.append(e.fault_summary()["degrade_scale"])
        return e, scales

    off, _ = run(TEngine, tm, tp, False)
    on, scales = run(TEngine, tm, tp, True)
    fs = on.fault_summary()
    assert fs["degrade_scale"] < 1.0 and fs["degrade_tighten_steps"] >= 1
    assert on.io_summary()["io_bytes"] < off.io_summary()["io_bytes"]
    assert on.io_summary()["io_sim_s"] < off.io_summary()["io_sim_s"]
    if not per_token:
        jon, jscales = run(JEngine, jm, jp, True)
        assert scales == jscales
        assert on.io_summary()["io_bytes"] == jon.io_summary()["io_bytes"]
        np.testing.assert_allclose(fs["degrade_ewma_ratio"],
                                   jon.fault_summary()["degrade_ewma_ratio"], rtol=1e-6)


def test_engine_degrade_needs_selecting_method(lm):
    _, tm, _, tp = lm
    with pytest.raises(ValueError, match="degrade"):
        _engine(TEngine, tm, tp, method="dense", degrade=True)


def test_cli_fault_and_degrade_flags(capsys):
    eng, out = tserve.main(["--arch", "tinyllama-1.1b", "--reduced", "--torch-device", "cpu",
                            "--decode-tokens", "3", "--max-seq", "48", "--prompt-len", "8",
                            "--fault-profile", "thermal_throttle", "--fault-seed", "2",
                            "--degrade"])
    text = capsys.readouterr().out
    assert "[faults] profile=thermal_throttle seed=2" in text
    assert eng.faults is not None and eng.degrade_controller is not None
    assert out.shape == (2, 4)
    args = tserve.parse_args([])
    assert (args.fault_profile, args.fault_seed, args.corruption_profile, args.corruption_seed,
            args.max_reread, args.recover, args.degrade) == ("none", 0, "none", 0, 2, True,
                                                             False)
    assert tserve.parse_args(["--no-degrade", "--recover"]).degrade is False
    for bad in (["--fault-seed", "7"], ["--fault-profile", "melted"]):
        with pytest.raises(SystemExit):
            tserve.parse_args(bad)
    # the port's parser offers the reference's choices for every ported flag
    from repro.launch.serve import build_parser as jparser

    jp = {a.dest: a for a in jparser()._actions}
    for a in tserve.build_parser()._actions:
        if a.dest in ("fault_profile", "corruption_profile", "max_reread", "recover",
                      "degrade", "fault_seed", "corruption_seed"):
            assert (a.default, a.choices, a.option_strings) == \
                (jp[a.dest].default, jp[a.dest].choices, jp[a.dest].option_strings)
