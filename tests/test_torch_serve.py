"""The port's ServeEngine against the JAX reference engine on the same
(carried-over) parameters and prompt, its backends against each other, and
its CLI — all on the CPU at ``tinyllama-1.1b --reduced``.

Tolerances: greedy tokens, selected/missed row counts and transfer bytes
are compared exactly (same inputs, same masks). Latency figures are f32
sums of per-layer estimates taken in another order, then run through the
same numpy simulator and pipeline: rtol 1e-6. ``select_overhead_s`` is a
wall-clock measurement and is not compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import InputShape as JShape
from repro.models import build_model as jbuild
from repro.models.inputs import make_dummy_batch as jbatch
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape as TShape
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.models.inputs import make_dummy_batch as tbatch
from repro_torch.serving import IO_SUMMARY_KEYS, ServeEngine as TEngine

EXACT_KEYS = ("steps", "hit_rows", "miss_rows", "cache_hit_rate", "io_bytes")
WALL_KEYS = ("select_overhead_s",)


@pytest.fixture(scope="module")
def pair():
    jcfg = jget("tinyllama-1.1b").reduced()
    tcfg = tget("tinyllama-1.1b").reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    jb = jbatch(jcfg, JShape("t", 16, 2, "train"))
    tb = tbatch(tcfg, TShape("t", 16, 2, "train"), device="cpu")
    return jm, tm, jp, tp, jb, tb


def _serve(engine_cls, model, params, batch, n_tokens=6, **kw):
    eng = engine_cls(model, params, max_seq=64, batch_size=2, device="nano", sparsity=0.4,
                     seed=3, **kw)
    last = eng.prefill(batch)
    if engine_cls is JEngine:
        tok0 = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
    else:
        tok0 = torch.argmax(last, dim=-1)[:, None]
    return eng, np.asarray(eng.decode(tok0, n_tokens))


def _assert_summaries_match(got, want):
    for key in IO_SUMMARY_KEYS:
        if key in WALL_KEYS:
            continue
        if key in EXACT_KEYS:
            assert got[key] == want[key], key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("wbits,method,interval,n_tokens", [
    (16, "chunk", 1, 6), (8, "chunk", 1, 6),
    # topk's later refreshes rank importances recorded from bf16 activations,
    # whose last bits differ across the two frameworks and may tip a rank;
    # its first step runs on the masks of the shared uniform bootstrap (plan
    # reuse is held to the reference step by step, with a tolerance, in
    # test_torch_model.py)
    (16, "topk", 1, 1),
])
def test_engine_matches_reference(pair, wbits, method, interval, n_tokens):
    jm, tm, jp, tp, jb, tb = pair
    kw = dict(wbits=wbits, method=method, plan_refresh_interval=interval, backend="reference")
    jeng, jout = _serve(JEngine, jm, jp, jb, n_tokens, **kw)
    teng, tout = _serve(TEngine, tm, tp, tb, n_tokens, torch_device="cpu", **kw)
    np.testing.assert_array_equal(tout, jout)
    # the byte counts are compared where the masks are equal: check that
    for kind, entry in teng._plan.items():
        np.testing.assert_array_equal(entry["mask"].numpy(),
                                      np.asarray(jeng._plan[kind]["mask"]))
    _assert_summaries_match(teng.io_summary(), jeng.io_summary())
    assert set(teng.io_summary()) == set(IO_SUMMARY_KEYS)
    assert list(IO_SUMMARY_KEYS) == list(jeng.io_summary())  # the same keys, in order


@pytest.mark.parametrize("wbits", [16, 8])
@pytest.mark.parametrize("depth", [0, 2])
def test_backends_give_identical_tokens(pair, wbits, depth):
    """The kernel backend (K1/K2 plain versions walking the chunk tables)
    and the reference backend (the twin over every block) give
    byte-identical tokens and identical accounting on the CPU."""
    _, tm, _, tp, _, tb = pair
    outs = {}
    for backend in ("reference", "kernel"):
        eng, out = _serve(TEngine, tm, tp, tb, n_tokens=5, wbits=wbits, backend=backend,
                          prefetch_depth=depth, torch_device="cpu")
        outs[backend] = (out, eng.io_summary())
    np.testing.assert_array_equal(outs["kernel"][0], outs["reference"][0])
    _assert_summaries_match(outs["kernel"][1], outs["reference"][1])


def test_decode_continues_across_calls(pair):
    """The plan and the cache persist across decode calls: two calls of 3
    tokens give the tokens of one call of 6."""
    _, tm, _, tp, _, tb = pair
    _, one = _serve(TEngine, tm, tp, tb, n_tokens=6, torch_device="cpu")
    eng, first = _serve(TEngine, tm, tp, tb, n_tokens=3, torch_device="cpu")
    second = eng.decode(torch.from_numpy(first[:, -1:]), 3)
    np.testing.assert_array_equal(np.concatenate([first, second[:, 1:].numpy()], 1), one)
    assert eng.io_summary()["steps"] == 7


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_engine_runs_at_any_prefetch_depth(pair, backend):
    """Any depth >= 0 is accepted, as in the reference: depth 7 (deeper
    than the kernels' ring) gives depth 1's tokens and estimates; only the
    pipeline's charge moves."""
    _, tm, _, tp, _, tb = pair
    runs = {d: _serve(TEngine, tm, tp, tb, n_tokens=4, backend=backend, prefetch_depth=d,
                      torch_device="cpu") for d in (1, 7)}
    np.testing.assert_array_equal(runs[7][1], runs[1][1])
    s1, s7 = runs[1][0].io_summary(), runs[7][0].io_summary()
    assert s7["io_est_s"] == s1["io_est_s"] and s7["io_bytes"] == s1["io_bytes"]
    assert s7["decode_overlap_s"] <= s1["decode_overlap_s"] + 1e-12
    assert runs[7][0].sparse_ctx.backend.prefetch_depth == 7


def test_engine_rejects_bad_settings(pair):
    _, tm, _, tp, _, _ = pair
    for kw in (dict(wbits=4), dict(plan_refresh_interval=0), dict(backend="tpu"),
               dict(method="threshold"), dict(prefetch_depth=-1)):
        with pytest.raises(ValueError):
            TEngine(tm, tp, max_seq=64, batch_size=2, torch_device="cpu", **kw)


def test_cli_runs_on_cpu(capsys):
    eng, out = tserve.main(["--arch", "tinyllama-1.1b", "--reduced", "--torch-device", "cpu",
                            "--backend", "kernel", "--wbits", "8", "--decode-tokens", "3",
                            "--max-seq", "48", "--prompt-len", "8"])
    text = capsys.readouterr().out
    assert out.shape == (2, 4)
    assert "[total] method=chunk backend=kernel wbits=8" in text
    assert eng.io_summary()["io_bytes"] > 0


@pytest.mark.parametrize("flag", ["--mesh"])
def test_cli_refuses_unported_flags(flag, capsys):
    with pytest.raises(SystemExit):
        tserve.parse_args(["--reduced", flag, "2"])
    assert "ROADMAP.md" in capsys.readouterr().err


@pytest.fixture
def one_thread():
    """The CLI runs below at one intra-op thread (restored after): at these
    widths the CPU's thread pool costs ten times the arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU_STREAMS = ["--arch", "tinyllama-1.1b", "--reduced", "--torch-device", "cpu",
               "--decode-tokens", "3", "--max-seq", "32", "--prompt-len", "8"]


@pytest.mark.parametrize("argv,refused", [
    # the reference's checks (repro/launch/serve.py): paged KV is slot-mode only
    (["--kv-page-tokens", "16"], "requires --streams"),
    (["--streams", "3", "--round-tokens", "0"], "--round-tokens must be >= 1"),
    (["--streams", "3", "--kv-page-tokens", "0"], "--kv-page-tokens must be >= 1"),
    # --deadline-s is not validated (as in the reference): it runs
    (["--streams", "3", "--deadline-s", "1.0"], None),
], ids=["kv-page-tokens-needs-streams", "round-tokens-0", "kv-page-tokens-0", "deadline-s"])
def test_cli_validates_ported_flags(argv, refused, capsys, one_thread):
    if refused is not None:
        with pytest.raises(SystemExit):
            tserve.parse_args(["--reduced", *argv])
        assert refused in capsys.readouterr().err
        return
    eng, stats = tserve.main(CPU_STREAMS + argv)
    text = capsys.readouterr().out
    assert stats.finished == 3 and stats.deadlines == 3
    assert "[slo] deadline 1000.0 ms" in text and eng.kv_pool is None


def test_cli_streams_runs_paged_on_cpu(capsys, one_thread):
    """``--streams`` with paged KV: every request drains, the pool returns
    to its steady state, and the summary lines are printed."""
    eng, stats = tserve.main(CPU_STREAMS + ["--streams", "5", "--arrival-rate", "300",
                                            "--kv-page-tokens", "8", "--backend", "kernel"])
    text = capsys.readouterr().out
    assert stats.finished == 5 and stats.decode_tokens == 15
    assert "[serve] method=chunk backend=kernel slots=2" in text and "[paged-kv] page_tokens 8" in text
    assert eng.kv_pool.steady_state()
    eng.kv_pool.check()
