"""The other dense decoders of the port against the JAX reference, on the
CPU at ``--reduced``: StarCoder2 (LayerNorm with biases, the non-gated gelu
MLP with biases, K1 on both MLP matrices) and Granite-3 (the tied head).

The reference's params are carried over as numpy arrays; its LayerNorm
weights and every bias are drawn at random first (its init makes them ones
and zeros, which would hide a missing or misplaced term). The JAX side runs
its ``reference`` backend, whose tokens its own suite holds equal to its
kernel backend's.

Tolerances (as ``tests/test_torch_model.py`` states them): carried-over
leaves, masks and tables from shared inputs are equal exactly; logits come
out of bf16 activations reduced in another order, atol = rtol = 4e-2; I/O
estimates are f32 sums in another order, rtol 1e-5; the engines' latency
summaries go through the same simulator, rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import InputShape as JShape
from repro.kernels.backend import ExecutionBackend as JBackend
from repro.kernels.quantize import quantize_params as j_quantize_params
from repro.models import build_model as jbuild
from repro.models.common import layer_norm as j_layer_norm
from repro.models.inputs import make_dummy_batch as jbatch
from repro.models.mlp import gelu_mlp_planned as j_gelu_mlp_planned
from repro.models.transformer import SPARSE_WEIGHT_NAMES as J_SPARSE_NAMES
from repro.serving import ServeEngine as JEngine
from repro.serving.sparse_exec import SparseExecution as JSparse
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape as TShape
from repro_torch.kernels.backend import ExecutionBackend as TBackend
from repro_torch.kernels.chunk_gather_dma import masks_to_block_tables
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.models.common import gelu as t_gelu
from repro_torch.models.common import layer_norm as t_layer_norm
from repro_torch.models.inputs import make_dummy_batch as tbatch
from repro_torch.models.mlp import gelu_mlp_planned as t_gelu_mlp_planned
from repro_torch.models.transformer import SPARSE_WEIGHT_NAMES, site_matrix_names
from repro_torch.serving import IO_SUMMARY_KEYS
from repro_torch.serving import ServeEngine as TEngine
from repro_torch.serving.sparse_exec import SparseExecution as TSparse
from test_torch_integrity import COUNTER_KEYS, RefDraws

BF16_TOL = dict(atol=4e-2, rtol=4e-2)
ARCHS = ("starcoder2-3b", "granite-3-2b")
EXACT_KEYS = ("steps", "hit_rows", "miss_rows", "cache_hit_rate", "io_bytes")
WALL_KEYS = ("select_overhead_s",)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (restored after): at the reduced widths the
    CPU's thread pool costs more than the arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomized(jp, seed):
    """The reference's params with every norm weight and bias drawn at
    random (bf16, as stored)."""
    rng = np.random.default_rng(seed)

    def draw(name, leaf):
        if name.endswith("_b") or name in ("b_fc", "b_proj") or "norm" in name \
                or name.startswith("ln"):
            base = 1.0 if name.endswith("_w") else 0.0
            return jnp.asarray(base + 0.1 * rng.normal(size=leaf.shape), jnp.bfloat16)
        return leaf

    out = {k: draw(k, v) for k, v in jp.items() if k != "layers"}
    out["layers"] = {k: draw(k, v) for k, v in jp["layers"].items()}
    return out


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    arch = request.param
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = _randomized(jm.init(jax.random.key(0)), 1)
    layers = dict(jp["layers"])
    layers.update(j_quantize_params(layers, J_SPARSE_NAMES))
    jq = {**jp, "layers": layers}  # with the int8 leaves (wbits 8)
    tq = params_from_reference(jax.device_get(jq), tcfg, "cpu")
    tp = {**tq, "layers": {k: v for k, v in tq["layers"].items() if k in jp["layers"]}}
    jb = jbatch(jcfg, JShape("t", 12, 2, "train"))
    tb = tbatch(tcfg, TShape("t", 12, 2, "train"), device="cpu")
    # the reference's prefill, once (its arrays are immutable; the int8
    # leaves serve the planned decode only, so wbits 8 prefills the same)
    jl, jcache = jm.prefill(jp, jb, 32)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jp=jp, jq=jq, tp=tp, tq=tq,
                jb=jb, tb=tb, jl=jl, jcache=jcache)


def test_configs_registered_and_full_models_build():
    """The three configs carry the reference's numbers; their full-size
    models build (param shapes only), and the families not yet served
    still refuse."""
    import dataclasses

    for arch in ARCHS + ("starcoder2-7b",):
        assert arch in ARCH_IDS
        t, j = tget(arch), jget(arch)
        for field in dataclasses.fields(t):
            if field.name != "citation":
                assert getattr(t, field.name) == getattr(j, field.name), (arch, field.name)
        assert t.reduced().sliding_window == j.reduced().sliding_window == t.sliding_window
        shapes = tbuild(t).param_shapes()
        assert ("head" in shapes) != t.tie_embeddings
        assert ("layers/w_fc" in shapes) == (t.mlp == "gelu") != ("layers/w_gate" in shapes)
        assert ("final_norm_b" in shapes) == (t.norm == "layernorm")
    with pytest.raises(NotImplementedError):
        tbuild(dataclasses.replace(tget("starcoder2-3b"), arch_type="ssm"))


def test_params_carried_over_exactly(fam):
    jq, tq, tcfg = fam["jq"], fam["tq"], fam["tcfg"]
    for name, leaf in jq.items():
        if name == "layers":
            continue
        np.testing.assert_array_equal(tq[name].float().numpy(), np.asarray(leaf, np.float32))
    for name, leaf in jq["layers"].items():
        np.testing.assert_array_equal(tq["layers"][name].float().numpy(),
                                      np.asarray(leaf, np.float32), err_msg=name)
    if tcfg.mlp == "gelu":
        assert tq["layers"]["w_fc_q8"].dtype == torch.int8
        assert float(tq["layers"]["b_fc"].float().abs().sum()) > 0
    assert ("head" in tq) != tcfg.tie_embeddings
    bad = dict(jax.device_get(fam["jp"]))
    bad["layers"] = dict(bad["layers"])
    name = "w_fc" if tcfg.mlp == "gelu" else "w_down"
    bad["layers"][name] = bad["layers"][name][:, :8]
    with pytest.raises(ValueError, match=name):
        params_from_reference(bad, tcfg, "cpu")


def test_layer_norm_and_gelu_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (3, 5, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, 64).astype(np.float32)
    b = rng.normal(0, 0.1, 64).astype(np.float32)
    for jd, td, tol in ((jnp.float32, torch.float32, dict(atol=1e-5, rtol=1e-5)),
                        (jnp.bfloat16, torch.bfloat16, BF16_TOL)):
        want = j_layer_norm(jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b, jd))
        got = t_layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                           torch.from_numpy(b).to(td))
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    # the tanh approximation (jax.nn.gelu's default), not the erf form
    xg = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(xg)))
    np.testing.assert_allclose(t_gelu(torch.from_numpy(xg)).numpy(), want, atol=2e-6, rtol=1e-5)
    erf = torch.nn.functional.gelu(torch.from_numpy(xg)).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("wbits", [16, 8])
def test_gelu_mlp_planned_backends_bitwise(wbits):
    """The gelu MLP's two projections on the port's two backends (the
    twin, and K1's plain version walking the tables) give equal bits, y
    and mid, at every depth; and the reference's within bf16 tolerance."""
    rng = np.random.default_rng(wbits)
    b, d, f = 2, 64, 256
    names = ("w_fc", "w_proj")
    jw = {"w_fc": jnp.asarray(rng.normal(0, d ** -0.5, (1, d, f)), jnp.bfloat16),
          "w_proj": jnp.asarray(rng.normal(0, f ** -0.5, (1, f, d)), jnp.bfloat16),
          "b_fc": jnp.asarray(rng.normal(0, 0.1, f), jnp.bfloat16),
          "b_proj": jnp.asarray(rng.normal(0, 0.1, d), jnp.bfloat16)}
    if wbits == 8:
        jw.update(j_quantize_params(jw, names))
    jw = {k: v[0] if k.startswith(names) else v for k, v in jw.items()}
    tw = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
          if v.dtype == jnp.bfloat16 else torch.from_numpy(np.array(v)) for k, v in jw.items()}
    x = rng.normal(0, 1, (b, 1, d)).astype(np.float32)
    hm = (rng.random(d) < 0.6).astype(np.float32)
    fm = (rng.random(f) < 0.5).astype(np.float32)
    tabs = [tuple(t[0] for t in masks_to_block_tables(torch.from_numpy(m)[None] > 0, 8, 512))
            for m in (hm, fm)]
    tx = torch.from_numpy(x).to(torch.bfloat16)
    args = (torch.from_numpy(hm), torch.from_numpy(fm), tabs[0], tabs[1])
    ref_y, ref_mid = t_gelu_mlp_planned(tx, tw, TBackend.create("reference"), *args,
                                        quantized=wbits == 8)
    for depth in (0, 1, 3):
        y, mid = t_gelu_mlp_planned(tx, tw, TBackend.create("kernel", prefetch_depth=depth),
                                    *args, quantized=wbits == 8)
        assert torch.equal(y, ref_y) and torch.equal(mid, ref_mid)
    jy, jmid = j_gelu_mlp_planned(
        jnp.asarray(x, jnp.bfloat16), jw, JBackend.create("reference"), jnp.asarray(hm),
        jnp.asarray(fm), tuple(jnp.asarray(t.numpy()) for t in tabs[0]),
        tuple(jnp.asarray(t.numpy()) for t in tabs[1]), quantized=wbits == 8)
    np.testing.assert_allclose(ref_mid.numpy(), np.asarray(jmid), **BF16_TOL)
    np.testing.assert_allclose(ref_y.float().numpy(), np.asarray(jy, np.float32), **BF16_TOL)


def test_prefill_logits(fam):
    jl, jc = fam["jl"], fam["jcache"]
    tl, tc = fam["tm"].prefill(fam["tp"], fam["tb"], 32)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32), **BF16_TOL)
    np.testing.assert_allclose(tc["k"].float().numpy(), np.asarray(jc["k"], np.float32),
                               **BF16_TOL)
    assert tc["length"] == int(jc["length"])


@pytest.mark.parametrize("wbits", [16, 8])
def test_teacher_forced_planned_decode(fam, wbits):
    """The reference's greedy tokens fed to both packages: every step's
    logits and per-layer I/O agree, and the first refresh (the shared
    uniform bootstrap) selects identical masks and tables."""
    jcfg, tcfg, jm, tm = fam["jcfg"], fam["tcfg"], fam["jm"], fam["tm"]
    jp, tp = (fam["jq"], fam["tq"]) if wbits == 8 else (fam["jp"], fam["tp"])
    js = JSparse(jcfg, device="nano", sparsity=0.4, method="chunk", wbits=wbits)
    ts = TSparse(tcfg, device="nano", sparsity=0.4, method="chunk", wbits=wbits,
                 torch_device="cpu")
    jl, jcache = fam["jl"], fam["jcache"]
    _, tcache = tm.prefill(tp, fam["tb"], 32)
    jplan, tplan = js.init_plan(jcfg.n_layers), ts.init_plan(tcfg.n_layers)
    step = jax.jit(lambda p, t, c, pl: jm.decode_step_planned(p, t, c, js, pl, jnp.bool_(True)))
    tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    for i in range(3):
        jlog, jcache, jio, jplan = step(jp, tok, jcache, jplan)
        tlog, tio = tm.decode_step_planned(tp, torch.from_numpy(np.array(tok)), tcache, ts,
                                           tplan, refresh=True)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **BF16_TOL)
        np.testing.assert_allclose(tio.numpy(), np.asarray(jio), rtol=1e-5)
        if i == 0:
            for kind in ts.site_order:
                for key in ("mask", "kstarts", "ksizes"):
                    np.testing.assert_array_equal(tplan[kind][key].numpy(),
                                                  np.asarray(jplan[kind][key]))
        tok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
    assert tcache["length"] == int(jcache["length"])


def test_dense_unplanned_decode(fam):
    """Without a sparse context the block runs dense; a ``dense`` sparse
    context with no plan computes the same logits and charges every
    layer's full load, as the reference does."""
    jcfg, tcfg, jm, tm, jp, tp = (fam[k] for k in ("jcfg", "tcfg", "jm", "tm", "jp", "tp"))
    jl, jcache = fam["jl"], fam["jcache"]
    _, tcache = tm.prefill(tp, fam["tb"], 32)
    tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    tlog, tio = tm.decode_step_planned(tp, torch.from_numpy(np.array(tok)), tcache)
    assert float(tio.abs().sum()) == 0.0
    _, tcache = tm.prefill(tp, fam["tb"], 32)
    # the reference's dense method masks nothing, so its logits are its
    # dense decode's
    jlog, _, jio, _ = jm.decode_step_planned(jp, tok, jcache, JSparse(jcfg, method="dense"),
                                             plan={}, refresh=True)
    tdlog, tdio = tm.decode_step_planned(tp, torch.from_numpy(np.array(tok)), tcache,
                                         TSparse(tcfg, method="dense", torch_device="cpu"))
    np.testing.assert_array_equal(tdlog.numpy(), tlog.numpy())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **BF16_TOL)
    np.testing.assert_allclose(tdio.numpy(), np.asarray(jio), rtol=1e-5)


def _serve(engine_cls, model, params, batch, n_tokens, **kw):
    eng = engine_cls(model, params, max_seq=48, batch_size=2, device="nano", sparsity=0.4,
                     seed=3, method="chunk", **kw)
    last = eng.prefill(batch)
    tok0 = (jnp.argmax(last, -1)[:, None].astype(jnp.int32) if engine_cls is JEngine
            else torch.argmax(last, dim=-1)[:, None])
    return eng, np.asarray(eng.decode(tok0, n_tokens))


def test_engine_tokens_and_accounting_equal_reference(fam):
    """One decode step on the shared bootstrap's masks: the tokens, the
    plan's masks and the I/O summary equal the reference engine's; the
    port's kernel backend (K1/K2's plain versions) gives the twin's tokens
    over more steps, at wbits 16 and 8. ``sparsifiable_bytes`` and the site
    matrix counts equal the reference's (the gelu hidden_mlp site: one
    matrix streamed, two lanes priced)."""
    jm, tm, jp, tp = fam["jm"], fam["tm"], fam["jp"], fam["tp"]
    kw = dict(wbits=16, backend="reference")
    jeng, jout = _serve(JEngine, jm, jp, fam["jb"], 1, **kw)
    teng, tout = _serve(TEngine, tm, tp, fam["tb"], 1, torch_device="cpu", **kw)
    np.testing.assert_array_equal(tout, jout)
    for kind, entry in teng._plan.items():
        np.testing.assert_array_equal(entry["mask"].numpy(), np.asarray(jeng._plan[kind]["mask"]))
    got, want = teng.io_summary(), jeng.io_summary()
    for key in IO_SUMMARY_KEYS:
        if key in EXACT_KEYS:
            assert got[key] == want[key], key
        elif key not in WALL_KEYS:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    ts, js = teng.sparse_ctx, jeng.sparse_ctx
    L = fam["tcfg"].n_layers
    np.testing.assert_allclose(ts.sparsifiable_bytes(L), js.sparsifiable_bytes(L), rtol=1e-5)
    for kind in ts.site_order:
        assert ts.site_matrix_count(kind) == js.site_matrix_count(kind) \
            == len(site_matrix_names(fam["tcfg"])[kind])
    if fam["tcfg"].mlp == "gelu":
        assert ts.site_matrix_count("hidden_mlp") == 1 and len(ts.sites["hidden_mlp"].tables) == 2
    for wbits, params in ((16, tp), (8, fam["tq"])):
        outs = {b: _serve(TEngine, tm, params, fam["tb"], 4, torch_device="cpu", wbits=wbits,
                          backend=b)[1] for b in ("reference", "kernel")}
        np.testing.assert_array_equal(outs["kernel"], outs["reference"])
    assert set(SPARSE_WEIGHT_NAMES) == set(J_SPARSE_NAMES)


def test_cli_starcoder2_on_cpu(capsys):
    eng, out = tserve.main(["--arch", "starcoder2-3b", "--reduced", "--torch-device", "cpu",
                            "--backend", "kernel", "--wbits", "8", "--decode-tokens", "3",
                            "--max-seq", "48", "--prompt-len", "8"])
    text = capsys.readouterr().out
    assert out.shape == (2, 4)
    assert "[total] method=chunk backend=kernel wbits=8" in text
    assert "w_fc_q8" in eng.params["layers"] and eng.io_summary()["io_bytes"] > 0


# ---------------------------------------------------------------------------
# the integrity ladder where the gelu family's hidden_mlp streams one matrix
# ---------------------------------------------------------------------------


def _gelu_widths(cfg, wbits):
    item = 1 if wbits == 8 else 2
    d, hd, kv, f = (cfg.d_model, cfg.n_heads * cfg.resolved_head_dim,
                    cfg.n_kv_heads * cfg.resolved_head_dim, cfg.d_ff)
    return {(0, 0): (d // 8, hd, item), (0, 1): (d // 8, kv, item), (0, 2): (d // 8, kv, item),
            (1, 0): (hd // 8, d, item), (2, 0): (d // 8, f, item), (3, 0): (f // 8, d, item)}


@pytest.fixture(scope="module")
def starcoder():
    jcfg, tcfg = jget("starcoder2-3b").reduced(), tget("starcoder2-3b").reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = _randomized(jm.init(jax.random.key(2)), 5)
    return jcfg, tcfg, jm, tm, jp, params_from_reference(jax.device_get(jp), tcfg, "cpu")


def _engine(cls, model, params, **kw):
    if cls is TEngine:
        kw.setdefault("torch_device", "cpu")
    return cls(model, params, max_seq=48, batch_size=2, device="nano", sparsity=0.4, seed=1,
               method="chunk", backend="reference", wbits=16, **kw)


def _tok0(cls):
    return (jnp.ones((2, 1), jnp.int32) if cls is JEngine
            else torch.ones((2, 1), dtype=torch.int64))


def _counters(eng):
    s = eng.io_summary()
    return {k: s[k] for k in COUNTER_KEYS}


@pytest.mark.parametrize("recover", [True, False])
def test_engine_integrity_ladder_equals_reference(starcoder, recover):
    """StarCoder2's ladder, fed the reference's draws, step by step on the
    reference's recorded importances: the tokens, the plan's drawn blocks
    and the integrity counters equal the reference engine's, recovery on
    (degraded_nand: re-reads, substitutes, drops) and off (bit_rot: the
    damage reaches w_fc and w_proj)."""
    jcfg, tcfg, jm, tm, jp, tp = starcoder
    profile, seed = ("degraded_nand", 3) if recover else ("bit_rot", 7)
    kw = dict(corruption_profile=profile, corruption_seed=seed, recover=recover,
              max_reread=1)
    jeng, teng = _engine(JEngine, jm, jp, **kw), _engine(TEngine, tm, tp, **kw)
    teng.sparse_ctx.corruption = teng.corruption = RefDraws(
        profile, seed, max_reread=1, recover=recover, widths=_gelu_widths(tcfg, 16))
    jt, tt = _tok0(JEngine), _tok0(TEngine)
    mlp_blocks = 0
    for step in range(3):
        if step:
            for kind, entry in teng._plan.items():
                entry["pending"].copy_(torch.from_numpy(np.array(jeng._plan[kind]["pending"])))
        jt = jnp.asarray(np.asarray(jeng.decode_per_token(jt, 1))[:, -1:])
        tt = teng.decode_per_token(tt, 1)[:, -1:]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=f"step {step}")
        for kind, entry in teng._plan.items():
            for key in ("cdet", "crec", "csub", "cdrop", "crr") + (("cblk",) if not recover
                                                                  else ()):
                np.testing.assert_array_equal(entry[key].numpy(),
                                              np.asarray(jeng._plan[kind][key]),
                                              err_msg=f"{kind} {key} step {step}")
        mlp_blocks += sum(int(teng._plan[k]["cdet"].sum()) for k in ("hidden_mlp", "ffn"))
        if not recover:
            assert teng._plan["hidden_mlp"]["cblk"].shape[1] == 1  # w_fc alone
    assert mlp_blocks > 0
    tc, jc = _counters(teng), _counters(jeng)
    assert tc["corruptions_detected"] == jc["corruptions_detected"] > 0
    np.testing.assert_allclose(tc.pop("integrity_reread_s"), jc.pop("integrity_reread_s"),
                               rtol=1e-6)
    assert tc == jc
    if recover:
        assert tc["corruptions_substituted"] + tc["corruptions_dropped"] > 0
    else:
        # the damage went into the gathers and came out again
        assert all(torch.equal(tp["layers"][n], teng.params["layers"][n])
                   for n in ("w_fc", "w_proj"))
