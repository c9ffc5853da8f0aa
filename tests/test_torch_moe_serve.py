"""The port's mixture-of-experts decoders against the JAX reference, on the
CPU at ``--reduced`` (2 layers, d_model 256, 4 experts, top-k ≤ 2,
capacity factor 8): OLMoE-1B-7B (top-2 of 4 here) and Llama-4-Scout-17B-16E
(top-1 + the shared expert, early-fusion frames through the projector).

The reference's params are carried over as numpy arrays; the JAX side runs
its ``reference`` backend. A MoE layer has only the attention sites, so
the planned decode goes through K1 (``project``) and K5 alone; the experts
run ``moe_ffn`` on both packages.

Tolerances (as ``tests/test_torch_model.py`` states them): carried-over
leaves, masks, block tables and tokens from shared inputs are equal
exactly; logits and cache rows come out of bf16 activations reduced in
another order, atol = rtol = 4e-2; per-layer I/O estimates are f32 sums in
another order, rtol 1e-5; the engines' latency summaries go through the
same simulator, rtol 1e-6. The reference's own prefill-then-decode test
(``tests/test_decode_consistency.py``) keeps its tolerances.

Routing is taken from bf16 router logits. Where two experts' logits lie a
few bf16 ulps apart, the frameworks' last bits can pick different experts
(reduced Scout's top-1 prefill has such a token: probabilities 0.0018
apart), and one token's other expert changes its row of logits wholesale.
So the tests that hold whole prompts and engines to the reference replay
the reference's expert choices in the port (``_Routes``: recorded from
inside the reference's scans by an ordered debug callback, as
``tests/test_torch_vlm.py`` records masks), and check that every choice
the port would have made differently lies within ``TIE_MARGIN`` of a tie.
Routing on shared inputs is held exactly in ``tests/test_torch_moe.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import InputShape as JShape
from repro.kernels.quantize import quantize_params as j_quantize_params
from repro.models import build_model as jbuild
from repro.models.inputs import make_dummy_batch as jbatch
from repro.models.transformer import SPARSE_WEIGHT_NAMES as J_SPARSE_NAMES
from repro.serving import ServeEngine as JEngine
from repro.serving.sparse_exec import SparseExecution as JSparse
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape as TShape
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.models.inputs import make_dummy_batch as tbatch
from repro_torch.models.transformer import site_matrix_names
from repro_torch.serving import IO_SUMMARY_KEYS
from repro_torch.serving import ServeEngine as TEngine
from repro_torch.serving.sparse_exec import SparseExecution as TSparse
from torch_threads import one_thread  # noqa: F401

BF16_TOL = dict(atol=4e-2, rtol=4e-2)
ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e")
MOE_LEAVES = ("router", "we_gate", "we_up", "we_down")
SHARED_LEAVES = ("ws_gate", "ws_up", "ws_down")
EXACT_KEYS = ("steps", "hit_rows", "miss_rows", "cache_hit_rate", "io_bytes")
WALL_KEYS = ("select_overhead_s",)
PROMPT, MAX_SEQ, FRAME_TOKENS = 12, 48, 8
# the largest router-probability gap, between the K-th and the next expert,
# at which the port may choose otherwise than the reference (a few bf16
# ulps of the logits)
TIE_MARGIN = 1e-2


@pytest.fixture(scope="module", params=ARCHS)
def moe(request):
    arch = request.param
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.key(0))
    layers = dict(jp["layers"])
    layers.update(j_quantize_params(layers, J_SPARSE_NAMES))
    jq = {**jp, "layers": layers}  # with the int8 leaves (wbits 8)
    tq = params_from_reference(jax.device_get(jq), tcfg, "cpu")
    tp = {**tq, "layers": {k: v for k, v in tq["layers"].items() if k in jp["layers"]}}
    jb = jbatch(jcfg, JShape("t", PROMPT, 2, "train"))
    tb = tbatch(tcfg, TShape("t", PROMPT, 2, "train"), device="cpu")
    jl, jcache = jm.prefill(jp, jb, MAX_SEQ)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jp=jp, jq=jq, tp=tp, tq=tq,
                jb=jb, tb=tb, jl=jl, jcache=jcache)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


class _Routes:
    """The reference's top-k expert ids of every ``moe_ffn`` call, in call
    order, recorded by an ordered debug callback (``record``: a patched
    ``jax.lax.top_k``), then replayed in the port's calls in the same order
    (``replay``: a patched ``repro_torch.models.moe.route``, weights
    renormalised from the port's own probabilities). ``near_ties`` keeps
    the top-K boundary gap of every token whose set of experts the port
    would have chosen otherwise."""

    def __init__(self, monkeypatch):
        self.log, self.near_ties, self.calls = [], [], 0
        top_k, route = jax.lax.top_k, tmoe.route

        def record(probs, k):
            w, e = top_k(probs, k)
            jax.debug.callback(lambda e_: self.log.append(np.array(e_)), e, ordered=True)
            return w, e

        def replay(xt, router, cfg):
            probs, _, own = route(xt, router, cfg)
            want = torch.from_numpy(self.log.pop(0)).to(torch.int64)
            assert want.shape == own.shape
            self.calls += 1
            differ = (torch.sort(want, 1).values != torch.sort(own, 1).values).any(1)
            if bool(differ.any()):
                top = torch.sort(probs, dim=-1, descending=True).values
                gap = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
                self.near_ties += gap[differ].tolist()
            w = probs.gather(1, want)
            return probs, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), want

        monkeypatch.setattr(jax.lax, "top_k", record)
        self._replay, self._mp = replay, monkeypatch

    def start_replay(self):
        assert self.log, "no reference routing was recorded"
        self._mp.setattr(tmoe, "route", self._replay)

    def check_done(self):
        assert not self.log and self.calls > 0
        assert all(g < TIE_MARGIN for g in self.near_ties), self.near_ties


def test_configs_registered_and_full_models_build():
    """Both configs carry the reference's numbers (full and reduced); the
    full-size models' param shapes and init scales are the reference's
    ``ParamDef``s (built without allocating), no MLP leaves beside the
    experts."""
    for arch in ARCHS:
        assert arch in ARCH_IDS
        t, j = tget(arch), jget(arch)
        for cfg_t, cfg_j in ((t, j), (t.reduced(), j.reduced())):
            for field in dataclasses.fields(cfg_t):
                if field.name != "citation":
                    assert getattr(cfg_t, field.name) == getattr(cfg_j, field.name), \
                        (arch, field.name)
        shapes = tbuild(t).param_shapes()
        defs = jbuild(j)._impl._defs()
        want = {k: v for k, v in defs.items() if k != "layers"}
        want.update({f"layers/{k}": v for k, v in defs["layers"].items()})
        assert set(shapes) == set(want)
        for name, d in want.items():
            shape, std, axes = shapes[name]
            assert shape == d.shape and axes == d.axes, name
            if d.init in ("ones", "zeros"):
                assert std == d.init, name
            else:
                scale = d.scale if d.scale is not None else 1.0 / np.sqrt(d.shape[-2])
                assert std == pytest.approx(scale), name
        assert "layers/w_gate" not in shapes and "layers/router" in shapes
        assert ("layers/ws_gate" in shapes) == t.moe_shared_expert
        assert ("projector" in shapes) == bool(t.d_frontend)


@pytest.mark.parametrize("arch_type,arch", [("ssm", "xlstm-125m"), ("hybrid", "zamba2-7b"),
                                            ("audio", "whisper-small")])
def test_other_families_still_raise(arch_type, arch):
    """The other families are found and build since their slice; what
    still raises for them is what a MoE decoder has and they do not: the
    paged cache and the frame append."""
    model = tbuild(tget(arch).reduced())
    assert model.family == arch_type and not model.supports_paged_kv
    with pytest.raises(NotImplementedError, match="paged KV"):
        model.init_paged_cache(2, 32, 8, 9, "cpu")
    with pytest.raises(NotImplementedError, match="append_frame"):
        model.append_embeds({}, torch.zeros((2, 4, 8)), {}, device="cpu")


def test_params_carried_over_exactly(moe):
    """The expert, router and shared-expert leaves (and the projector of
    Scout) arrive bit for bit; a leaf of the wrong shape is refused."""
    jq, tq, tcfg = moe["jq"], moe["tq"], moe["tcfg"]
    names = MOE_LEAVES + (SHARED_LEAVES if tcfg.moe_shared_expert else ())
    for name in names:
        np.testing.assert_array_equal(tq["layers"][name].float().numpy(),
                                      np.asarray(jq["layers"][name], np.float32), err_msg=name)
    for name, leaf in jq.items():
        if name != "layers":
            np.testing.assert_array_equal(tq[name].float().numpy(), np.asarray(leaf, np.float32))
    assert ("projector" in tq) == bool(tcfg.d_frontend)
    assert tq["layers"]["wq_q8"].dtype == torch.int8 and "we_gate_q8" not in tq["layers"]
    bad = dict(jax.device_get(moe["jp"]))
    bad["layers"] = dict(bad["layers"])
    bad["layers"]["we_down"] = bad["layers"]["we_down"][:, :1]
    with pytest.raises(ValueError, match="we_down"):
        params_from_reference(bad, tcfg, "cpu")


def test_prefill_then_decode_matches_forward(moe):
    """The reference's ``tests/test_decode_consistency.py`` case on the
    port (OLMoE there; Scout here too): prefill's last logits equal the
    forward's, and one decode step equals the forward over the prompt and
    that token, at the reference's tolerances."""
    tm, tp, tb = moe["tm"], moe["tp"], moe["tb"]
    last, cache = tm.prefill(tp, tb, 32)
    lg_fwd = tm.logits(tp, tm.forward(tp, tb)[0])[:, -1].float()
    np.testing.assert_allclose(last.float().numpy(), lg_fwd.numpy(), atol=2e-2, rtol=1e-2)
    nxt = tb["tokens"][:, :1]
    lg_dec, _ = tm.decode_step_planned(tp, nxt, cache)
    b2 = {**tb, "tokens": torch.cat([tb["tokens"], nxt], dim=1)}
    lg2 = tm.logits(tp, tm.forward(tp, b2)[0])[:, -1].float()
    np.testing.assert_allclose(lg_dec.numpy(), lg2.numpy(), atol=5e-2, rtol=2e-2)


def test_prefill_logits_and_cache_match_reference(moe, monkeypatch):
    """Prefill on the reference's routing (``_Routes``): the last logits and
    the cache."""
    routes = _Routes(monkeypatch)
    jl, jc = moe["jm"].prefill(moe["jp"], moe["jb"], MAX_SEQ)
    routes.start_replay()
    tl, tc = moe["tm"].prefill(moe["tp"], moe["tb"], MAX_SEQ)
    routes.check_done()
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32), **BF16_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].float().numpy(), np.asarray(jc[key], np.float32),
                                   **BF16_TOL)
    assert tc["length"] == int(jc["length"])


@pytest.mark.parametrize("wbits", [16, 8])
def test_teacher_forced_planned_decode(moe, wbits):
    """The reference's greedy tokens fed to both packages: every step's
    logits and per-layer I/O agree; the plan holds the attention sites
    alone, and the first refresh (the shared uniform bootstrap) selects
    identical masks and tables."""
    jcfg, tcfg, jm, tm = moe["jcfg"], moe["tcfg"], moe["jm"], moe["tm"]
    jp, tp = (moe["jq"], moe["tq"]) if wbits == 8 else (moe["jp"], moe["tp"])
    js = JSparse(jcfg, device="nano", sparsity=0.4, method="chunk", wbits=wbits)
    ts = TSparse(tcfg, device="nano", sparsity=0.4, method="chunk", wbits=wbits,
                 torch_device="cpu")
    assert ts.site_order == tuple(js.site_order) == ("hidden_attn", "attn_out")
    jl, jcache = moe["jl"], moe["jcache"]
    _, tcache = tm.prefill(tp, moe["tb"], MAX_SEQ)
    jplan, tplan = js.init_plan(jcfg.n_layers), ts.init_plan(tcfg.n_layers)
    step = jax.jit(lambda p, t, c, pl: jm.decode_step_planned(p, t, c, js, pl, jnp.bool_(True)))
    tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    for i in range(3):
        jlog, jcache, jio, jplan = step(jp, tok, jcache, jplan)
        tlog, tio = tm.decode_step_planned(tp, _t(tok), tcache, ts, tplan, refresh=True)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **BF16_TOL)
        np.testing.assert_allclose(tio.numpy(), np.asarray(jio), rtol=1e-5)
        if i == 0:
            for kind in ts.site_order:
                for key in ("mask", "kstarts", "ksizes"):
                    np.testing.assert_array_equal(tplan[kind][key].numpy(),
                                                  np.asarray(jplan[kind][key]))
        tok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
    assert tcache["length"] == int(jcache["length"])


def _serve(engine_cls, model, params, batch, n_tokens, frames=(), **kw):
    eng = engine_cls(model, params, max_seq=MAX_SEQ, batch_size=2, device="nano",
                     sparsity=0.4, seed=3, method="chunk", **kw)
    last = eng.prefill(batch)
    for f in frames:
        eng.append_frame(f if engine_cls is JEngine else _t(f))
    tok0 = (jnp.argmax(last, -1)[:, None].astype(jnp.int32) if engine_cls is JEngine
            else torch.argmax(last, dim=-1)[:, None])
    return eng, np.asarray(eng.decode(tok0, n_tokens))


def _frames(jcfg, n_frames):
    if not jcfg.d_frontend:
        return ()
    rng = np.random.default_rng(0)
    return [jnp.asarray(rng.normal(0, 1, (2, FRAME_TOKENS, jcfg.d_frontend)), jnp.bfloat16)
            for _ in range(n_frames)]


def test_engine_tokens_and_accounting_equal_reference(moe, monkeypatch):
    """Prefill (→ 2 frames on Scout) → one chunk decode step on the shared
    bootstrap's masks through both engines (reference backend; the port on
    the reference's routing, ``_Routes``): the tokens, each frame's
    estimated and simulated I/O, the plan's masks and the I/O summary are
    the reference engine's; ``sparsifiable_bytes`` and the site matrix
    counts too. Then the port's kernel backend (K1's plain version walking
    the tables) gives the twin's tokens over 4 steps, at wbits 16 and 8, on
    its own routing."""
    jm, tm, jp, tp, jcfg = moe["jm"], moe["tm"], moe["jp"], moe["tp"], moe["jcfg"]
    frames = _frames(jcfg, 2)
    kw = dict(wbits=16, backend="reference")
    with monkeypatch.context() as mp:
        routes = _Routes(mp)
        jeng, jout = _serve(JEngine, jm, jp, moe["jb"], 1, frames, **kw)
        routes.start_replay()
        teng, tout = _serve(TEngine, tm, tp, moe["tb"], 1, frames, torch_device="cpu", **kw)
        routes.check_done()
    np.testing.assert_array_equal(tout, jout)
    assert [s.kind for s in teng.stats] == [s.kind for s in jeng.stats]
    for ts_, js_ in zip(teng.stats, jeng.stats):
        assert ts_.tokens == js_.tokens
        np.testing.assert_allclose(ts_.io_est_s, js_.io_est_s, rtol=1e-6, err_msg=ts_.kind)
        np.testing.assert_allclose(ts_.io_sim_s, js_.io_sim_s, rtol=1e-6, err_msg=ts_.kind)
    assert sum(s.kind == "frame" for s in teng.stats) == len(frames)
    for kind, entry in teng._plan.items():
        np.testing.assert_array_equal(entry["mask"].numpy(), np.asarray(jeng._plan[kind]["mask"]))
    got, want = teng.io_summary(), jeng.io_summary()
    for key in IO_SUMMARY_KEYS:
        if key in EXACT_KEYS:
            assert got[key] == want[key], key
        elif key not in WALL_KEYS:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    ts, js = teng.sparse_ctx, jeng.sparse_ctx
    L = moe["tcfg"].n_layers
    np.testing.assert_allclose(ts.sparsifiable_bytes(L), js.sparsifiable_bytes(L), rtol=1e-5)
    for kind in ts.site_order:
        assert ts.site_matrix_count(kind) == js.site_matrix_count(kind) \
            == len(site_matrix_names(moe["tcfg"])[kind])
    for wbits, params in ((16, tp), (8, moe["tq"])):
        outs = {b: _serve(TEngine, tm, params, moe["tb"], 4, frames, torch_device="cpu",
                          wbits=wbits, backend=b)[1] for b in ("reference", "kernel")}
        np.testing.assert_array_equal(outs["kernel"], outs["reference"])


def test_scout_append_frame_matches_reference():
    """Scout's frame append through both models on the reference's
    prefilled cache, no sparse context: the hidden states and the
    extended cache agree; the frame's MoE capacity is over its own b·n
    tokens."""
    arch = "llama4-scout-17b-a16e"
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.key(1))
    tp = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    _, jcache = jm.prefill(jp, jbatch(jcfg, JShape("t", PROMPT, 2, "train")), MAX_SEQ)
    tcache = {"k": _t(jcache["k"]), "v": _t(jcache["v"]), "length": int(jcache["length"])}
    frame = _frames(jcfg, 1)[0]
    jh, jcache, jio = jm.append_frame(jp, frame, jcache)
    th, tio = tm.append_embeds(tp, _t(frame), tcache, device="cpu")
    np.testing.assert_allclose(th.float().numpy(), np.asarray(jh, np.float32), **BF16_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].float().numpy(),
                                   np.asarray(jcache[key], np.float32), **BF16_TOL)
    assert tcache["length"] == int(jcache["length"]) == PROMPT + FRAME_TOKENS
    assert float(tio) == float(jio) == 0.0


def test_slots_paged_equal_dense_and_reference():
    """Slot mode on reduced OLMoE: two prompts admitted into two slots,
    two ``decode_slots`` rounds; the paged cache's tokens equal the dense
    cache's and the reference engine's (the decode's MoE capacity is over
    the slot count)."""
    arch = "olmoe-1b-7b"
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.key(2))
    tp = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, (1, n)) for n in (12, 9)]
    kw = dict(max_seq=32, batch_size=2, device="nano", sparsity=0.4, method="chunk", seed=5,
              cache_mb=64.0)
    outs = {}
    for name, pages in (("dense", None), ("paged", 8)):
        eng = TEngine(tm, tp, kv_page_tokens=pages, torch_device="cpu", **kw)
        eng.enable_slots()
        lasts = [eng.admit_slot(s, {"tokens": torch.from_numpy(p)})[0]
                 for s, p in enumerate(prompts)]
        tok = torch.cat([torch.argmax(x, dim=-1)[:, None] for x in lasts])
        rounds = [tok.numpy()]
        for n in (3, 2):
            out, _ = eng.decode_slots(tok, n)
            rounds.append(out.numpy())
            tok = out[:, -1:]
        outs[name] = rounds
        if pages:
            eng.kv_pool.check()
    jeng = JEngine(jm, jp, kv_page_tokens=8, **kw)
    jeng.enable_slots()
    jl = [jeng.admit_slot(s, {"tokens": jnp.asarray(p, jnp.int32)})[0]
          for s, p in enumerate(prompts)]
    jtok = jnp.concatenate([jnp.argmax(x, -1)[:, None] for x in jl]).astype(jnp.int32)
    jrounds = [np.asarray(jtok)]
    for n in (3, 2):
        jout, _ = jeng.decode_slots(jtok, n)
        jrounds.append(np.asarray(jout))
        jtok = jout[:, -1:]
    for a, b, c in zip(outs["dense"], outs["paged"], jrounds):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("arch,extra", [
    ("olmoe-1b-7b", ["--backend", "kernel", "--wbits", "8"]),
    ("llama4-scout-17b-a16e", ["--frames", "2"]),
    ("olmoe-1b-7b", ["--streams", "3", "--arrival-rate", "300", "--kv-page-tokens", "8"]),
], ids=["olmoe-kernel-w8", "scout-frames", "olmoe-streams-paged"])
def test_cli_serves_moe_on_cpu(capsys, arch, extra):
    eng, out = tserve.main(["--arch", arch, "--reduced", "--torch-device", "cpu",
                            "--decode-tokens", "3", "--max-seq", "48", "--prompt-len", "8"]
                           + extra)
    text = capsys.readouterr().out
    assert "[total] method=chunk" in text or "[serve]" in text
    assert eng.io_summary()["io_bytes"] > 0
    assert "we_gate" in eng.params["layers"] and "we_gate_q8" not in eng.params["layers"]
    if "--frames" in extra:
        assert sum(s.kind == "frame" for s in eng.stats) == 2
    if "--wbits" in extra:
        assert "wq_q8" in eng.params["layers"]
