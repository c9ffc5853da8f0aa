"""Parity of the port's VLM path with the JAX reference, on the CPU at
``internvl2-76b --reduced`` (2 layers, d_model 256, d_ff 896, d_frontend 64)
and on carried-over parameters: early-fusion prefill, frame append
(``append_attention``, ``block_append``, ``stack_append``,
``append_embeds``), the unplanned ``SparseExecution.mask`` path, the
``dense`` / ``dense_free`` methods, the engine's prefill → frames → decode,
and the CLIs.

Tolerances: prompt arrays, carried-over weights, masks and the first
decode token are equal exactly. Hidden states, logits and cache rows come
out of bf16 activations that both packages round at the same places but
reduce in other orders: atol = rtol = 4e-2, a few bf16 ulps, as in
``test_torch_model.py``. Latency estimates are f32 sums of the same terms
(rtol 1e-6); the engine's simulated times go through the same numpy
simulator (rtol 1e-6). Where a site's mask is selected from bf16
activations, the block tests feed the reference's masks to the port (a
recorded replay), so that both compute on the same masks; the masks
themselves are held equal by ``test_sparse_exec_mask_equals_reference``,
which gives both packages the same (dyadic) activations.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import InputShape as JShape
from repro.core import ChunkConfig as JChunkConfig
from repro.core import ChunkSelector as JSelector
from repro.core import baselines as jbase
from repro.core import retention as jretention
from repro.models import build_model as jbuild
from repro.models.attention import append_attention as j_append_attention
from repro.models.inputs import make_dummy_batch as jbatch
from repro.models.transformer import block_append as j_block_append
from repro.models.transformer import stack_append as j_stack_append
from repro.serving import ServeEngine as JEngine
from repro.serving.sparse_exec import SparseExecution as JSparse
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape as TShape
from repro_torch.core import baselines as tbase
from repro_torch.launch import compare_baselines as tcompare
from repro_torch.launch import serve as tserve
from repro_torch.launch import video_stream as tvideo
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.models.attention import append_attention as t_append_attention
from repro_torch.models.inputs import make_dummy_batch as tbatch
from repro_torch.models.transformer import block_append as t_block_append
from repro_torch.models.transformer import layer_slice
from repro_torch.models.transformer import stack_append as t_stack_append
from repro_torch.serving import ServeEngine as TEngine
from repro_torch.serving.sparse_exec import SparseExecution as TSparse

BF16_TOL = dict(atol=4e-2, rtol=4e-2)
PROMPT, MAX_SEQ, FRAME_TOKENS = 32, 64, 8


def _t(a, dtype=None):
    """A reference array as a torch CPU tensor (bf16 through f32, exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def pair():
    jcfg = jget("internvl2-76b").reduced()
    tcfg = tget("internvl2-76b").reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    jb = jbatch(jcfg, JShape("t", PROMPT, 2, "train"))
    tb = tbatch(tcfg, TShape("t", PROMPT, 2, "train"), device="cpu")
    return jcfg, tcfg, jm, tm, jp, tp, jb, tb


@pytest.fixture(scope="module")
def prefilled(pair):
    """The reference's cache after the prompt, and a frame (b, n, d) of
    bf16 normals, for the block-level tests."""
    jcfg, tcfg, jm, tm, jp, tp, jb, tb = pair
    _, jcache = jm.prefill(jp, jb, MAX_SEQ)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(0, 1, (2, FRAME_TOKENS, jcfg.d_model)), jnp.bfloat16)
    return jcache, x


def _port_cache(jcache):
    return {"k": _t(jcache["k"]), "v": _t(jcache["v"]), "length": int(jcache["length"])}


class _Recorder:
    """A reference sparse context that logs every site's (kind, mask, lat),
    in order, also from inside the reference's layer scan (an ordered
    debug callback runs once per layer with the values)."""

    def __init__(self, inner):
        self.inner, self.log = inner, []

    def _append(self, kind, m, lat):
        self.log.append((kind, None if m is None else np.array(m), float(lat)))

    def mask(self, kind, acts):
        m, lat = self.inner.mask(kind, acts)
        jax.debug.callback(functools.partial(self._append, kind), m, lat, ordered=True)
        return m, lat


class _Replay:
    """A port sparse context that answers each site with the reference's
    recorded mask and latency, in order."""

    def __init__(self, log):
        self.log = list(log)

    def mask(self, kind, acts):
        want, m, lat = self.log.pop(0)
        assert kind == want
        return (None if m is None else torch.from_numpy(m)), torch.tensor(lat, dtype=torch.float32)


@pytest.mark.parametrize("arch,seq,seed", [("internvl2-76b", 32, 0), ("internvl2-76b", 9, 3),
                                          ("tinyllama-1.1b", 16, 1)])
def test_make_dummy_batch_equals_reference(arch, seq, seed):
    jb = jbatch(jget(arch).reduced(), JShape("t", seq, 2, "train"), seed=seed)
    tb = tbatch(tget(arch).reduced(), TShape("t", seq, 2, "train"), seed=seed, device="cpu")
    assert set(tb) == set(jb)
    np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
    if "frontend" in jb:
        assert tb["frontend"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(tb["frontend"]), _jnp(jb["frontend"]))


def test_params_from_reference_carries_the_projector(pair):
    jcfg, tcfg, jm, tm, jp, tp, *_ = pair
    np.testing.assert_array_equal(_np(tp["projector"]), _jnp(jp["projector"]))
    assert tuple(tp["projector"].shape) == (tcfg.d_frontend, tcfg.d_model)
    assert tuple(tm.param_shapes()["projector"][0]) == tuple(jp["projector"].shape)
    bad = dict(jax.device_get(jp))
    bad["projector"] = np.zeros((3, tcfg.d_model), np.float32)
    with pytest.raises(ValueError, match="projector"):
        params_from_reference(bad, tcfg, "cpu")
    del bad["projector"]
    with pytest.raises(ValueError, match="projector"):
        params_from_reference(bad, tcfg, "cpu")


def test_prefill_with_frontend_matches_reference(pair):
    jcfg, tcfg, jm, tm, jp, tp, jb, tb = pair
    jl, jcache = jm.prefill(jp, jb, MAX_SEQ)
    tl, tcache = tm.prefill(tp, tb, MAX_SEQ)
    np.testing.assert_allclose(_np(tl), _jnp(jl), **BF16_TOL)
    assert tcache["length"] == int(jcache["length"]) == PROMPT
    np.testing.assert_allclose(_np(tcache["k"]), _jnp(jcache["k"]), **BF16_TOL)
    assert tm.text_offset == jm.text_offset == tcfg.frontend_tokens
    jh, _ = jm.forward(jp, jb, remat=False)
    np.testing.assert_allclose(_np(tm.forward(tp, tb)), _jnp(jh), **BF16_TOL)


@pytest.mark.parametrize("project_out", [True, False])
def test_append_attention_matches_reference(pair, prefilled, project_out):
    jcfg, tcfg, jm, tm, jp, tp, *_ = pair
    jcache, x = prefilled
    length = int(jcache["length"])
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    jout, jk, jv = j_append_attention(x, jl, jcache["k"][0], jcache["v"][0], jnp.int32(length),
                                      jcfg.n_heads, jcfg.n_kv_heads, jcfg.resolved_head_dim,
                                      jcfg.rope_theta, project_out=project_out)
    tk, tv = _t(jcache["k"][0]), _t(jcache["v"][0])
    tout = t_append_attention(_t(x), layer_slice(tp["layers"], 0), tk, tv, length,
                              tcfg.n_heads, tcfg.n_kv_heads, tcfg.resolved_head_dim,
                              tcfg.rope_theta, project_out=project_out)
    np.testing.assert_allclose(_np(tout), _jnp(jout), **BF16_TOL)
    new = slice(length, length + FRAME_TOKENS)
    np.testing.assert_allclose(_np(tk[:, new]), _jnp(jk[:, new]), **BF16_TOL)
    np.testing.assert_allclose(_np(tv[:, new]), _jnp(jv[:, new]), **BF16_TOL)
    # every other slot is left as it was
    keep = np.ones(MAX_SEQ, bool)
    keep[new] = False
    np.testing.assert_array_equal(_np(tk[:, keep]), _jnp(jcache["k"][0][:, keep]))


@pytest.mark.parametrize("method", ["none", "dense", "chunk", "topk"])
def test_block_append_matches_reference(pair, prefilled, method):
    """One layer's frame append: hidden state, the new cache rows and the
    I/O estimate; chunk/topk on the reference's masks (replayed)."""
    jcfg, tcfg, jm, tm, jp, tp, *_ = pair
    jcache, x = prefilled
    length = int(jcache["length"])
    jctx = None if method == "none" else _Recorder(JSparse(jcfg, method=method))
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    jx, jk, jv, jio = j_block_append(jl, x, jcache["k"][0], jcache["v"][0], jnp.int32(length),
                                     jcfg, jctx)
    tctx = None if jctx is None else _Replay(jctx.log)
    tk, tv = _t(jcache["k"][0]), _t(jcache["v"][0])
    tx, tio = t_block_append(layer_slice(tp["layers"], 0), _t(x), tk, tv, length, tcfg, tctx)
    np.testing.assert_allclose(_np(tx), _jnp(jx), **BF16_TOL)
    new = slice(length, length + FRAME_TOKENS)
    np.testing.assert_allclose(_np(tk[:, new]), _jnp(jk[:, new]), **BF16_TOL)
    np.testing.assert_allclose(_np(tv[:, new]), _jnp(jv[:, new]), **BF16_TOL)
    np.testing.assert_allclose(float(tio), float(jio), rtol=1e-6)
    if jctx is not None:
        assert not tctx.log and [k for k, *_ in jctx.log] == \
            ["hidden_attn", "attn_out", "hidden_mlp", "ffn"]
        assert (float(jio) > 0.0) == (method != "none")


@pytest.mark.parametrize("method", ["none", "dense", "chunk", "topk"])
def test_stack_append_and_append_embeds_match_reference(pair, prefilled, method):
    """Every layer's frame append, from the raw embeddings (``stack_append``)
    and from a frame of patch embeddings through the projector
    (``append_embeds``): hidden state, cache rows, length and I/O."""
    jcfg, tcfg, jm, tm, jp, tp, *_ = pair
    jcache, x = prefilled
    length = int(jcache["length"])
    rng = np.random.default_rng(9)
    frame = jnp.asarray(rng.normal(0, 1, (2, FRAME_TOKENS, jcfg.d_frontend)), jnp.bfloat16)
    new = slice(length, length + FRAME_TOKENS)
    runs = (
        ("stack_append", x,
         lambda ctx: j_stack_append(jp["layers"], x, jcache, jcfg, ctx),
         lambda ctx, cache: t_stack_append(tp["layers"], _t(x), cache, tcfg, ctx)),
        ("append_embeds", frame,
         lambda ctx: jm.append_frame(jp, frame, jcache, ctx),
         lambda ctx, cache: tm.append_embeds(tp, _t(frame), cache, ctx, device="cpu")),
    )
    for name, _, jrun, trun in runs:
        jctx = None if method == "none" else _Recorder(JSparse(jcfg, method=method))
        jx, jc, jio = jrun(jctx)
        jax.effects_barrier()
        tcache = _port_cache(jcache)
        tx, tio = trun(None if jctx is None else _Replay(jctx.log), tcache)
        np.testing.assert_allclose(_np(tx), _jnp(jx), **BF16_TOL, err_msg=name)
        assert tcache["length"] == int(jc["length"]) == length + FRAME_TOKENS
        np.testing.assert_allclose(_np(tcache["k"][:, :, new]), _jnp(jc["k"][:, :, new]),
                                   **BF16_TOL, err_msg=name)
        np.testing.assert_allclose(_np(tcache["v"][:, :, new]), _jnp(jc["v"][:, :, new]),
                                   **BF16_TOL, err_msg=name)
        np.testing.assert_allclose(float(tio), float(jio), rtol=1e-6, err_msg=name)
        if jctx is not None:
            assert len(jctx.log) == 4 * jcfg.n_layers


def _dyadic(rng, shape):
    """Activations whose |·| means are exact in f32 in any order."""
    return (rng.integers(-64, 65, shape) / 64.0).astype(np.float32)


@pytest.mark.parametrize("method", ["chunk", "topk", "dense"])
@pytest.mark.parametrize("wbits", [16, 8])
def test_sparse_exec_mask_equals_reference(pair, method, wbits):
    """``SparseExecution.mask`` on the same (b, n, N) activations: the mask
    exactly, the latency on every table of the site to 1e-6."""
    jcfg, tcfg, *_ = pair
    js = JSparse(jcfg, method=method, wbits=wbits)
    ts = TSparse(tcfg, method=method, wbits=wbits, torch_device="cpu")
    rng = np.random.default_rng(11)
    for kind, site in ts.sites.items():
        acts = _dyadic(rng, (2, FRAME_TOKENS, site.n))
        jm_, jlat = js.mask(kind, jnp.asarray(acts))
        tm_, tlat = ts.mask(kind, torch.from_numpy(acts))
        if method == "dense":
            assert jm_ is None and tm_ is None
        else:
            assert tm_.dtype == torch.float32
            np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))
            assert 0 < int(tm_.sum()) <= site.budget()
        np.testing.assert_allclose(float(tlat), float(jlat), rtol=1e-6)


def test_dense_methods_plan_and_time_nothing(pair):
    jcfg, tcfg, *_ = pair
    ts = TSparse(tcfg, method="dense", torch_device="cpu")
    assert ts.init_plan(tcfg.n_layers) == {} == JSparse(jcfg, method="dense").init_plan(2)
    assert ts.time_selection() == 0.0
    with pytest.raises(ValueError, match="dense_free"):
        TSparse(tcfg, method="dense_free", torch_device="cpu")


def _frames(jcfg, n_frames=2):
    rng = np.random.default_rng(0)
    return [jnp.asarray(rng.normal(0, 1, (2, FRAME_TOKENS, jcfg.d_frontend)), jnp.bfloat16)
            for _ in range(n_frames)]


def _serve(engine_cls, model, params, batch, frames, n_tokens, **kw):
    eng = engine_cls(model, params, max_seq=MAX_SEQ, batch_size=2, device="nano",
                     sparsity=0.4, seed=3, **kw)
    last = eng.prefill(batch)
    for f in frames:
        eng.append_frame(f if engine_cls is JEngine else _t(f))
    if engine_cls is JEngine:
        tok0 = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
    else:
        tok0 = torch.argmax(last, dim=-1)[:, None]
    return eng, np.asarray(eng.decode(tok0, n_tokens))


# chunk decode steps after the first select from importances recorded from
# bf16 activations, whose last bits differ across the frameworks and may tip
# a near tie (ROADMAP queue 3); its first step runs on the masks of the
# shared uniform bootstrap. A frame's masks come from its own bf16
# activations too; chunk's windows hold here, but top-k's per-row ranks tip
# (its frame masks differ from the reference's), so top-k's frame path is
# held to the reference on replayed masks (test_block_append_matches_
# reference) and its selection on shared activations
# (test_sparse_exec_mask_equals_reference). dense / dense_free select
# nothing.
@pytest.mark.parametrize("method,wbits,n_tokens", [
    ("chunk", 16, 1), ("chunk", 8, 1), ("dense", 16, 4), ("dense", 8, 4),
    ("dense_free", 16, 4),
])
def test_engine_frames_match_reference(pair, method, wbits, n_tokens):
    """prefill → 2 frames → decode through both engines: each frame's
    estimated and simulated I/O, the tokens, and the I/O totals."""
    jcfg, tcfg, jm, tm, jp, tp, jb, tb = pair
    frames = _frames(jcfg)
    kw = dict(method=method, wbits=wbits, backend="reference")
    jeng, jout = _serve(JEngine, jm, jp, jb, frames, n_tokens, **kw)
    teng, tout = _serve(TEngine, tm, tp, tb, frames, n_tokens, torch_device="cpu", **kw)
    np.testing.assert_array_equal(tout, jout)
    assert [s.kind for s in teng.stats] == [s.kind for s in jeng.stats]
    for ts_, js_ in zip(teng.stats, jeng.stats):
        assert ts_.tokens == js_.tokens
        np.testing.assert_allclose(ts_.io_est_s, js_.io_est_s, rtol=1e-6, err_msg=ts_.kind)
        np.testing.assert_allclose(ts_.io_sim_s, js_.io_sim_s, rtol=1e-6, err_msg=ts_.kind)
    assert teng.cache["length"] == PROMPT + 2 * FRAME_TOKENS + n_tokens
    tsum, jsum = teng.io_summary(), jeng.io_summary()
    for key in ("io_est_s", "io_sim_s", "io_bytes", "decode_serial_s", "decode_overlap_s"):
        np.testing.assert_allclose(tsum[key], jsum[key], rtol=1e-6, err_msg=key)
    if method == "dense_free":
        assert tsum["io_est_s"] == tsum["io_bytes"] == 0.0 and teng.sparse_ctx is None
    if method == "dense":
        frame_io = [s.io_est_s for s in teng.stats if s.kind == "frame"]
        assert frame_io[0] == frame_io[1] > 0.0
        assert tsum["select_overhead_s"] == 0.0


def test_dense_free_streams_nothing_and_matches_dense_tokens(pair):
    jcfg, tcfg, jm, tm, jp, tp, jb, tb = pair
    frames = _frames(jcfg)
    outs = {m: _serve(TEngine, tm, tp, tb, frames, 3, method=m, torch_device="cpu")[1]
            for m in ("dense", "dense_free")}
    np.testing.assert_array_equal(outs["dense"], outs["dense_free"])


def test_serve_cli_runs_the_vlm_on_cpu(capsys):
    eng, out = tserve.main(["--arch", "internvl2-76b", "--reduced", "--frames", "2",
                            "--torch-device", "cpu", "--backend", "kernel",
                            "--decode-tokens", "3", "--max-seq", "96"])
    text = capsys.readouterr().out
    assert out.shape == (2, 4)
    assert "[frame 0] 4 tokens" in text and "[frame 1] 4 tokens" in text
    assert [s.kind for s in eng.stats][:3] == ["prefill", "frame", "frame"]
    assert eng.cache["length"] == 32 + 2 * 4 + 3
    eng, _ = tserve.main(["--arch", "internvl2-76b", "--reduced", "--frames", "1",
                          "--torch-device", "cpu", "--method", "dense_free",
                          "--decode-tokens", "2"])
    assert "[total] method=dense_free" in capsys.readouterr().out
    assert eng.io_summary()["io_sim_s"] == 0.0


def test_video_stream_runs_on_cpu(capsys):
    res = tvideo.main(["--frames", "2", "--decode-tokens", "3", "--torch-device", "cpu"])
    text = capsys.readouterr().out
    assert "neuron chunking vs top-k I/O speedup" in text and "refresh k" in text
    assert set(res["policies"]) == {"dense", "topk", "chunk"}
    assert set(res["reuse"]) == {1, 2, 4}
    # chunking streams fewer bytes' worth of flash time than dense or top-k
    p = res["policies"]
    assert p["chunk"]["total_io_s"] < min(p["dense"]["total_io_s"], p["topk"]["total_io_s"])


def _example_policy_rows(jm, jp, jb, frames, decode_tokens, logs):
    """``examples/serve_video_stream.py``'s policy loop on the reference
    engine, at its settings (max_seq 512, seed 1, sparsity 0.4, refresh 1),
    with each method's frame masks recorded into ``logs[method]``."""
    rows = {}
    for method in tvideo.POLICIES:
        eng = JEngine(jm, jp, max_seq=512, batch_size=2, device="nano", sparsity=0.4,
                      method=method, seed=1, plan_refresh_interval=1)
        rec = _Recorder(eng.sparse_ctx)
        eng._append = jax.jit(lambda p, f, c, rec=rec: jm.append_frame(p, f, c, rec))
        last = eng.prefill(jb)
        for f in frames:
            eng.append_frame(f)
        jax.effects_barrier()
        logs[method] = rec.log
        eng.decode(jnp.argmax(last, -1)[:, None].astype(jnp.int32), decode_tokens)
        fr = [s.io_sim_s for s in eng.stats if s.kind == "frame"]
        de = [s.io_sim_s for s in eng.stats if s.kind == "decode"]
        rows[method] = {"frame_io_s": float(np.mean(fr)), "decode_io_s": float(np.mean(de)),
                        "total_io_s": sum(s.io_sim_s for s in eng.stats if s.kind != "prefill")}
    return rows


def test_video_stream_policy_table_matches_reference(pair, monkeypatch):
    """``video_stream.policy_io`` against the example's own loop on the
    same params, prompt and frames: every row's frame, decode and total
    simulated I/O to 1e-6. Top-k's frame masks tip on near ties of bf16
    activations (see above), so the port's top-k and chunk frames replay
    the reference's masks; dense selects nothing and runs the port's own
    ``mask``. One decode token: later steps select from bf16 importances
    (top-k's tip here), the first runs on the shared uniform bootstrap."""
    jcfg, tcfg, jm, tm, jp, tp, jb, tb = pair
    frames = _frames(jcfg)
    logs = {}
    want = _example_policy_rows(jm, jp, jb, frames, 1, logs)
    own_mask = TSparse.mask
    replay = {m: _Replay(logs[m]) for m in ("topk", "chunk")}

    def mask(self, kind, acts):
        if self.method == "dense":
            return own_mask(self, kind, acts)
        return replay[self.method].mask(kind, acts)

    monkeypatch.setattr(TSparse, "mask", mask)
    got = tvideo.policy_io(tm, tp, tb, [_t(f) for f in frames], 1, 0.4, 1, "cpu")
    assert list(got) == list(want)
    assert all(not r.log for r in replay.values())
    assert len(logs["chunk"]) == 2 * 4 * jcfg.n_layers
    for method, row in want.items():
        for key, v in row.items():
            np.testing.assert_allclose(got[method][key], v, rtol=1e-6, err_msg=f"{method} {key}")


def test_video_stream_reuse_sweep_matches_reference(pair):
    """``video_stream.reuse_io`` against the example's plan-reuse loop, two
    decode tokens: at k = 2 and 4 both steps run on the bootstrap plan (the
    second reuses it) and compare to 1e-6. At k = 1 the second step selects
    from bf16 importances, whose near ties tip across the frameworks here,
    so k = 1 is held only by its first step, which is every k's first
    step."""
    jcfg, tcfg, jm, tm, jp, tp, jb, tb = pair
    got = tvideo.reuse_io(tm, tp, tb, 2, 0.4, "cpu")
    assert list(got) == list(tvideo.REUSE_INTERVALS) == [1, 2, 4]
    for k in (2, 4):
        eng = JEngine(jm, jp, max_seq=512, batch_size=2, device="nano", sparsity=0.4,
                      method="chunk", seed=1, plan_refresh_interval=k)
        last = eng.prefill(jb)
        eng.decode(jnp.argmax(last, -1)[:, None].astype(jnp.int32), 2)
        de = [s.io_sim_s for s in eng.stats if s.kind == "decode"]
        assert de[1] == 0.0
        np.testing.assert_allclose(got[k], np.mean(de), rtol=1e-6, err_msg=f"k={k}")


def test_compare_baselines_sweep_matches_reference(pair):
    """``compare_baselines.sweep`` against ``examples/compare_baselines.py``'s
    own computation, on the reference's hidden states (64 tokens) and
    carried-over weights: the same v, budgets, masks and tables, so
    out_rel_err is equal exactly (numpy on the same arrays and masks), and
    retention and io_ms, f32 sums taken in another order, to 1e-6. v is a
    mean over 128 rows; the two frameworks give it bit for bit here."""
    jcfg, tcfg, jm, tm, jp, tp, *_ = pair
    jb = jbatch(jcfg, JShape("s", 64, 2, "train"))
    hidden, _ = jm.forward(jp, jb, remat=False)
    n = jcfg.d_model
    v = np.asarray(jnp.abs(hidden.astype(jnp.float32)).reshape(-1, n).mean(0))
    w_down = np.asarray(jp["layers"]["w_down"][0], np.float32).T
    sel = JSelector.build(n, w_down.shape[1] * 2, device="nano",
                             cfg=JChunkConfig(2, 348, 2, 2))
    x_ref = np.asarray(hidden.astype(jnp.float32).reshape(-1, n))
    y_dense = x_ref @ w_down
    want = []
    for sp in (0.2, 0.4, 0.6):
        budget = int((1 - sp) * n)
        masks = {"topk": jnp.asarray(jbase.topk_mask_np(v, budget)),
                 "cats": jbase.threshold_mask(jnp.asarray(v),
                                              jbase.calibrate_threshold(v[None], sp)),
                 "chunk": sel.select(jnp.asarray(v), jnp.int32(budget))[0]}
        for name, mask in masks.items():
            y = (x_ref * np.asarray(mask, np.float32)) @ w_down
            want.append({"sparsity": sp, "method": name,
                         "retention": float(jretention(jnp.asarray(v), mask)),
                         "out_rel_err": float(np.linalg.norm(y - y_dense)
                                              / np.linalg.norm(y_dense)),
                         "io_ms": float(sel.table.mask_latency(mask)) * 1e3})
    got = tcompare.sweep(_t(hidden), tp["layers"]["w_down"][0].T)
    assert [(r["sparsity"], r["method"]) for r in got] == \
        [(r["sparsity"], r["method"]) for r in want]
    for g, w in zip(got, want):
        what = f"{w['sparsity']} {w['method']}"
        assert g["out_rel_err"] == w["out_rel_err"], what
        np.testing.assert_allclose(g["retention"], w["retention"], rtol=1e-6, err_msg=what)
        np.testing.assert_allclose(g["io_ms"], w["io_ms"], rtol=1e-6, err_msg=what)


def test_compare_baselines_runs_on_cpu(capsys):
    rows = tcompare.main(["--torch-device", "cpu"])
    assert "out_rel_err" in capsys.readouterr().out
    assert len(rows) == 9
    for r in rows:
        assert 0.0 < r["retention"] < 1.0 and r["io_ms"] > 0.0
    by = {(r["sparsity"], r["method"]): r for r in rows}
    # chunking trades a little retention for much less I/O
    for sp in (0.2, 0.4, 0.6):
        assert by[(sp, "chunk")]["io_ms"] < by[(sp, "topk")]["io_ms"]


def test_baselines_equal_reference():
    rng = np.random.default_rng(3)
    v = _dyadic(rng, (300,))
    v = np.abs(v)
    for budget in (0, 17, 150, 300):
        np.testing.assert_array_equal(tbase.topk_mask_np(v, budget), jbase.topk_mask_np(v, budget))
    for sp in (0.1, 0.5, 0.9):
        t = tbase.calibrate_threshold(v[None], sp)
        assert t == jbase.calibrate_threshold(v[None], sp)
        np.testing.assert_array_equal(tbase.threshold_mask(torch.from_numpy(v), t).numpy(),
                                      np.asarray(jbase.threshold_mask(jnp.asarray(v), t)))
    mask = v > 0.5
    for dev in ("nano", "agx"):
        np.testing.assert_allclose(tbase.bundled_latency(mask, 512, 3, dev),
                                   jbase.bundled_latency(mask, 512, 3, dev), rtol=1e-6)
        np.testing.assert_allclose(tbase.unbundled_latency(mask, 512, 3, dev),
                                   jbase.unbundled_latency(mask, 512, 3, dev), rtol=1e-6)
    assert tbase.bundled_latency(np.zeros(8, bool), 512, 3, "nano") == 0.0


@pytest.mark.parametrize("entry", ["launch.serve", "launch.video_stream",
                                   "launch.compare_baselines"])
def test_cli_entry_points_default_to_the_card(monkeypatch, entry):
    """With no card the CLIs raise at their default device; whether there
    is a card is decided here, by the patched probe."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mains = {"launch.serve": lambda: tserve.main(["--arch", "internvl2-76b", "--reduced"]),
             "launch.video_stream": lambda: tvideo.main([]),
             "launch.compare_baselines": lambda: tcompare.main([])}
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        mains[entry]()
