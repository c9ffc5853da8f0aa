"""Parity of the port's dense decoder with the JAX reference on the same
(carried-over) parameters, at ``tinyllama-1.1b --reduced``.

Tolerances: carried-over bf16 weights and int8/f32 quantized leaves are
equal exactly. Logits come out of bf16 activations (8 mantissa bits; one
ulp near |x| = 1 is 2^-7) that both packages round at the same places but
reduce in different orders, so they are compared with atol = rtol = 4e-2 —
a few bf16 ulps. Per-layer I/O estimates are f32 sums in another order:
rtol 1e-5. The first refresh's masks (uniform bootstrap importance) are
equal exactly.
"""
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
from repro.models.transformer import SPARSE_WEIGHT_NAMES
from repro.serving.sparse_exec import SparseExecution as JSparse
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape as TShape
from repro_torch.core.chunking import BatchedChunkSelector as TBatched
from repro_torch.core.chunking import ChunkSelector as TSelector
from repro_torch.core.latency_model import get_profile
from repro_torch.core.latency_model import profile_table as t_profile_table
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.models.inputs import make_dummy_batch as tbatch
from repro_torch.serving import ServeEngine as TEngine
from repro_torch.serving.sparse_exec import SparseExecution as TSparse

BF16_TOL = dict(atol=4e-2, rtol=4e-2)


@pytest.fixture(scope="module")
def pair():
    jcfg = jget("tinyllama-1.1b").reduced()
    tcfg = tget("tinyllama-1.1b").reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.key(0))
    layers = dict(jp["layers"])
    layers.update(j_quantize_params(layers, SPARSE_WEIGHT_NAMES))
    jp = {**jp, "layers": layers}
    tp = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    jb = jbatch(jcfg, JShape("t", 12, 2, "train"))
    tb = tbatch(tcfg, TShape("t", 12, 2, "train"), device="cpu")
    return jcfg, tcfg, jm, tm, jp, tp, jb, tb


def test_params_from_reference_exact(pair):
    jcfg, tcfg, jm, tm, jp, tp, *_ = pair
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].float().numpy(), np.asarray(jp["embed"], np.float32))
    for name, leaf in jp["layers"].items():
        got = tp["layers"][name]
        assert tuple(got.shape) == tuple(leaf.shape)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(leaf, np.float32))
    assert tp["layers"]["wq_q8"].dtype == torch.int8
    assert tp["layers"]["wq_sc"].dtype == torch.float32
    bad = dict(jax.device_get(jp))
    bad["head"] = bad["head"][:, :8]
    with pytest.raises(ValueError):
        params_from_reference(bad, tcfg, "cpu")


def test_prompt_tokens_equal_reference(pair):
    *_, jb, tb = pair
    np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))


def test_prefill_logits_allclose(pair):
    jcfg, tcfg, jm, tm, jp, tp, jb, tb = pair
    jl, jcache = jm.prefill(jp, jb, 32)
    tl, tcache = tm.prefill(tp, tb, 32)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32), **BF16_TOL)
    np.testing.assert_allclose(tcache["k"].float().numpy(),
                               np.asarray(jcache["k"], np.float32), **BF16_TOL)
    assert tcache["length"] == int(jcache["length"])


@pytest.mark.parametrize("wbits,interval", [(16, 1), (8, 1), (16, 3)])
def test_teacher_forced_decode_matches_reference(pair, wbits, interval):
    """Feed the reference's own greedy tokens to both packages; every
    step's logits and per-layer I/O estimates agree (refreshing every
    ``interval`` steps, reusing the plan in between), and the first
    refresh selects identical masks at every layer and site."""
    jcfg, tcfg, jm, tm, jp, tp, jb, tb = pair
    js = JSparse(jcfg, device="nano", sparsity=0.4, method="chunk", wbits=wbits)
    ts = TSparse(tcfg, device="nano", sparsity=0.4, method="chunk", wbits=wbits,
                torch_device="cpu")
    jl, jcache = jm.prefill(jp, jb, 32)
    _, tcache = tm.prefill(tp, tb, 32)
    jplan = js.init_plan(jcfg.n_layers)
    tplan = ts.init_plan(tcfg.n_layers)
    step = jax.jit(lambda p, t, c, pl, r: jm.decode_step_planned(p, t, c, js, pl, r))
    tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    for i in range(4):
        refresh = i % interval == 0
        jlog, jcache, jio, jplan = step(jp, tok, jcache, jplan, jnp.bool_(refresh))
        tlog, tio = tm.decode_step_planned(tp, torch.from_numpy(np.array(tok)), tcache, ts,
                                           tplan, refresh=refresh)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **BF16_TOL)
        np.testing.assert_allclose(tio.numpy(), np.asarray(jio), rtol=1e-5)
        if i == 0:
            for kind in ts.site_order:
                np.testing.assert_array_equal(tplan[kind]["mask"].numpy(),
                                              np.asarray(jplan[kind]["mask"]))
                np.testing.assert_array_equal(tplan[kind]["kstarts"].numpy(),
                                              np.asarray(jplan[kind]["kstarts"]))
                np.testing.assert_array_equal(tplan[kind]["ksizes"].numpy(),
                                              np.asarray(jplan[kind]["ksizes"]))
        tok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
    assert tcache["length"] == int(jcache["length"])


def test_dense_decode_step_without_sparse_ctx(pair):
    """The block runs dense without a sparse context; with a ``dense``
    sparse context and no plan (the unplanned path) it computes the same
    logits and charges every layer its full load, as the reference does."""
    jcfg, tcfg, jm, tm, jp, tp, jb, tb = pair
    jl, jcache = jm.prefill(jp, jb, 32)
    tl, tcache = tm.prefill(tp, tb, 32)
    tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    jlog, _, _ = jax.jit(jm.decode_step)(jp, tok, jcache)
    tlog, tio = tm.decode_step_planned(tp, torch.from_numpy(np.array(tok)), tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **BF16_TOL)
    assert float(tio.abs().sum()) == 0.0
    _, tcache = tm.prefill(tp, tb, 32)
    js = JSparse(jcfg, method="dense")
    jdlog, _, jio, _ = jm.decode_step_planned(jp, tok, jcache, js, plan={}, refresh=True)
    tdlog, tdio = tm.decode_step_planned(tp, torch.from_numpy(np.array(tok)), tcache,
                                         TSparse(tcfg, method="dense", torch_device="cpu"),
                                         plan=None)
    np.testing.assert_array_equal(tdlog.numpy(), tlog.numpy())
    np.testing.assert_allclose(tdlog.numpy(), np.asarray(jdlog), **BF16_TOL)
    np.testing.assert_allclose(tdio.numpy(), np.asarray(jio), rtol=1e-5)
    assert float(tdio.min()) > 0.0


def test_build_model_refuses_unported_families():
    """The SSM, hybrid and audio families still raise (MoE is served since
    its slice; ``tests/test_torch_moe_serve.py``)."""
    import dataclasses

    for family in ("ssm", "hybrid", "audio"):
        cfg = dataclasses.replace(tget("tinyllama-1.1b").reduced(), arch_type=family)
        with pytest.raises(NotImplementedError):
            tbuild(cfg)
    with pytest.raises(KeyError):
        tget("xlstm-125m")


@pytest.mark.parametrize("entry", ["init", "init_cache", "params_from_reference",
                                   "make_dummy_batch", "SparseExecution", "append_embeds",
                                   "ServeEngine", "BatchedChunkSelector.build",
                                   "profile_table", "DeviceProfile.build_table",
                                   "moe init", "moe params_from_reference",
                                   "moe append_embeds", "moe ServeEngine"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without a device the entry points run on ``cuda``: with no card they
    raise instead of falling back to the CPU; ``device="cpu"`` still runs.
    Whether there is a card is decided here, by the patched probe. The
    ``moe`` entries take reduced Llama-4-Scout (experts, shared expert,
    projector)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = "llama4-scout-17b-a16e" if entry.startswith("moe ") else "tinyllama-1.1b"
    entry = entry.removeprefix("moe ")
    tcfg = tget(arch).reduced()
    model = tbuild(tcfg)
    calls = {
        "init": lambda **kw: model.init(seed=0, **kw),
        "init_cache": lambda **kw: model.init_cache(2, 16, **kw),
        "params_from_reference": lambda **kw: params_from_reference(
            {k: v.float().numpy() if not isinstance(v, dict)
             else {n: t.float().numpy() for n, t in v.items()}
             for k, v in model.init(seed=0, device="cpu").items()}, tcfg, **kw),
        "make_dummy_batch": lambda **kw: tbatch(tcfg, TShape("t", 8, 2, "train"), **kw),
        "SparseExecution": lambda **kw: TSparse(
            tcfg, torch_device=kw.get("device")).init_plan(tcfg.n_layers),
        "append_embeds": lambda **kw: dict(zip(("hidden", "io"), model.append_embeds(
            model.init(seed=0, device="cpu"), torch.zeros(2, 3, tcfg.d_frontend or tcfg.d_model),
            model.init_cache(2, 16, device="cpu"), **kw))),
        "ServeEngine": lambda **kw: TEngine(
            model, model.init(seed=0, device="cpu"), max_seq=16, batch_size=2,
            torch_device=kw.get("device")).cache,
        "BatchedChunkSelector.build": lambda **kw: vars(TBatched.build(
            [TSelector.build(64, 256.0)], **kw)),
        "profile_table": lambda **kw: {"table": t_profile_table(
            "nano", 256.0, 8, torch_device=kw.get("device")).table},
        "DeviceProfile.build_table": lambda **kw: {"table": get_profile("nano").build_table(
            256.0, 8, **kw).table},
    }
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        calls[entry]()
    out = calls[entry](device="cpu")
    leaves = [out] if isinstance(out, torch.Tensor) else [
        t for v in out.values() for t in (v.values() if isinstance(v, dict) else [v])
        if isinstance(t, torch.Tensor)]
    assert leaves and all(t.device.type == "cpu" for t in leaves)
