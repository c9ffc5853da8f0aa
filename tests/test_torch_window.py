"""The rotating-window KV cache of the port against the JAX reference, on
the CPU at ``starcoder2-3b --reduced`` with ``sliding_window`` = 16.

Both packages engage a window only past ``WINDOW_ENGAGE_THRESHOLD``
positions (65,536), and both read that module global at call time, so the
tests lower it to 32 in both modules (``monkeypatch``; nothing in the
reference changes): a cache of ``max_seq`` = 48 then holds 16 positions,
and a 40-token prompt is rolled into it.

Tolerances (as ``tests/test_torch_model.py`` states them): logits and
cache entries come out of bf16 activations reduced in another order, atol =
rtol = 4e-2; f32 attention against the reference's at 1e-5; lengths, write
slots and tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel_mod
import repro_torch.models.model as tmodel_mod
from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.serving import ServeEngine as JEngine
from repro.serving.sparse_exec import SparseExecution as JSparse
from repro_torch.configs import get_config as tget
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.models.attention import CacheSpec
from repro_torch.serving import ServeEngine as TEngine
from repro_torch.serving.sparse_exec import SparseExecution as TSparse

BF16_TOL = dict(atol=4e-2, rtol=4e-2)
WINDOW, THRESHOLD, MAX_SEQ, PROMPT, DECODE = 16, 32, 48, 40, 8


@pytest.fixture(autouse=True)
def low_threshold(monkeypatch):
    """The window engages past 32 positions, in both packages."""
    monkeypatch.setattr(jmodel_mod, "WINDOW_ENGAGE_THRESHOLD", THRESHOLD)
    monkeypatch.setattr(tmodel_mod, "WINDOW_ENGAGE_THRESHOLD", THRESHOLD)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def win():
    jcfg = dataclasses.replace(jget("starcoder2-3b").reduced(), sliding_window=WINDOW)
    tcfg = dataclasses.replace(tget("starcoder2-3b").reduced(), sliding_window=WINDOW)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (2, PROMPT + DECODE))
    return jcfg, tcfg, jm, tm, jp, tp, tokens


def test_window_engages_past_the_threshold(win):
    jcfg, tcfg, jm, tm, *_ = win
    for seq, want in ((THRESHOLD, None), (MAX_SEQ, WINDOW)):
        assert tmodel_mod.effective_window(tcfg, seq) == jmodel_mod.effective_window(jcfg, seq) \
            == want
        assert tm.init_cache(2, seq, "cpu")["k"].shape == jm.init_cache(2, seq)["k"].shape
    assert tm.init_cache(2, MAX_SEQ, "cpu")["k"].shape[2] == WINDOW
    assert CacheSpec(2, 8, 1, 4, window=WINDOW).physical_len == 8
    assert CacheSpec(2, MAX_SEQ, 1, 4).physical_len == MAX_SEQ


def test_blockwise_window_matches_reference():
    """The blockwise attention with a window (the long-prompt path) against
    the reference's, and against the port's direct path, in f32."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(0, 1, (2, 40, 2, 8)).astype(np.float32) for _ in range(3))
    want = jattn._blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)), 0, True, WINDOW,
                                      block_q=8, block_kv=16)
    got = tattn._blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)), 0, True,
                                     WINDOW, block_q=8, block_kv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    pos = torch.arange(40)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - WINDOW)
    direct = tattn._direct_attention(*(torch.from_numpy(a) for a in (q, k, v)), mask)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("method", [None, "chunk"])
def test_rolled_prefill_and_decode_past_the_window(win, method):
    """A 40-token prompt rolled into a 16-position cache, then 8
    teacher-forced decode steps (dense, or planned on the reference
    backend): after every step the cache contents, the logits, the length
    and the slot the step wrote (``length % 16``) equal the reference's;
    the last logits also match a windowed forward over all 48 positions."""
    jcfg, tcfg, jm, tm, jp, tp, tokens = win
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens[:, :PROMPT])}, MAX_SEQ)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :PROMPT])}, MAX_SEQ)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32), **BF16_TOL)
    assert tc["k"].shape[2] == WINDOW and tc["length"] == int(jc["length"]) == PROMPT
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].float().numpy(), np.asarray(jc[key], np.float32),
                                   **BF16_TOL)
    js = ts = jplan = tplan = None
    if method:
        js = JSparse(jcfg, method=method, sparsity=0.4)
        ts = TSparse(tcfg, method=method, sparsity=0.4, torch_device="cpu")
        jplan, tplan = js.init_plan(jcfg.n_layers), ts.init_plan(tcfg.n_layers)
    step = jax.jit(lambda c, t, pl: jm.decode_step_planned(jp, t, c, js, pl, jnp.bool_(True)))
    for i in range(DECODE):
        tok = tokens[:, PROMPT + i: PROMPT + i + 1]
        before = tc["k"].clone()
        jlog, jc, _, jplan = step(jc, jnp.asarray(tok, jnp.int32), jplan)
        tlog, _ = tm.decode_step_planned(tp, torch.from_numpy(tok), tc, ts, tplan)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **BF16_TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].float().numpy(), np.asarray(jc[key], np.float32),
                                       **BF16_TOL)
        written = (tc["k"] != before).any(dim=(0, 1, 3, 4)).nonzero().flatten().tolist()
        assert written == [(PROMPT + i) % WINDOW]
        assert tc["length"] == int(jc["length"]) == PROMPT + i + 1
    if method is None:
        hidden = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})[0]
        np.testing.assert_allclose(tlog.numpy(), tm.logits(tp, hidden[:, -1]).float().numpy(),
                                   **BF16_TOL)
        jhidden, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
        np.testing.assert_allclose(hidden.float().numpy(), np.asarray(jhidden, np.float32),
                                   **BF16_TOL)


def _slots(cls, model, params, prompts, n_tokens):
    kw = dict(torch_device="cpu") if cls is TEngine else {}
    eng = cls(model, params, max_seq=MAX_SEQ, batch_size=2, device="nano", sparsity=0.4,
              seed=3, method="chunk", backend="reference", **kw)
    eng.enable_slots()
    lasts = [eng.admit_slot(slot, p)[0] for slot, p in enumerate(prompts)]
    if cls is TEngine:
        first = torch.cat([torch.argmax(x, dim=-1)[:, None] for x in lasts])
    else:
        first = jnp.concatenate([jnp.argmax(x, -1)[:, None] for x in lasts]).astype(jnp.int32)
    out, _ = eng.decode_slots(first, n_tokens)
    return eng, np.asarray(out)


def test_slot_mode_on_a_windowed_cache(win):
    """Slot mode with per-slot device lengths on the rotating cache: a
    40-token request (rolled) and a 12-token one that rotates mid-round.
    The first decode step runs on the shared bootstrap's masks: its tokens,
    the slots' lengths and the cache contents equal the reference
    engine's."""
    jcfg, tcfg, jm, tm, jp, tp, tokens = win
    ps = [tokens[:1, :PROMPT], tokens[1:, :12]]
    jeng, jout = _slots(JEngine, jm, jp, [{"tokens": jnp.asarray(p)} for p in ps], 1)
    teng, tout = _slots(TEngine, tm, tp, [{"tokens": torch.from_numpy(p)} for p in ps], 1)
    np.testing.assert_array_equal(tout, jout)
    assert isinstance(teng.cache["length"], torch.Tensor)
    np.testing.assert_array_equal(teng.slot_lengths(), jeng.slot_lengths())
    np.testing.assert_array_equal(teng.slot_lengths(), [PROMPT + 1, 13])
    for key in ("k", "v"):
        assert teng.cache[key].shape[2] == WINDOW
        np.testing.assert_allclose(teng.cache[key].float().numpy(),
                                   np.asarray(jeng.cache[key], np.float32), **BF16_TOL)
    # past the window: slot 1 writes positions 13..16 at 13, 14, 15 and 0
    before = teng.cache["k"][:, 1].clone()
    teng.decode_slots(torch.from_numpy(tout[:, -1:]), 4)
    changed = (teng.cache["k"][:, 1] != before).any(dim=(0, 2, 3)).nonzero().flatten().tolist()
    assert changed == [0, 13, 14, 15]
    np.testing.assert_array_equal(teng.slot_lengths(), [PROMPT + 5, 17])


def test_paged_kv_with_a_window_is_refused(win):
    jcfg, tcfg, jm, tm, jp, tp, _ = win
    with pytest.raises(ValueError, match="sliding windows"):
        jm.init_paged_cache(2, MAX_SEQ, 8, 13)
    with pytest.raises(ValueError, match="sliding windows"):
        tm.init_paged_cache(2, MAX_SEQ, 8, 13, "cpu")
    with pytest.raises(ValueError, match="sliding windows"):
        TEngine(tm, tp, max_seq=MAX_SEQ, batch_size=2, kv_page_tokens=8, torch_device="cpu")
    with pytest.raises(ValueError, match="sliding windows"):
        JEngine(jm, jp, max_seq=MAX_SEQ, batch_size=2, kv_page_tokens=8)
    # below the threshold a paged cache is fine
    assert tm.init_paged_cache(2, THRESHOLD, 8, 9, "cpu")["k"].shape[2] == 8
    # a paged cache never rotates: the decode refuses a window with a table
    from repro_torch.models.transformer import stack_decode

    cache = tm.init_paged_cache(2, THRESHOLD, 8, 9, "cpu")
    with pytest.raises(ValueError, match="sliding windows"):
        stack_decode(tp["layers"], torch.zeros(2, 1, tcfg.d_model, dtype=torch.bfloat16),
                     cache, tcfg, window=WINDOW)
