"""The hybrid (Zamba2), recurrent (xLSTM) and audio encoder-decoder
(Whisper) families of the port against the JAX reference, on the CPU at
their ``--reduced`` configs: the configs and param trees, the forward, the
prefill (last logits and every cache leaf), four sequential decode steps,
and a decode step from the reference's own cache carried across
(``cache_from_reference``); then the reference suite's consistency cases
(``tests/test_decode_consistency.py``) on the port, and the front door
every family gets (``decode_step_planned``'s I/O vector, frame append and
paged KV refused).

The reference's params are carried over as numpy arrays, its constant
leaves (norm weights and biases, Mamba2's decays, skips and conv bias,
xLSTM's gate biases) drawn at random first, so that a missing or misplaced
term shows. Both packages run in f32 (``COMPUTE_DTYPE`` set in each), where
the same arithmetic in another order agrees to atol = rtol = 1e-4 on every
logit, hidden state and cache leaf; a bf16 case holds the prefill and
decode logits to the port's ``BF16_TOL`` (atol = rtol = 4e-2). The
consistency cases keep the reference's tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
import repro_torch.models.model as TM
from repro.configs import get_config as jget
from repro.configs.base import InputShape as JShape
from repro.models import build_model as jbuild
from repro.models.inputs import make_dummy_batch as jbatch
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape as TShape
from repro_torch.models import build_model as tbuild
from repro_torch.models import cache_from_reference, params_from_reference
from repro_torch.models.inputs import make_dummy_batch as tbatch
from torch_threads import one_thread  # noqa: F401

ARCHS = ("zamba2-7b", "xlstm-125m", "whisper-small")
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=4e-2, rtol=4e-2)
N_DECODE = 4


@pytest.fixture
def f32(monkeypatch):
    """The port computes in f32 for the test (the reference's f32 numbers
    come from the module fixture)."""
    monkeypatch.setattr(TM, "COMPUTE_DTYPE", torch.float32)


def randomized(jp, seed):
    """The reference's params with every constant leaf (all zeros or all
    ones: norm weights and biases, decays, skips, gate biases) drawn around
    its value."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        a = np.asarray(leaf)
        if a.size and np.all(a == a.flat[0]) and a.flat[0] in (0.0, 1.0):
            return jnp.asarray(a.flat[0] + 0.2 * rng.normal(size=a.shape), leaf.dtype)
        return leaf

    return jax.tree.map(draw, jp)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree, prefix=""):
    """{path: leaf} of a cache: dicts and tuples walked, the length kept."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """The reference at f32 on the reduced config: params (constants
    randomized), the forward's hidden states, the prefill's logits and
    cache, and N_DECODE decode steps fed its own greedy tokens."""
    arch = request.param
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    old = JM.COMPUTE_DTYPE
    JM.COMPUTE_DTYPE = jnp.float32
    try:
        jp = randomized(jax.jit(jm.init)(jax.random.key(0)), 1)
        jb = jbatch(jcfg, JShape("t", 12, 2, "train"))
        jh = jax.jit(lambda p, b: jm.forward(p, b, remat=False)[0])(jp, jb)
        jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, 32))(jp, jb)
        step = jax.jit(jm.decode_step)
        tok, cache, toks, logits = jb["tokens"][:, :1], jcache, [], []
        for _ in range(N_DECODE):
            lg, cache, _ = step(jp, tok, cache)
            toks.append(np.array(tok))
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    finally:
        JM.COMPUTE_DTYPE = old
    tp = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    tb = tbatch(tcfg, TShape("t", 12, 2, "train"), device="cpu")
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jp=jp, tp=tp, jb=jb, tb=tb,
                jh=_np(jh), jl=_np(jl), jcache=jax.device_get(jcache), toks=toks,
                logits=logits, step=step)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_registered_and_param_trees_equal(arch):
    """The configs carry the reference's numbers (full and reduced), and at
    full size the port's param tree has the reference's leaves, shapes and
    init scales."""
    assert arch in ARCH_IDS
    t, j = tget(arch), jget(arch)
    for cfg_t, cfg_j in ((t, j), (t.reduced(), j.reduced())):
        for field in dataclasses.fields(cfg_t):
            if field.name != "citation":
                assert getattr(cfg_t, field.name) == getattr(cfg_j, field.name), field.name
    assert t.is_encdec == j.is_encdec == (arch == "whisper-small")
    want = {}
    for top, d in jbuild(j)._impl._defs().items():
        for sub, pd in (d.items() if isinstance(d, dict) else ((None, d),)):
            want[f"{top}/{sub}" if sub else top] = pd
    got = tbuild(t).param_shapes()
    assert set(got) == set(want)
    for name, pd in want.items():
        shape, std, axes = got[name]
        assert shape == pd.shape, name
        assert axes == pd.axes, name
        if pd.init in ("ones", "zeros"):
            assert std == pd.init, name
        else:
            fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
            assert std == pytest.approx(pd.scale if pd.scale is not None else fan_in ** -0.5)


def test_params_carried_over_exactly(fam):
    """Every leaf arrives bit for bit; a leaf of the wrong shape is
    refused."""
    jp, tp, tcfg = jax.device_get(fam["jp"]), fam["tp"], fam["tcfg"]
    flat_j, flat_t = _flat(jp), _flat(tp)
    assert set(flat_j) == set(flat_t)
    for name, leaf in flat_j.items():
        np.testing.assert_array_equal(flat_t[name].numpy(), np.asarray(leaf), err_msg=name)
    bad = dict(jp)
    bad["embed"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="embed"):
        params_from_reference(bad, tcfg, "cpu")


def test_forward_matches_reference(fam, f32):
    np.testing.assert_allclose(fam["tm"].forward(fam["tp"], fam["tb"])[0].numpy(), fam["jh"],
                               **F32_TOL)


def test_prefill_logits_and_cache_match_reference(fam, f32):
    """The last logits and every cache leaf (KV caches, Mamba2 conv windows
    and SSM states, the encoder's keys and values, xLSTM's states), with
    their shapes and the length."""
    last, cache = fam["tm"].prefill(fam["tp"], fam["tb"], 32)
    np.testing.assert_allclose(last.numpy(), fam["jl"], **F32_TOL)
    got, want = _flat(cache), _flat(fam["jcache"])
    assert set(got) == set(want)
    for name, leaf in want.items():
        if name == "/length":
            assert got[name] == int(leaf) == 12
            continue
        assert tuple(got[name].shape) == np.shape(leaf), name
        np.testing.assert_allclose(got[name].numpy(), _np(leaf), err_msg=name, **F32_TOL)


def test_sequential_decode_matches_reference(fam, f32):
    """N_DECODE steps from the port's own prefill, fed the reference's
    tokens: every step's logits, and the cache length after them."""
    _, cache = fam["tm"].prefill(fam["tp"], fam["tb"], 32)
    for tok, want in zip(fam["toks"], fam["logits"]):
        lg, io = fam["tm"].decode_step(fam["tp"], torch.from_numpy(tok), cache)
        np.testing.assert_allclose(lg.numpy(), want, **F32_TOL)
        assert lg.dtype == torch.float32 and float(io) == 0.0
    assert cache["length"] == 12 + N_DECODE


def test_decode_from_the_reference_cache(fam, f32):
    """One decode step of the port from the reference's prefilled cache,
    carried across leaf by leaf, gives the reference's first step."""
    cache = cache_from_reference(fam["jcache"], "cpu")
    assert cache["length"] == 12
    lg, _ = fam["tm"].decode_step(fam["tp"], torch.from_numpy(fam["toks"][0]), cache)
    np.testing.assert_allclose(lg.numpy(), fam["logits"][0], **F32_TOL)
    assert cache["length"] == 13


def test_bf16_prefill_and_decode_match_reference(fam):
    """At the compute dtype the families serve in (bf16 params and
    activations), the prefill's last logits and two decode steps."""
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), fam["jp"])
    tp = params_from_reference(jax.device_get(jp), fam["tcfg"], "cpu")
    jl, jcache = jax.jit(lambda p, b: fam["jm"].prefill(p, b, 32))(jp, fam["jb"])
    tl, tcache = fam["tm"].prefill(tp, fam["tb"], 32)
    np.testing.assert_allclose(tl.to(torch.float32).numpy(), _np(jl), **BF16_TOL)
    for tok in fam["toks"][:2]:
        jlg, jcache, _ = fam["step"](jp, jnp.asarray(tok), jcache)
        tlg, _ = fam["tm"].decode_step(tp, torch.from_numpy(tok), tcache)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **BF16_TOL)


def test_front_door(fam):
    """``decode_step_planned`` spreads the family's I/O figure (0) evenly
    over the layers and leaves the plan as it was; frame append and a
    paged cache raise; the text starts at 0."""
    tm, tp, tcfg = fam["tm"], fam["tp"], fam["tcfg"]
    assert not tm.supports_paged_kv and not tm.is_decoder and tm.text_offset == 0
    params = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()} if isinstance(v, dict)
                  else v.to(torch.bfloat16)) for k, v in tp.items()}
    _, cache = tm.prefill(params, fam["tb"], 32)
    plan = {"hidden_attn": {"mask": torch.ones(3)}}
    before = plan["hidden_attn"]["mask"].clone()
    lg, io = tm.decode_step_planned(params, torch.from_numpy(fam["toks"][0]), cache,
                                    sparse_ctx=None, plan=plan, refresh=True)
    assert io.shape == (tcfg.n_layers,) and io.dtype == torch.float32
    assert float(io.abs().sum()) == 0.0 and lg.shape == (2, tcfg.vocab_size)
    assert torch.equal(plan["hidden_attn"]["mask"], before)
    with pytest.raises(NotImplementedError, match="append_frame"):
        tm.append_embeds(params, torch.zeros((2, 4, tcfg.d_frontend or tcfg.d_model)), cache,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="paged KV"):
        tm.init_paged_cache(2, 32, 8, 9, "cpu")


# ---- the reference suite's consistency cases, on the port ----------------


@pytest.mark.parametrize("arch", ARCHS)
def test_sequential_decode_matches_forward_f32(arch, f32):
    """Prefill (Whisper: of the first token) or an empty state, then decode
    token by token: the last logits equal a forward's (the reference's
    tolerance, atol = rtol = 1e-3)."""
    cfg = tget(arch).reduced()
    model = tbuild(cfg)
    params = model.init(seed=0, device="cpu")
    batch = tbatch(cfg, TShape("smoke", 12, 2, "train"), device="cpu")
    toks = batch["tokens"]
    if cfg.is_encdec:
        lg, cache = model.prefill(params, {**batch, "tokens": toks[:, :1]}, 32)
        for i in range(1, toks.shape[1]):
            lg, _ = model.decode_step(params, toks[:, i: i + 1], cache)
    else:
        cache = model.init_cache(2, 32, "cpu")
        for i in range(toks.shape[1]):
            lg, _ = model.decode_step(params, toks[:, i: i + 1], cache)
    want = model.logits(params, model.forward(params, batch)[0])[:, -1]
    np.testing.assert_allclose(lg.numpy(), want.numpy(), atol=1e-3, rtol=1e-3)


def test_zamba_prefill_matches_forward_f32(f32):
    cfg = tget("zamba2-7b").reduced()
    model = tbuild(cfg)
    params = model.init(seed=0, device="cpu")
    batch = tbatch(cfg, TShape("smoke", 12, 2, "train"), device="cpu")
    toks = batch["tokens"]
    _, cache = model.prefill(params, {"tokens": toks[:, :-1]}, 32)
    lg, _ = model.decode_step(params, toks[:, -1:], cache)
    want = model.logits(params, model.forward(params, batch)[0])[:, -1]
    np.testing.assert_allclose(lg.numpy(), want.numpy(), atol=1e-3)


def test_zamba_tail_and_groups_full_depth_layout():
    """Zamba2-7B's 81 layers are 13 groups of 6 and a tail of 3: the
    stacked leaves and the cache (13 KV caches, one per application of the
    shared block), checked on a narrow copy of the full config."""
    cfg = dataclasses.replace(tget("zamba2-7b").reduced(), n_layers=81, attn_every=6)
    model = tbuild(cfg)
    shapes = model.param_shapes()
    assert shapes["mamba_groups/w_in"][0][:2] == (13, 6)
    assert shapes["mamba_tail/w_in"][0][0] == 3
    assert shapes["shared/wq"][0] == (cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)
    cache = model.init_cache(2, 16, "cpu")
    assert cache["attn_k"].shape == (13, 2, 16, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert cache["mamba_groups"]["ssm"].shape[0] == 78 and cache["mamba_tail"]["conv"].shape[0] == 3


def test_whisper_prefill_takes_fewer_frames_f32(f32):
    """A frontend shorter than the config's frontend_tokens (the empty
    cache's size) prefills, as in the reference, and decoding on from it
    gives a forward's last logits."""
    cfg = tget("whisper-small").reduced()
    model = tbuild(cfg)
    params = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6))),
             "frontend": torch.from_numpy(rng.normal(size=(2, 9, cfg.d_frontend))).float()}
    lg, cache = model.prefill(params, {**batch, "tokens": batch["tokens"][:, :5]}, 16)
    assert cache["enc_k"].shape[2] == 9 < cfg.frontend_tokens
    lg, _ = model.decode_step(params, batch["tokens"][:, 5:], cache)
    want = model.logits(params, model.forward(params, batch)[0])[:, -1]
    np.testing.assert_allclose(lg.numpy(), want.numpy(), atol=1e-3, rtol=1e-3)
