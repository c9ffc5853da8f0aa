"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference's ``moe_ffn``, on the CPU at small widths, with the reference's
own MoE tests (``tests/test_moe.py``; ``tests/test_perf_optimizations.py``'s
gather = scatter and ``ep_shard_map`` fallback) ported as cases.

Inputs and params are numpy-seeded and shared by both packages.
Tolerances:
  * f32: the routing (top-k experts and weights' order), each assignment's
    keep flag and buffer position are equal exactly; y within atol = rtol
    = 1e-5 (the products reduce in another order), aux within rtol 1e-6;
  * bf16: y within atol = rtol = 4e-2, a few bf16 ulps (the products are
    rounded at the same places but reduced in another order, as in
    ``tests/test_torch_model.py``), aux within rtol 1e-2 (softmax of bf16
    logits that differ in their last bit); routing from bf16 logits is held
    exactly only where no near tie can tip it (the zero-router ties).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.moe import MoEConfig as JMoE
from repro.models.moe import moe_ffn as j_moe_ffn
from repro.models.moe import moe_param_defs as j_param_defs
from repro_torch.models.common import swish
from repro_torch.models.moe import MoEConfig, dispatch_plan, moe_ffn, moe_param_shapes, route

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=4e-2, rtol=4e-2)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(e=4, k=2, d=16, f=32, cap=8.0, shared=False, dispatch="scatter"):
    kw = dict(n_experts=e, top_k=k, d_model=d, d_ff=f, capacity_factor=cap,
              shared_expert=shared, dispatch=dispatch)
    return JMoE(**kw), MoEConfig(**kw)


def _params(tcfg, seed=0, dtype="f32"):
    """Numpy normals at the reference's init scales: (jax params, port params)."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    np_p = {name: rng.normal(0, std, shape).astype(np.float32)
            for name, (shape, std) in sorted(moe_param_shapes(tcfg).items())}
    return ({k: jnp.asarray(v, jd) for k, v in np_p.items()},
            {k: torch.from_numpy(v).to(td) for k, v in np_p.items()})


def _x(shape, seed=1, dtype="f32"):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(t):
    return t.float().numpy()


def _j_dispatch(x, params, cfg):
    """The reference's routing and dispatch steps (``repro.models.moe.
    moe_ffn``'s own lines, which it does not return): (top_e, keep,
    buf_pos), keep and buf_pos in sorted order."""
    t = x.shape[0] * x.shape[1]
    xt = x.reshape(t, -1)
    probs = jax.nn.softmax((xt @ params["router"]).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, cfg.top_k)
    cap = cfg.capacity(t)
    flat_e = top_e.reshape(t * cfg.top_k)
    se = flat_e[jnp.argsort(flat_e, stable=True)]
    first = jnp.searchsorted(se, jnp.arange(cfg.n_experts), side="left")
    rank = jnp.arange(t * cfg.top_k, dtype=jnp.int32) - first[se].astype(jnp.int32)
    keep = rank < cap
    return (np.asarray(top_e), np.asarray(keep),
            np.asarray(jnp.where(keep, se * cap + rank, cfg.n_experts * cap)))


def _t_dispatch(x, params, cfg):
    t = x.shape[0] * x.shape[1]
    _, _, top_e = route(x.reshape(t, -1), params["router"], cfg)
    _, keep, buf_pos = dispatch_plan(top_e, cfg.capacity(t), cfg.n_experts)
    return top_e.numpy(), keep.numpy(), buf_pos.numpy()


@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
@pytest.mark.parametrize("shared,k,cap", [(False, 2, 8.0), (False, 2, 0.5), (True, 1, 1.25)],
                         ids=["olmoe-like", "drops", "scout-like"])
def test_moe_ffn_f32_equals_reference(dispatch, shared, k, cap):
    """Identical routing, keep flags and buffer positions; y and aux
    within the f32 tolerance; with and without drops and the shared expert."""
    jc, tc = _cfgs(e=4, k=k, cap=cap, shared=shared, dispatch=dispatch)
    jp, tp = _params(tc)
    jx, tx = _x((2, 12, 16))
    for a, b in zip(_t_dispatch(tx, tp, tc), _j_dispatch(jx, jp, jc)):
        np.testing.assert_array_equal(a, b)
    if cap < 1.0:
        assert not _t_dispatch(tx, tp, tc)[1].all()  # some assignments drop
    y, aux = moe_ffn(tx, tp, tc)
    jy, jaux = j_moe_ffn(jx, jp, jc)
    assert y.shape == (2, 12, 16) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
@pytest.mark.parametrize("shared,k", [(False, 2), (True, 1)], ids=["routed", "shared"])
def test_moe_ffn_bf16_within_tolerance(dispatch, shared, k):
    jc, tc = _cfgs(e=4, k=k, cap=8.0, shared=shared, dispatch=dispatch)
    jp, tp = _params(tc, seed=2, dtype="bf16")
    jx, tx = _x((2, 8, 16), seed=3, dtype="bf16")
    y, aux = moe_ffn(tx, tp, tc)
    jy, jaux = j_moe_ffn(jx, jp, jc)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), np.asarray(jy, np.float32), **BF16_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2])
def test_cap_one_drops_the_same_tokens(dtype, k):
    """At capacity 1 (top-1: 4 tokens over 4 experts at factor 1.0; top-2
    floors at 2), a zero router ties every expert: every token takes the
    lowest expert ids, and only the first tokens in stable order keep a
    slot. The same tokens drop as in the reference, and y is equal."""
    jc, tc = _cfgs(e=4, k=k, cap=1.0)
    jp, tp = _params(tc, seed=4, dtype=dtype)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    jx, tx = _x((1, 4, 16), seed=5, dtype=dtype)
    assert tc.capacity(4) == k
    top_e, keep, buf_pos = _t_dispatch(tx, tp, tc)
    for a, b in zip((top_e, keep, buf_pos), _j_dispatch(jx, jp, jc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(top_e, np.tile(np.arange(k), (4, 1)))
    # expert j's slots hold tokens 0..cap-1; tokens 1-3 (top-1) / 2-3 drop
    assert keep.sum() == k * k
    y = _np(moe_ffn(tx, tp, tc)[0])
    jy = np.asarray(j_moe_ffn(jx, jp, jc)[0], np.float32)
    np.testing.assert_allclose(y, jy, **(F32_TOL if dtype == "f32" else BF16_TOL))
    assert np.all(y[0, k:] == 0) and np.all(jy[0, k:] == 0)


def test_cap_one_at_decode_drops_the_later_token():
    """Llama-4-Scout's decode shape: top-1 over 16 experts, 2 tokens, cap 1.
    Two tokens routed to one expert: the later one (stable order) drops,
    and its output is the shared expert's alone."""
    jc, tc = _cfgs(e=16, k=1, cap=1.25, shared=True)
    jp, tp = _params(tc, seed=6)
    jx, tx = _x((2, 1, 16), seed=7)
    # route both tokens to expert 5: every input dim votes for it, x > 0
    router = np.zeros((16, 16), np.float32)
    router[:, 5] = 1.0
    jx = jnp.abs(jx) + 1.0
    tx = torch.from_numpy(np.array(jx))
    jp["router"], tp["router"] = jnp.asarray(router), torch.from_numpy(router)
    assert tc.capacity(2) == 1
    top_e, keep, buf_pos = _t_dispatch(tx, tp, tc)
    for a, b in zip((top_e, keep, buf_pos), _j_dispatch(jx, jp, jc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(keep, [True, False])
    y = moe_ffn(tx, tp, tc)[0].numpy()
    np.testing.assert_allclose(y, np.asarray(j_moe_ffn(jx, jp, jc)[0]), **F32_TOL)
    xt = tx.reshape(2, 16)
    shared = (swish(xt @ tp["ws_gate"]) * (xt @ tp["ws_up"])) @ tp["ws_down"]
    np.testing.assert_allclose(y[1, 0], shared[1].numpy(), **F32_TOL)


def test_combine_is_deterministic_and_in_expert_order():
    """The combine adds each token's contributions in ascending expert id,
    in the compute dtype: the same bits on every call, equal to a sum
    written out in that order."""
    jc, tc = _cfgs(e=8, k=4, cap=8.0)
    _, tp = _params(tc, seed=8, dtype="bf16")
    _, tx = _x((2, 5, 16), seed=9, dtype="bf16")
    y0 = moe_ffn(tx, tp, tc)[0]
    for _ in range(3):
        assert torch.equal(moe_ffn(tx, tp, tc)[0], y0)
    xt = tx.reshape(10, 16)
    _, top_w, top_e = route(xt, tp["router"], tc)
    want = torch.zeros_like(xt)
    for i in range(10):
        for j in torch.argsort(top_e[i]).tolist():  # ascending expert id
            e = int(top_e[i, j])
            h = swish(xt[i] @ tp["we_gate"][e]) * (xt[i] @ tp["we_up"][e])
            out = (h[None] @ tp["we_down"][e])[0]
            want[i] = want[i] + out * top_w[i, j].to(torch.bfloat16)
    np.testing.assert_allclose(_np(y0.reshape(10, 16)), _np(want), **BF16_TOL)


# -- the reference's own MoE tests, ported ------------------------------------


def _dense_spec(x, params, cfg):
    """Every expert over every token, combined with the normalised top-k
    router weights: what the sort-based dispatch computes when nothing
    drops (``tests/test_moe.py::_dense_reference``)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs = torch.softmax(xt @ params["router"], dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    g = torch.einsum("td,edf->tef", xt, params["we_gate"])
    u = torch.einsum("td,edf->tef", xt, params["we_up"])
    y_all = torch.einsum("tef,efd->ted", swish(g) * u, params["we_down"])
    w_per_e = (torch.nn.functional.one_hot(top_e, cfg.n_experts) * top_w[..., None]).sum(1)
    y = torch.einsum("ted,te->td", y_all, w_per_e)
    if cfg.shared_expert:
        y = y + (swish(xt @ params["ws_gate"]) * (xt @ params["ws_up"])) @ params["ws_down"]
    return y.reshape(b, s, d)


def test_sort_dispatch_matches_dense_reference():
    _, cfg = _cfgs()
    _, params = _params(cfg)
    _, x = _x((2, 6, 16))
    y, _ = moe_ffn(x, params, cfg)
    np.testing.assert_allclose(y.numpy(), _dense_spec(x, params, cfg).numpy(), atol=1e-4,
                               rtol=1e-4)


def test_shared_expert_path():
    _, cfg = _cfgs(k=1, shared=True)
    _, params = _params(cfg)
    _, x = _x((2, 4, 16))
    y, _ = moe_ffn(x, params, cfg)
    np.testing.assert_allclose(y.numpy(), _dense_spec(x, params, cfg).numpy(), atol=1e-4,
                               rtol=1e-4)


def test_capacity_drops_tokens():
    """With capacity_factor → 0 almost everything drops → output ≈ 0."""
    _, cfg = _cfgs(cap=0.01)
    _, params = _params(cfg)
    _, x = _x((2, 16, 16))
    y, _ = moe_ffn(x, params, cfg)
    y_full, _ = moe_ffn(x, params, MoEConfig(4, 2, 16, 32, capacity_factor=8.0))
    assert float(y.abs().mean()) < float(y_full.abs().mean())


def test_aux_loss_balanced_is_near_one():
    """Uniform routing (a zero router: every expert ties) ⇒ aux ≈ weight ×
    1.0 (Switch normalisation)."""
    _, cfg = _cfgs(e=4, k=1)
    _, params = _params(cfg)
    params["router"] = torch.zeros_like(params["router"])
    _, x = _x((4, 32, 16))
    _, aux = moe_ffn(x, params, cfg)
    assert float(aux) == pytest.approx(cfg.router_aux_weight, rel=0.05)


def test_capacity_rounding():
    cfg = MoEConfig(64, 8, 2048, 1024)
    c = cfg.capacity(1_048_576)
    assert c % 128 == 0 and c >= 1_048_576 * 8 * 1.25 / 64
    assert MoEConfig(4, 2, 8, 8).capacity(2) >= 2  # tiny decode floor
    for t in (1, 2, 7, 64, 300, 4096, 100_003):
        for kw in (dict(n_experts=64, top_k=8), dict(n_experts=16, top_k=1),
                   dict(n_experts=4, top_k=2, capacity_factor=8.0)):
            assert MoEConfig(d_model=8, d_ff=8, **kw).capacity(t) \
                == JMoE(d_model=8, d_ff=8, **kw).capacity(t)


def test_gather_dispatch_matches_scatter():
    _, cfg = _cfgs(cap=2.0)
    _, params = _params(cfg)
    _, x = _x((2, 16, 16))
    y_s, aux_s = moe_ffn(x, params, cfg)
    y_g, aux_g = moe_ffn(x, params, dataclasses.replace(cfg, dispatch="gather"))
    np.testing.assert_allclose(y_s.numpy(), y_g.numpy(), atol=1e-6)
    assert float(aux_s) == pytest.approx(float(aux_g))


def test_ep_dispatch_falls_back_without_mesh():
    """ep_shard_map runs as the gather path (the port has no mesh yet);
    an unknown dispatch raises."""
    _, cfg = _cfgs(dispatch="ep_shard_map")
    _, params = _params(cfg)
    _, x = _x((2, 8, 16))
    y, _ = moe_ffn(x, params, cfg)
    y_ref, _ = moe_ffn(x, params, dataclasses.replace(cfg, dispatch="scatter"))
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="dispatch"):
        moe_ffn(x, params, dataclasses.replace(cfg, dispatch="all_to_all"))


@pytest.mark.parametrize("shared", [False, True])
def test_param_shapes_and_scales_equal_reference(shared):
    jc, tc = _cfgs(e=8, k=2, d=48, f=96, shared=shared)
    defs = j_param_defs(jc)
    got = moe_param_shapes(tc)
    assert set(got) == set(defs)
    for name, d in defs.items():
        shape, std = got[name]
        assert shape == d.shape, name
        want = d.scale if d.scale is not None else 1.0 / np.sqrt(d.shape[-2])
        assert std == pytest.approx(want), name
