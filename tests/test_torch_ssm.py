"""The port's Mamba2 and xLSTM layers (``repro_torch.models.ssm`` /
``xlstm``) against the JAX reference's (``repro.models.ssm`` / ``xlstm``)
on the CPU, on the same numpy inputs and the reference's params carried
over; then the reference suite's own cases (``tests/test_ssm.py``) on the
port: the chunked forward equals the stepwise decode, a prefill's state
continues exactly, the chunk size changes nothing, and the recurrent
blocks stream.

The reference's init makes the biases, skips, decays and norm weights ones
and zeros; they are drawn at random here, so that a missing or misplaced
term shows. Tolerances: f32 atol = rtol = 1e-5 (the same arithmetic in
another order); bf16 atol = rtol = 4e-2 (the port's ``BF16_TOL``: bf16
activations rounded in another order); the reference's own cases keep its
tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models import xlstm as jx
from repro.models.common import init_params
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as tx
from torch_threads import one_thread  # noqa: F401

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=4e-2, rtol=4e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
# names whose reference init is a constant (drawn at random here) and the
# value they are drawn around
NOT_RANDOM = {"a_log": 0.0, "dt_bias": 0.0, "d_skip": 1.0, "conv_b": 0.0, "norm_w": 1.0,
              "b_ig": 0.0, "b_fg": 1.0, "b_gates": 0.0}


def _params(defs, jdt, seed=0):
    """The reference's params with its constant leaves drawn at random, and
    the same values as torch tensors."""
    jp, _ = init_params(defs, jax.random.key(seed), jnp.float32)
    rng = np.random.default_rng(seed)
    out = {k: (NOT_RANDOM[k] + 0.3 * rng.normal(size=v.shape)) if k in NOT_RANDOM
           else np.asarray(v) for k, v in jp.items()}
    jp = {k: jnp.asarray(v, jdt) for k, v in out.items()}
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))) for k, v in jp.items()}
    return jp, tp


def _torch(x, tdt):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)), **tol)


MCFG = dict(d_model=16, d_state=8, d_conv=4, expand=2, head_dim=8, chunk=8)

# the reference's layers, jitted (one compile a shape; the same arithmetic)
j_mamba2_forward = jax.jit(jssm.mamba2_forward, static_argnums=(2,),
                           static_argnames=("return_state",))
j_mamba2_decode_step = jax.jit(jssm.mamba2_decode_step, static_argnums=(3,))
J_XLSTM = {"mlstm": jax.jit(jx.mlstm_forward, static_argnums=(2,)),
           "slstm": jax.jit(jx.slstm_forward, static_argnums=(2,))}


def _mamba(dtype, seed=0):
    jdt, tdt, tol = DTYPES[dtype]
    jc, tc = jssm.Mamba2Config(**MCFG), tssm.Mamba2Config(**MCFG)
    jp, tp = _params(jssm.mamba2_param_defs(jc), jdt, seed)
    return jc, tc, jp, {k: v.to(tdt) for k, v in tp.items()}, jdt, tdt, tol


def _xlstm(kind, dtype, seed=0):
    jdt, tdt, tol = DTYPES[dtype]
    jc, tc = jx.XLSTMConfig(d_model=16, n_heads=2, chunk=8), tx.XLSTMConfig(d_model=16,
                                                                             n_heads=2)
    defs = jx.slstm_param_defs(jc) if kind == "slstm" else jx.mlstm_param_defs(jc)
    jp, tp = _params(defs, jdt, seed)
    return jc, tc, jp, {k: v.to(tdt) for k, v in tp.items()}, jdt, tdt, tol


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_param_shapes_equal_reference(kind):
    """Shapes and init scales of every leaf equal the reference's
    ParamDefs (fan-in normal unless a scale is given; ones and zeros)."""
    if kind == "mamba2":
        got, defs = tssm.mamba2_param_shapes(tssm.Mamba2Config(d_model=3584)), \
            jssm.mamba2_param_defs(jssm.Mamba2Config(d_model=3584))
    else:
        tc, jc = tx.XLSTMConfig(d_model=768, n_heads=4), jx.XLSTMConfig(d_model=768, n_heads=4)
        got, defs = ((tx.slstm_param_shapes(tc), jx.slstm_param_defs(jc)) if kind == "slstm"
                     else (tx.mlstm_param_shapes(tc), jx.mlstm_param_defs(jc)))
    assert set(got) == set(defs)
    for name, d in defs.items():
        shape, std, axes = got[name]
        assert shape == d.shape, name
        assert axes == d.axes, name
        if d.init in ("ones", "zeros"):
            assert std == d.init, name
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            assert std == pytest.approx(d.scale if d.scale is not None else fan_in ** -0.5)


@pytest.mark.parametrize("dtype,s", [("f32", 21), ("bf16", 21), ("f32", 2), ("bf16", 2)])
def test_mamba2_forward_matches_reference(dtype, s):
    """The chunked SSD forward over a sequence that pads its last chunk
    (s = 21 of chunk 8), or shorter than the conv window (s = 2): the
    output and the decode-ready state; without the state the output is the
    same."""
    jc, tc, jp, tp, jdt, tdt, tol = _mamba(dtype)
    jxs = jnp.asarray(np.random.default_rng(1).normal(size=(2, s, 16)), jdt)
    jout, jst = j_mamba2_forward(jxs, jp, jc, return_state=True)
    tout, tst = tssm.mamba2_forward(_torch(jxs, tdt), tp, tc, return_state=True)
    _close(tout, jout, tol)
    assert torch.equal(tssm.mamba2_forward(_torch(jxs, tdt), tp, tc), tout)
    assert tst["conv"].dtype == tdt and tst["ssm"].dtype == torch.float32
    for key in ("conv", "ssm"):
        assert tuple(tst[key].shape) == jst[key].shape
        _close(tst[key], jst[key], tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba2_decode_step_matches_reference(dtype):
    """Two recurrent steps from the same state (a random conv window and
    SSM state): each output and the state after it."""
    jc, tc, jp, tp, jdt, tdt, tol = _mamba(dtype, seed=2)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 2, 16)), jdt)
    jst = {"conv": jnp.asarray(rng.normal(size=(2, jc.d_conv - 1, jc.conv_dim)), jdt),
           "ssm": jnp.asarray(rng.normal(size=(2, jc.n_heads, jc.head_dim, jc.d_state)),
                              jnp.float32)}
    tst = {k: _torch(v, tdt if k == "conv" else torch.float32) for k, v in jst.items()}
    for t in range(2):
        jo, jst = j_mamba2_decode_step(x[:, t: t + 1], jst, jp, jc)
        to, tst = tssm.mamba2_decode_step(_torch(x[:, t: t + 1], tdt), tst, tp, tc)
        _close(to, jo, tol)
        for key in ("conv", "ssm"):
            _close(tst[key], jst[key], tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_forward_and_streaming_match_reference(kind, dtype):
    """The block over 9 steps from the initial state, then one step (a
    decode) from the carried state: outputs and every state leaf, against
    the reference's chunked scans (whose padded steps the port skips)."""
    jc, tc, jp, tp, jdt, tdt, tol = _xlstm(kind, dtype, seed=4)
    jf, tf = J_XLSTM[kind], tx.slstm_forward if kind == "slstm" else tx.mlstm_forward
    x = jnp.asarray(np.random.default_rng(5).normal(size=(2, 10, 16)), jdt)
    jst = tst = None
    for lo, hi in ((0, 9), (9, 10)):
        jo, jst = jf(x[:, lo:hi], jp, jc, state=jst)
        to, tst = tf(_torch(x[:, lo:hi], tdt), tp, tc, state=tst)
        _close(to, jo, tol)
        assert len(tst) == len(jst)
        for tl, jl in zip(tst, jst):
            assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
            _close(tl, jl, tol)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_state_init_equals_reference(kind):
    jc, tc = jx.XLSTMConfig(d_model=16, n_heads=2), tx.XLSTMConfig(d_model=16, n_heads=2)
    js = jx.slstm_state_init(jc, 3) if kind == "slstm" else jx.mlstm_state_init(jc, 3)
    ts = tx.slstm_state_init(tc, 3) if kind == "slstm" else tx.mlstm_state_init(tc, 3)
    for tl, jl in zip(ts, js):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


# ---- the reference suite's cases (tests/test_ssm.py), on the port --------


def _mamba_f32(chunk=8):
    return tssm.Mamba2Config(**{**MCFG, "chunk": chunk}), _mamba("f32")[3]


def test_chunked_equals_stepwise_decode():
    """Chunked SSD forward == the O(1) recurrent decode run token by token
    (s = 21: the last chunk padded)."""
    cfg, params = _mamba_f32()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 21, 16))).to(torch.float32)
    y_chunked = tssm.mamba2_forward(x, params, cfg)
    state = tssm.mamba2_state_init(cfg, 2, torch.float32)
    outs = []
    for t in range(21):
        o, state = tssm.mamba2_decode_step(x[:, t: t + 1], state, params, cfg)
        outs.append(o)
    np.testing.assert_allclose(y_chunked.numpy(), torch.cat(outs, dim=1).numpy(), atol=2e-4,
                               rtol=1e-3)


def test_prefill_state_continues_exactly():
    """forward(return_state) → a decode step continues as the full forward."""
    cfg, params = _mamba_f32()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 20, 16))).to(torch.float32)
    y_full = tssm.mamba2_forward(x, params, cfg)
    _, state = tssm.mamba2_forward(x[:, :19], params, cfg, return_state=True)
    o, _ = tssm.mamba2_decode_step(x[:, 19:20], state, params, cfg)
    np.testing.assert_allclose(o.numpy(), y_full[:, 19:20].numpy(), atol=2e-4, rtol=1e-3)


def test_chunk_size_invariance():
    cfg8, params = _mamba_f32(8)
    cfg4 = tssm.Mamba2Config(**{**MCFG, "chunk": 4})
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 16, 16))).to(torch.float32)
    np.testing.assert_allclose(tssm.mamba2_forward(x, params, cfg8).numpy(),
                               tssm.mamba2_forward(x, params, cfg4).numpy(), atol=1e-4)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_streaming_state(kind):
    """Forward over s tokens == forward over the first 9 + the rest with
    the carried state (what makes the decode exact)."""
    _, tc, _, tp, *_ = _xlstm(kind, "f32")
    fn = tx.slstm_forward if kind == "slstm" else tx.mlstm_forward
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 14, 16))).to(torch.float32)
    y_full, _ = fn(x, tp, tc)
    y1, st = fn(x[:, :9], tp, tc)
    y2, _ = fn(x[:, 9:], tp, tc, state=st)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), y_full.numpy(), atol=1e-4)
