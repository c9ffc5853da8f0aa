"""The port's blockwise prefill attention against the JAX reference on the
CPU: ``_blockwise_attention`` (online softmax over (block_q, block_kv)
tiles), the ``blockwise_threshold`` dispatch of ``multi_head_attention``
(above 2048 positions, ``q_offset = sk - s``), and a 2100-token prefill of
``tinyllama-1.1b --reduced`` and of ``internvl2-76b --reduced`` with a
long vision prefix, both on carried-over parameters.

Tolerances: f32 attention against the reference's blockwise and against
the direct path at ``atol=2e-5``, the tolerance the reference's own suite
holds blockwise against direct to (``tests/test_attention.py``). Prefill
logits and cache rows come out of bf16 activations reduced in other
orders: atol = rtol = 4e-2, as in ``test_torch_model.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models.attention import _blockwise_attention as j_blockwise
from repro.models.attention import multi_head_attention as j_mha
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.models import attention as tatt
from torch_threads import one_thread  # noqa: F401

BF16_TOL = dict(atol=4e-2, rtol=4e-2)
LONG = 2100


def _qkv(rng, b=2, s=96, h=4, hd=16, skv=None):
    shapes = ((b, s, h, hd), (b, skv or s, h, hd), (b, skv or s, h, hd))
    return [rng.normal(0, 1, shp).astype(np.float32) for shp in shapes]


def _direct(q, k, v, q_offset, window=None):
    s, sk = q.shape[1], k.shape[1]
    qi = torch.arange(s)[:, None] + q_offset
    kj = torch.arange(sk)[None, :]
    mask = kj <= qi
    if window is not None:
        mask &= kj > qi - window
    return tatt._direct_attention(q, k, v, mask)


@pytest.mark.parametrize("s,skv,block_q,block_kv,window", [
    (96, None, 32, 32, None), (70, None, 32, 32, None), (96, None, 32, 32, 24),
    (40, 100, 32, 32, None), (LONG, None, 512, 1024, None)])
def test_blockwise_equals_reference_and_direct(s, skv, block_q, block_kv, window):
    rng = np.random.default_rng(s)
    q, k, v = _qkv(rng, s=s, skv=skv, h=2 if s == LONG else 4)
    off = k.shape[1] - s
    got = tatt._blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)), off, True,
                                    window, block_q, block_kv)
    want = j_blockwise(*(jnp.asarray(a) for a in (q, k, v)), jnp.int32(off), True, window,
                       block_q, block_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    direct = _direct(*(torch.from_numpy(a) for a in (q, k, v)), off, window)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=2e-5)


def test_attention_dispatch_above_the_threshold():
    """``multi_head_attention`` over 2100 positions takes the blockwise path
    (as the reference's does); a threshold above the length gives the
    direct path, within the blockwise-vs-direct tolerance."""
    rng = np.random.default_rng(1)
    d, h, hd = 32, 4, 8
    x = rng.normal(0, 1, (1, LONG, d)).astype(np.float32)
    params = {n: rng.normal(0, d ** -0.5, shp).astype(np.float32)
              for n, shp in (("wq", (d, h * hd)), ("wk", (d, 2 * hd)), ("wv", (d, 2 * hd)),
                             ("wo", (h * hd, d)))}
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    got = tatt.multi_head_attention(torch.from_numpy(x), tp, h, 2, hd, rope_theta=10000.0)
    want = j_mha(jnp.asarray(x), {n: jnp.asarray(a) for n, a in params.items()}, h, 2, hd,
                 rope_theta=10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    direct = tatt.multi_head_attention(torch.from_numpy(x), tp, h, 2, hd, rope_theta=10000.0,
                                       blockwise_threshold=LONG)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=2e-5)
    assert tatt.BLOCKWISE_THRESHOLD == 2048


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-76b"])
def test_long_prefill_equals_reference(arch, monkeypatch):
    """A 2100-position prompt (for the VLM: 2048 vision tokens, then 52 text
    tokens) through both packages' prefill: last-position logits and the
    cache fill agree at the bf16 tolerance, and the port's blockwise path
    agrees with its direct path (the module threshold raised above the
    prompt) at the same tolerance."""
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    rng = np.random.default_rng(2)
    n_front = 2048 if tcfg.d_frontend else 0
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (1, LONG - n_front))}
    if n_front:
        batch["frontend"] = rng.normal(0, 1, (1, n_front, tcfg.d_frontend)).astype(np.float32)
    jlast, jcache = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, LONG + 8)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlast, tcache = tm.prefill(tp, tb, LONG + 8)
    assert tcache["length"] == LONG
    np.testing.assert_allclose(tlast.float().numpy(), np.asarray(jlast, np.float32), **BF16_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:, :, :LONG].float().numpy(),
                                   np.asarray(jcache[key][:, :, :LONG], np.float32), **BF16_TOL)
    monkeypatch.setattr(tatt, "BLOCKWISE_THRESHOLD", LONG)
    dlast, _ = tm.prefill(tp, tb, LONG + 8)
    np.testing.assert_allclose(tlast.float().numpy(), dlast.float().numpy(), **BF16_TOL)
