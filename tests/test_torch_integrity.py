"""Chunk integrity in the port against the JAX reference (``tests/
test_integrity.py``'s counterparts), on the CPU at ``tinyllama-1.1b
--reduced``: the pack-time checksum lane, the corruption model, the
integrity ladder of the batched refresh, the engine with recovery on and
off, and K1/K2's checksum lanes.

Tolerances: checksum words, masks, tables, counts and tokens are compared
exactly. The two frameworks draw corruption from different generators (the
reference from ``jax.random`` keys, the port from a counter-based hash), so
parity feeds the reference's drawn uniforms and (element, bit) draws into
the port's model (``RefDraws``). The re-read seconds are f32 sums over
blocks taken in another order: rtol 1e-6. The latency estimates are f32
sums of the same terms in another order: rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.faults import CORRUPTION_PROFILES as J_PROFILES
from repro.core.faults import CorruptionModel as JCorruption
from repro.core.faults import corruption_key
from repro.core.offload import pack_checksums as j_pack
from repro.kernels.quantize import block_checksums as j_ck
from repro.kernels.quantize import quantize_params as j_quant_params
from repro.models import build_model as jbuild
from repro.serving import ServeEngine as JEngine
from repro.serving.sparse_exec import SparseExecution as JSparse
from repro_torch.configs import get_config as tget
from repro_torch.core import faults as tf
from repro_torch.core.offload import pack_checksums as t_pack
from repro_torch.kernels import chunk_gather_dma as tk
from repro_torch.kernels import quantize as tq
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.serving import ServeEngine as TEngine
from repro_torch.serving.sparse_exec import (
    INTEGRITY_COUNTER_KEYS,
    SparseExecution as TSparse,
)

COUNTER_KEYS = ("corruptions_detected", "corruptions_recovered", "corruptions_substituted",
                "corruptions_dropped", "integrity_reread_s")
DTYPES = {"int8": (jnp.int8, torch.int8), "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16), "f32": (jnp.float32, torch.float32)}


def _payload(rng, shape, dtype):
    """The same stored payload in both packages."""
    jd, td = DTYPES[dtype]
    if dtype == "int8":
        a = rng.integers(-127, 128, shape).astype(np.int8)
        return jnp.asarray(a), torch.from_numpy(a)
    a = rng.normal(0, 1, shape).astype(np.float32)
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _u32(t):
    return t.numpy().view(np.uint32)


class RefDraws(tf.CorruptionModel):
    """The port's corruption model drawing the reference's numbers: each
    (stream, layer, epoch, site, matrix) looks up the array the reference
    draws from ``corruption_key`` (uniforms of streams 0 and 1, element
    and bit integers of streams 2 and 3)."""

    def __init__(self, profile, seed, max_reread=2, recover=True, widths=None):
        super().__init__(profile, seed=seed, max_reread=max_reread, recover=recover)
        self.ref = JCorruption(profile, seed=seed, max_reread=max_reread, recover=recover)
        self.widths = widths  # {(site, matrix): (n_blocks, cols, itemsize)}
        self._memo = {}

    def _array(self, stream, layer, epoch, site, matrix):
        k = (stream, layer, epoch, site, matrix)
        if k not in self._memo:
            nb, d, item = self.widths[(site, matrix)]
            key = corruption_key(self.ref.base_key(), jnp.int32(layer), jnp.int32(epoch),
                                 site, matrix)
            sub = jax.random.fold_in(key, stream)
            if stream == tf.STREAM_BLOCKS:
                a = jax.random.uniform(sub, (nb,))
            elif stream == tf.STREAM_REREADS:
                a = jax.random.uniform(sub, (nb,), minval=jnp.float32(1e-12))
            elif stream == tf.STREAM_ELEM:
                a = jax.random.randint(sub, (nb,), 0, 8 * d)
            else:
                a = jax.random.randint(sub, (nb,), 0, item * 8)
            self._memo[k] = np.asarray(a)
        return self._memo[k]

    def _lookup(self, stream, layer, epoch, site, matrix, index):
        args = torch.broadcast_tensors(*(torch.as_tensor(a) for a in (layer, epoch, site,
                                                                       matrix, index)))
        nbs = {k: v[0] for k, v in self.widths.items()}
        vals = [self._array(stream, lv, e, s, m)[i] if i < nbs[(s, m)] else 0.0
                for lv, e, s, m, i in zip(*(a.reshape(-1).tolist() for a in args))]
        return torch.as_tensor(np.asarray(vals)).reshape(args[0].shape)

    def uniforms(self, stream, layer, epoch, site, matrix, index):
        return self._lookup(stream, layer, epoch, site, matrix, index).to(torch.float32)

    def integers(self, stream, layer, epoch, site, matrix, index, high):
        return self._lookup(stream, layer, epoch, site, matrix, index).to(torch.int64)


def _widths(cfg, wbits):
    item = 1 if wbits == 8 else 2
    d, hd, kv, f = (cfg.d_model, cfg.n_heads * cfg.resolved_head_dim,
                    cfg.n_kv_heads * cfg.resolved_head_dim, cfg.d_ff)
    return {(0, 0): (d // 8, hd, item), (0, 1): (d // 8, kv, item), (0, 2): (d // 8, kv, item),
            (1, 0): (hd // 8, d, item), (2, 0): (d // 8, f, item), (2, 1): (d // 8, f, item),
            (3, 0): (f // 8, d, item)}


# ---------------------------------------------------------------------------
# the pack-time checksum lane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_checksums_equal_reference_words(dtype):
    rng = np.random.default_rng(len(dtype))
    jw, tw = _payload(rng, (96, 40), dtype)
    got = tq.block_checksums(tw)
    assert got.dtype == torch.int32 and got.shape == (12,)
    np.testing.assert_array_equal(_u32(got), np.asarray(j_ck(jw)))
    # leading (layer) axes are carried, and the chunked pass changes nothing
    stacked = torch.stack([tw, tw.flip(0)])
    np.testing.assert_array_equal(_u32(tq.block_checksums(stacked)[1]),
                                  np.asarray(j_ck(jnp.flip(jw, 0))))


def test_block_checksums_span_chunks_and_wide_rows():
    """More blocks than one pass takes, rows wider than a 16-bit weight:
    the words stay the reference's (no int64 overflow)."""
    rng = np.random.default_rng(5)
    jw, tw = _payload(rng, (8 * (tq._CK_CHUNK_BLOCKS + 3), 1000), "f32")
    np.testing.assert_array_equal(_u32(tq.block_checksums(tw)), np.asarray(j_ck(jw)))


def test_checksum_detects_single_bit_and_reordering():
    rng = np.random.default_rng(3)
    _, tw = _payload(rng, (16, 32), "bf16")
    ck = tq.block_checksums(tw)
    flipped = tw.clone().reshape(-1)
    flipped[37] = tf.flip_bits(flipped[37:38], torch.tensor([5]))[0]
    got = tq.block_checksums(flipped.reshape(16, 32))
    assert got[0] != ck[0] and got[1] == ck[1]
    swapped = tw.clone()
    swapped[[8, 9]] = swapped[[9, 8]]
    assert tq.block_checksums(swapped)[1] != ck[1] or torch.equal(tw[8], tw[9])
    with pytest.raises(ValueError):
        tq.block_checksums(torch.zeros(12, 4))


@pytest.mark.parametrize("wbits", [8, 16])
def test_packed_checksum_leaves_equal_reference(wbits):
    """``quantize_params(checksums=True)`` over the int8 payload (wbits 8)
    and ``pack_checksums`` over the bf16 leaves (wbits 16): the reference's
    ``_ck`` leaves, word for word."""
    rng = np.random.default_rng(wbits)
    w = rng.normal(0, 1, (2, 64, 48)).astype(np.float32)
    jl = {"wq": jnp.asarray(w, jnp.bfloat16), "other": jnp.zeros(3)}
    tl = {"wq": torch.from_numpy(np.asarray(jl["wq"].astype(jnp.float32))).to(torch.bfloat16),
          "other": torch.zeros(3)}
    if wbits == 8:
        jo = j_quant_params(jl, ("wq", "absent"), checksums=True)
        to = tq.quantize_params(tl, ("wq", "absent"), checksums=True)
        np.testing.assert_array_equal(to["wq_q8"].numpy(), np.asarray(jo["wq_q8"]))
        assert "wq_ck" not in tq.quantize_params(tl, ("wq",))
    else:
        jo, to = j_pack(jl, ("wq", "absent")), t_pack(tl, ("wq", "absent"))
    assert set(to) == set(jo)
    np.testing.assert_array_equal(_u32(to["wq_ck"]), np.asarray(jo["wq_ck"]))


# ---------------------------------------------------------------------------
# the corruption model, fed the reference's draws
# ---------------------------------------------------------------------------


def test_corruption_profiles_and_validation():
    assert set(tf.CORRUPTION_PROFILES) == set(J_PROFILES)
    for name, p in tf.CORRUPTION_PROFILES.items():
        jp = J_PROFILES[name]
        assert (p.p_block, p.mode, p.p_stuck, p.backoff_base_s, p.backoff_mult) == \
            (jp.p_block, jp.mode, jp.p_stuck, jp.backoff_base_s, jp.backoff_mult)
    for kw in (dict(p_block=1.0), dict(mode="melt"), dict(p_stuck=-0.1),
               dict(backoff_mult=0.5)):
        with pytest.raises(ValueError):
            tf.CorruptionProfile("x", **kw)
    with pytest.raises(ValueError):
        tf.CorruptionModel("bit_rot", max_reread=-1)
    with pytest.raises(KeyError):
        tf.get_corruption_profile("melted")
    assert not tf.CorruptionModel("none").enabled and tf.CorruptionModel("torn_read").enabled


@pytest.mark.parametrize("profile", ["bit_rot", "torn_read", "degraded_nand"])
def test_draws_to_outcomes_equal_reference(profile):
    """draw_blocks, draw_rereads (recovery on / off / budget 0) and
    backoff_seconds on the reference's drawn uniforms: the same outcomes."""
    nb = 4096
    fetched = np.random.default_rng(1).random(nb) < 0.7
    for max_reread, recover in ((2, True), (1, True), (0, True), (2, False)):
        jcm = JCorruption(profile, seed=9, max_reread=max_reread, recover=recover)
        tcm = tf.CorruptionModel(profile, seed=9, max_reread=max_reread, recover=recover)
        key = corruption_key(jcm.base_key(), jnp.int32(3), jnp.int32(2), 1, 0)
        jc = jcm.draw_blocks(key, jnp.asarray(fetched))
        u0 = torch.from_numpy(np.asarray(jax.random.uniform(jax.random.fold_in(key, 0), (nb,))))
        tc = tcm.draw_blocks(torch.from_numpy(fetched), u0)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert tc.sum() > 0
        jr, jrec = jcm.draw_rereads(key, jc)
        u1 = torch.from_numpy(np.asarray(jax.random.uniform(
            jax.random.fold_in(key, 1), (nb,), minval=jnp.float32(1e-12))))
        tr, trec = tcm.draw_rereads(tc, u1)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(trec.numpy(), np.asarray(jrec))
        np.testing.assert_array_equal(tcm.backoff_seconds(tr).numpy(),
                                      np.asarray(jcm.backoff_seconds(jr)))


@pytest.mark.parametrize("mode_profile", ["bit_rot", "torn_read"])
@pytest.mark.parametrize("dtype", ["int8", "bf16", "f16", "f32"])
def test_corrupt_payload_equal_reference(mode_profile, dtype):
    """The flip (one bit of one element per corrupt block) and the zeroed
    block, on the reference's element and bit draws: the same bytes."""
    rng = np.random.default_rng(7)
    jw, tw = _payload(rng, (64, 24), dtype)
    corrupt = rng.random(8) < 0.5
    jcm, tcm = JCorruption(mode_profile, seed=2), tf.CorruptionModel(mode_profile, seed=2)
    key = corruption_key(jcm.base_key(), jnp.int32(0), jnp.int32(1), 2, 1)
    want = np.asarray(jcm.corrupt_payload(jw, jnp.asarray(corrupt), key))
    elem = torch.from_numpy(np.asarray(jax.random.randint(jax.random.fold_in(key, 2), (8,),
                                                          0, 8 * 24))).to(torch.int64)
    bit = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.fold_in(key, 3), (8,), 0, tw.element_size() * 8))).to(torch.int64)
    got = tcm.corrupt_payload(tw, torch.from_numpy(corrupt), elem, bit)
    as_int = {1: torch.int8, 2: torch.int16, 4: torch.int32}[tw.element_size()]
    np.testing.assert_array_equal(got.view(as_int).numpy(),
                                  want.view({1: np.int8, 2: np.int16, 4: np.int32}[
                                      tw.element_size()]))
    changed = (got.view(as_int) != tw.view(as_int)).reshape(8, -1).sum(1)
    if mode_profile == "bit_rot":
        assert changed.tolist() == corrupt.astype(int).tolist()


def test_hash_draws_are_pure_and_broadcast():
    """The counter-based draws: a function of (seed, layer, epoch, site,
    matrix, stream, index) only — all layers at once equal layer by layer,
    in (0, 1), distinct across streams, seeds and epochs."""
    cm = tf.CorruptionModel("bit_rot", seed=11)
    idx = torch.arange(500)
    lay, ep = torch.tensor([[0], [1], [5]]), torch.tensor([[2], [2], [7]])
    u = cm.uniforms(0, lay, ep, 1, 2, idx)
    for row, (lv, e) in enumerate(((0, 2), (1, 2), (5, 7))):
        assert torch.equal(u[row], cm.uniforms(0, lv, e, 1, 2, idx))
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.05
    assert not torch.equal(u[0], cm.uniforms(1, 0, 2, 1, 2, idx))
    assert not torch.equal(u[0], tf.CorruptionModel("bit_rot", seed=12).uniforms(0, 0, 2, 1, 2, idx))
    assert not torch.equal(u[0], u[1])
    ints = cm.integers(2, 3, 4, 0, 0, idx, 77)
    assert int(ints.min()) >= 0 and int(ints.max()) < 77
    big = tf.CorruptionModel("bit_rot", seed=2 ** 40 + 3).uniforms(0, 0, 1, 0, 0, idx)
    assert not torch.equal(big, tf.CorruptionModel("bit_rot", seed=3).uniforms(0, 0, 1, 0, 0, idx))


# ---------------------------------------------------------------------------
# the ladder of the batched refresh against the reference's refresh_layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    jcfg = jget("tinyllama-1.1b").reduced()
    tcfg = tget("tinyllama-1.1b").reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    return jcfg, tcfg, jm, tm, jp, tp


def _stacked_weights(jp, tp, wbits):
    """Both packages' per-site ((payload, checksums), ...) of the stacked
    layers, packed by each package from the same bf16 weights."""
    names = {"hidden_attn": ("wq", "wk", "wv"), "attn_out": ("wo",),
             "hidden_mlp": ("w_gate", "w_up"), "ffn": ("w_down",)}
    flat = [n for ns in names.values() for n in ns]
    jl, tl = jp["layers"], tp["layers"]
    if wbits == 8:
        jq, tq8 = j_quant_params(jl, flat, checksums=True), tq.quantize_params(tl, flat, checksums=True)
        jw = {n: (jq[n + "_q8"], jq[n + "_ck"]) for n in flat}
        tw = {n: (tq8[n + "_q8"], tq8[n + "_ck"]) for n in flat}
    else:
        jc, tc = j_pack(jl, flat), t_pack(tl, flat)
        jw = {n: (jl[n], jc[n + "_ck"]) for n in flat}
        tw = {n: (tl[n], tc[n + "_ck"]) for n in flat}
    return ({k: tuple(jw[n] for n in ns) for k, ns in names.items()},
            {k: tuple(tw[n] for n in ns) for k, ns in names.items()})


@pytest.mark.parametrize("profile,wbits,cache_mb", [
    ("bit_rot", 16, 0.0), ("torn_read", 8, 0.0), ("degraded_nand", 16, 0.0),
    ("degraded_nand", 8, 0.05),
])
def test_ladder_equals_reference_refresh_layer(lm, profile, wbits, cache_mb):
    """Three refreshes of every layer with the reference's draws, from
    seeded pending importances: the post-ladder masks, the kernel tables,
    the epoch and the six counters per (layer, site) equal the reference's
    ``refresh_layer``, and so does each layer's estimate."""
    jcfg, tcfg, _, _, jp, tp = lm
    rng = np.random.default_rng(wbits + int(cache_mb * 100))
    kw = dict(device="nano", sparsity=0.4, method="chunk", cache_mb=cache_mb, wbits=wbits,
              corruption_profile=profile, corruption_seed=4, max_reread=1)
    js = JSparse(jcfg, **kw)
    ts = TSparse(tcfg, torch_device="cpu", **kw)
    ts.corruption = RefDraws(profile, 4, max_reread=1, widths=_widths(tcfg, wbits))
    jw, tw = _stacked_weights(jp, tp, wbits)
    L = tcfg.n_layers
    jplan, tplan = js.init_plan(L), ts.init_plan(L)
    refresh_layer = jax.jit(js.refresh_layer)  # one trace of its lax.cond, not one a call
    for step in range(3):
        for kind, site in ts.sites.items():
            # dyadic importances: every sum and rank is exact in both packages
            v = rng.integers(0, 64, (L, site.n)).astype(np.float32) / 64.0
            tplan[kind]["pending"].copy_(torch.from_numpy(v))
            jplan[kind]["pending"] = jnp.asarray(v)
        tlat = ts.refresh_step(tplan, True, tw)
        jlat = []
        for layer in range(L):
            sl = {k: {kk: vv[layer] for kk, vv in e.items()} for k, e in jplan.items()}
            wl = {k: tuple((w[layer], c[layer]) for w, c in ws) for k, ws in jw.items()}
            new, lat = refresh_layer(sl, jnp.bool_(True), weights=wl)
            jlat.append(float(lat))
            for k in jplan:
                for kk in jplan[k]:
                    jplan[k][kk] = jplan[k][kk].at[layer].set(new[k][kk])
        np.testing.assert_allclose(tlat.numpy(), jlat, rtol=1e-6)
        for kind in ts.site_order:
            for key in ("mask", "kstarts", "ksizes", "epoch", "cdet", "crec", "csub", "cdrop",
                        "crr", "miss", "hit"):
                np.testing.assert_array_equal(tplan[kind][key].numpy(),
                                              np.asarray(jplan[kind][key]),
                                              err_msg=f"{kind} {key} step {step}")
            np.testing.assert_allclose(tplan[kind]["crr_s"].numpy(),
                                       np.asarray(jplan[kind]["crr_s"]), rtol=1e-6)
    total = {k: sum(float(tplan[s][k].sum()) for s in ts.site_order)
             for k in INTEGRITY_COUNTER_KEYS}
    assert total["cdet"] > 0
    if profile == "degraded_nand":
        assert total["csub"] + total["cdrop"] > 0


def test_recover_off_carries_the_drawn_blocks(lm):
    """Recovery off: the refresh counts detections, recovers nothing,
    keeps the drawn pattern (``cblk``) equal to the reference's and the
    damaged rows for the gathers."""
    jcfg, tcfg, _, _, jp, tp = lm
    kw = dict(device="nano", sparsity=0.4, method="chunk", wbits=16,
              corruption_profile="bit_rot", corruption_seed=7, corruption_recover=False)
    js, ts = JSparse(jcfg, **kw), TSparse(tcfg, torch_device="cpu", **kw)
    ts.corruption = RefDraws("bit_rot", 7, recover=False, widths=_widths(tcfg, 16))
    jw, tw = _stacked_weights(jp, tp, 16)
    jplan, tplan = js.init_plan(tcfg.n_layers), ts.init_plan(tcfg.n_layers)
    ts.refresh_step(tplan, True, tw)
    refresh_layer = jax.jit(js.refresh_layer)
    for layer in range(tcfg.n_layers):
        sl = {k: {kk: vv[layer] for kk, vv in e.items()} for k, e in jplan.items()}
        wl = {k: tuple((w[layer], c[layer]) for w, c in ws) for k, ws in jw.items()}
        new, _ = refresh_layer(sl, jnp.bool_(True), weights=wl)
        for kind in ts.site_order:
            np.testing.assert_array_equal(tplan[kind]["cblk"][layer].numpy(),
                                          np.asarray(new[kind]["cblk"]))
            assert float(tplan[kind]["crec"][layer]) == float(new[kind]["crec"]) == 0.0
            assert float(tplan[kind]["cdet"][layer]) == float(new[kind]["cdet"])
    # the damaged rows patch exactly the reference's corrupt_payload
    stacked = {n: tp["layers"][n] for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
    clean = {n: w.clone() for n, w in stacked.items()}
    names = {"hidden_attn": ("wq", "wk", "wv"), "attn_out": ("wo",),
             "hidden_mlp": ("w_gate", "w_up"), "ffn": ("w_down",)}
    undo = ts.apply_corruption(tplan, stacked, names)
    assert undo
    for i, kind in enumerate(ts.site_order):
        for mi, nm in enumerate(names[kind]):
            for layer in range(tcfg.n_layers):
                key = corruption_key(js.corruption.base_key(), jnp.int32(layer), jnp.int32(1),
                                     i, mi)
                want = js.corruption.corrupt_payload(
                    jp["layers"][nm][layer], jnp.asarray(tplan[kind]["cblk"][layer, mi].numpy()),
                    key)
                np.testing.assert_array_equal(
                    stacked[nm][layer].view(torch.int16).numpy(),
                    np.asarray(want).view(np.int16))
    ts.restore_payloads(undo)
    assert all(torch.equal(stacked[n], clean[n]) for n in stacked)


def test_sparse_execution_refusals(lm):
    _, tcfg, *_ = lm
    from repro_torch.core.reorder import hot_cold_reordering

    with pytest.raises(ValueError, match="selecting method"):
        TSparse(tcfg, method="dense", corruption_profile="bit_rot", torch_device="cpu")
    reo = {"hidden_attn": hot_cold_reordering(np.arange(tcfg.d_model, dtype=np.float32))}
    with pytest.raises(ValueError, match="reorderings"):
        TSparse(tcfg, reorderings=reo, corruption_profile="bit_rot", torch_device="cpu")
    # a profile that never corrupts is no corruption at all
    assert TSparse(tcfg, method="dense", corruption_profile="none",
                   torch_device="cpu").corruption is None
    ts = TSparse(tcfg, corruption_profile="bit_rot", torch_device="cpu")
    plan = ts.init_plan(tcfg.n_layers)
    with pytest.raises(ValueError, match="no weights"):
        ts.refresh_step(plan, True)
    with pytest.raises(ValueError, match="streams 3 matrices"):
        ts.refresh_step(plan, True, {k: () for k in plan})


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _engine(cls, model, params, **kw):
    kw.setdefault("method", "chunk")
    if cls is TEngine:
        kw.setdefault("torch_device", "cpu")
    return cls(model, params, max_seq=64, batch_size=2, device="nano", sparsity=0.4, seed=1,
               **kw)


def _tok0(cls):
    return jnp.ones((2, 1), jnp.int32) if cls is JEngine else torch.ones((2, 1),
                                                                          dtype=torch.int64)


def _counters(eng):
    s = eng.io_summary()
    return {k: s[k] for k in COUNTER_KEYS}


@pytest.mark.parametrize("backend,wbits", [("reference", 16), ("kernel", 8), ("kernel", 16)])
def test_engine_recovered_corruption_byte_identity(lm, backend, wbits):
    """bit_rot (every corruption recoverable) with recovery: the tokens of
    the corruption-off run, detected == recovered > 0, nothing substituted
    or dropped, and the re-reads reached the simulated I/O."""
    *_, tm, _, tp = lm
    base = _engine(TEngine, tm, tp, backend=backend, wbits=wbits)
    t_base = base.decode(_tok0(TEngine), 6)
    eng = _engine(TEngine, tm, tp, backend=backend, wbits=wbits,
                  corruption_profile="bit_rot", corruption_seed=7)
    t = eng.decode(_tok0(TEngine), 6)
    assert torch.equal(t, t_base)
    c = _counters(eng)
    assert c["corruptions_detected"] > 0
    assert c["corruptions_detected"] == c["corruptions_recovered"]
    assert c["corruptions_substituted"] == 0 == c["corruptions_dropped"]
    assert c["integrity_reread_s"] > 0.0
    assert eng.io_summary()["io_sim_s"] > base.io_summary()["io_sim_s"]
    assert all(v == 0.0 for v in _counters(base).values())
    assert sum(e.integrity_s for e in eng.simulator.log) == pytest.approx(
        c["integrity_reread_s"], rel=1e-6)


def test_engine_no_recover_equals_reference_on_its_draws(lm):
    """Recovery off, the reference backend at wbits 16, the port fed the
    reference's draws: step by step, the reference engine's corrupted
    tokens, its drawn blocks and its counters (the kernel-8 case of the
    reference suite is one of its jax 0.9 failures, so the twin is the
    yardstick). Each step's selection reads the importances the reference
    recorded: the frameworks' bf16 activations differ in their last bits,
    and a selection near a tie on them would tip apart for that reason
    alone (ROADMAP.md queue 3)."""
    _, tcfg, jm, tm, jp, tp = lm
    kw = dict(backend="reference", wbits=16, corruption_profile="bit_rot",
              corruption_seed=7, recover=False)
    jeng, teng = _engine(JEngine, jm, jp, **kw), _engine(TEngine, tm, tp, **kw)
    teng.sparse_ctx.corruption = teng.corruption = RefDraws(
        "bit_rot", 7, recover=False, widths=_widths(tcfg, 16))
    clean = _engine(TEngine, tm, tp, backend="reference", wbits=16)
    jt, tt, ct = _tok0(JEngine), _tok0(TEngine), _tok0(TEngine)
    tokens, clean_tokens = [], []
    for step in range(6):
        if step:
            for kind, entry in teng._plan.items():
                entry["pending"].copy_(torch.from_numpy(np.array(jeng._plan[kind]["pending"])))
        jt = jnp.asarray(np.asarray(jeng.decode_per_token(jt, 1))[:, -1:])
        tt = teng.decode_per_token(tt, 1)[:, -1:]
        ct = clean.decode_per_token(ct, 1)[:, -1:]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=f"step {step}")
        for kind, entry in teng._plan.items():
            np.testing.assert_array_equal(entry["cblk"].numpy(),
                                          np.asarray(jeng._plan[kind]["cblk"]))
        tokens.append(tt)
        clean_tokens.append(ct)
    assert not torch.equal(torch.cat(tokens, 1), torch.cat(clean_tokens, 1))
    tc, jc = _counters(teng), _counters(jeng)
    assert tc["corruptions_detected"] == jc["corruptions_detected"] > 0
    assert tc == jc
    # the payloads are clean again after every step
    assert all(torch.equal(tp["layers"][n], teng.params["layers"][n]) for n in ("wq", "w_down"))


@pytest.mark.parametrize("profile", ["bit_rot", "degraded_nand"])
def test_engine_corrupted_runs_replay_and_agree_across_backends(lm, profile):
    """Recovery off (bit_rot) and the full ladder (degraded_nand): two runs
    replay token for token and counter for counter, and the kernel backend
    (K1/K2's plain versions on the CPU) gives the reference backend's
    tokens, corrupted or substituted."""
    *_, tm, _, tp = lm
    kw = (dict(corruption_profile="bit_rot", corruption_seed=7, recover=False)
          if profile == "bit_rot" else
          dict(corruption_profile="degraded_nand", corruption_seed=3, max_reread=1))

    def run(backend):
        e = _engine(TEngine, tm, tp, backend=backend, **kw)
        return e.decode(_tok0(TEngine), 5), _counters(e)

    t1, c1 = run("reference")
    t2, c2 = run("reference")
    tk_, ck_ = run("kernel")
    assert torch.equal(t1, t2) and c1 == c2
    assert torch.equal(t1, tk_) and c1 == ck_
    if profile == "degraded_nand":
        assert c1["corruptions_detected"] > c1["corruptions_recovered"] > 0
        assert c1["corruptions_substituted"] > 0
        assert (c1["corruptions_substituted"] + c1["corruptions_dropped"]
                <= 8 * (c1["corruptions_detected"] - c1["corruptions_recovered"]))
    else:
        assert c1["corruptions_recovered"] == 0 == c1["integrity_reread_s"]


def test_engine_per_token_matches_fused(lm):
    *_, tm, _, tp = lm

    def run(per_token):
        e = _engine(TEngine, tm, tp, corruption_profile="bit_rot", corruption_seed=7)
        fn = e.decode_per_token if per_token else e.decode
        return fn(_tok0(TEngine), 5), _counters(e)

    (ta, ca), (tb, cb) = run(False), run(True)
    assert torch.equal(ta, tb)
    assert ca == cb


def test_engine_corruption_feeds_degradation_controller(lm):
    """Sustained corruption is the controller's second signal: a high-rate
    profile tightens the budget even on a clean latency stream."""
    from repro_torch.serving.degrade import DegradationController

    *_, tm, _, tp = lm
    e = _engine(TEngine, tm, tp, corruption_profile="degraded_nand", corruption_seed=3,
                degrade=True)
    e.degrade_controller = DegradationController(corruption_ratio_gain=200.0)
    e.simulator.noise = 0.0
    for _ in range(6):
        e.decode(_tok0(TEngine), 3)
    assert e.fault_summary()["degrade_scale"] < 1.0


def test_engine_corruption_refusals(lm):
    *_, tm, _, tp = lm
    with pytest.raises(ValueError, match="offloaded data plane"):
        _engine(TEngine, tm, tp, method="dense_free", corruption_profile="bit_rot")
    with pytest.raises(ValueError, match="selecting method"):
        _engine(TEngine, tm, tp, method="dense", corruption_profile="bit_rot")
    with pytest.raises(ValueError, match="max_reread"):
        _engine(TEngine, tm, tp, corruption_profile="bit_rot", max_reread=-1)
    # dense_free with the inert profile is fine
    _engine(TEngine, tm, tp, method="dense_free", corruption_profile="none")


def test_cli_corruption_flags(capsys):
    eng, out = tserve.main(["--arch", "tinyllama-1.1b", "--reduced", "--torch-device", "cpu",
                            "--decode-tokens", "3", "--max-seq", "48", "--prompt-len", "8",
                            "--corruption-profile", "degraded_nand", "--corruption-seed", "3",
                            "--max-reread", "1", "--backend", "kernel"])
    text = capsys.readouterr().out
    assert "[integrity] profile=degraded_nand seed=3 recover=True max_reread=1" in text
    assert eng.corruption is not None and eng.corruption.max_reread == 1
    args = tserve.parse_args(["--corruption-profile", "bit_rot", "--no-recover"])
    assert args.recover is False
    for bad in (["--max-reread", "-1"], ["--corruption-seed", "3"],
                ["--corruption-profile", "melted"]):
        with pytest.raises(SystemExit):
            tserve.parse_args(bad)


# ---------------------------------------------------------------------------
# K1/K2's checksum lanes
# ---------------------------------------------------------------------------


def _mlp_case(rng, dtype):
    n, f, d = 64, 96, 48
    ws = []
    for shape in ((n, f), (n, f), (f, d)):
        w = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
        ws.append(tq.quantize_rows(w) if dtype == "int8" else (w.to(torch.bfloat16), None))
    x = torch.from_numpy(rng.normal(0, 1, (3, n)).astype(np.float32))
    masks = torch.from_numpy(rng.random((2, f)) < 0.5)
    masks[0, n:] = False
    st, sz = tk.masks_to_block_tables(masks, 8, 512)
    fm = masks[1].to(torch.float32)
    return ws, x, st, sz, fm


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_wrappers_take_and_check_checksum_lanes(dtype):
    """On the CPU the wrappers accept K1's lane and K2's three, check their
    shapes and word type, and give the output without them bit for bit."""
    rng = np.random.default_rng(17)
    ws, x, st, sz, fm = _mlp_case(rng, dtype)
    (wg, sg), (wu, su), (wd, sd) = ws
    cks = tuple(tq.block_checksums(w) for w in (wg, wu, wd))
    y0 = tk.chunk_gather_matmul_dma(wg, x, st[0, :8], sz[0, :8], sg)
    y1 = tk.chunk_gather_matmul_dma(wg, x, st[0, :8], sz[0, :8], sg, cks[0])
    assert torch.equal(y0, y1)
    scales = None if sg is None else (sg, su, sd)
    a = tk.chunk_gather_mlp_dma(wg, wu, wd, x, st, sz, fm, scales, return_h=True)
    b = tk.chunk_gather_mlp_dma(wg, wu, wd, x, st, sz, fm, scales, cks, return_h=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="checksums"):
        tk.chunk_gather_matmul_dma(wg, x, st[0, :8], sz[0, :8], sg, cks[0][:-1])
    with pytest.raises(ValueError, match="int32"):
        tk.chunk_gather_matmul_dma(wg, x, st[0, :8], sz[0, :8], sg, cks[0].to(torch.int64))
    with pytest.raises(ValueError, match="down checksums"):
        tk.chunk_gather_mlp_dma(wg, wu, wd, x, st, sz, fm, scales, (cks[0], cks[1], cks[0]))


def test_lane_smem_layout_and_geometry():
    """The lane adds one 16-byte-padded word region per stream and stage,
    and leaves the geometry of a lane-free build as it was."""
    for nmat, elem in ((1, 2), (2, 2), (2, 1)):
        for depth in (0, 1, 3):
            g0 = tk.k1_geometry(28672 if nmat == 2 else 8192, 2, elem, 132, depth, 8192,
                                nmat=nmat)
            g1 = tk.k1_geometry(28672 if nmat == 2 else 8192, 2, elem, 132, depth, 8192,
                                nmat=nmat, ck=True)
            assert g0 == g1
            a = tk.k1_smem_bytes(3584, elem, g0["tile"], g0["blocks"], 2, depth, 8192,
                                 nmat=nmat)
            b = tk.k1_smem_bytes(3584, elem, g0["tile"], g0["blocks"], 2, depth, 8192,
                                 nmat=nmat, ck=True)
            assert b - a == (depth + 1) * nmat * (-(-g0["blocks"] * 4 // 16) * 16)
            assert b <= tk.SMEM_LIMIT_BYTES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(python3 chip_smoke.py runs them at full width)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("depth", (0, 1, 3))
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_kernel_lanes_bitwise_equal_on_the_card(cuda, depth, dtype):
    rng = np.random.default_rng(30 + depth)
    ws, x, st, sz, fm = _mlp_case(rng, dtype)
    ws = [(w.to(cuda), None if s is None else s.to(cuda)) for w, s in ws]
    (wg, sg), (wu, su), (wd, sd) = ws
    x, st, sz, fm = (t.to(cuda) for t in (x, st, sz, fm))
    cks = tuple(tq.block_checksums(w) for w in (wg, wu, wd))
    scales = None if sg is None else (sg, su, sd)
    kw = dict(prefetch_depth=depth, return_h=True)
    a = tk.chunk_gather_mlp_dma(wg, wu, wd, x, st, sz, fm, scales, **kw)
    b = tk.chunk_gather_mlp_dma(wg, wu, wd, x, st, sz, fm, scales, cks, **kw)
    plain = tk.chunk_gather_mlp_plain(wg, wu, wd, x, st, sz, fm, scales)
    assert all(torch.equal(p, q) and torch.equal(p, r) for p, q, r in zip(a, b, plain))
    y = tk.chunk_gather_matmul_dma(wg, x, st[0, :8], sz[0, :8], sg, cks[0],
                                   prefetch_depth=depth)
    assert torch.equal(y, tk.chunk_gather_matmul_plain(wg, x, st[0, :8], sz[0, :8], sg))
