"""The hybrid (Zamba2), recurrent (xLSTM) and audio (Whisper) families
served by the port's ``ServeEngine`` against the reference's, on the CPU at
their ``--reduced`` configs: ``chunk`` and ``dense_free``, single stream
(prefill, then the fused decode loop). Their decode reaches no
sparsification site, so a step carries the family's I/O figure (0) and the
prefill is charged the dense I/O of the config's site geometry, in both
packages. Then the refusals (``wbits=8`` and corruption injection, which the
reference fails on with ``KeyError: 'layers'``; paged KV with the
reference's message; slot mode; frames) and the CLIs.

Tolerances: both packages run in f32 (``COMPUTE_DTYPE`` set in each),
where greedy tokens are equal; ``io_summary`` and every step's stats go
through the same simulator and compute model on the same seed, rtol 1e-6
(the estimates are f32 sums); ``select_overhead_s`` is a wall-clock time
and is never compared.
"""
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
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape as TShape
from repro_torch.launch import serve as tserve
from repro_torch.launch import video_stream as tvideo
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.models.inputs import make_dummy_batch as tbatch
from repro_torch.serving import IO_SUMMARY_KEYS
from repro_torch.serving import ServeEngine as TEngine
from torch_threads import one_thread  # noqa: F401

ARCHS = ("zamba2-7b", "xlstm-125m", "whisper-small")
METHODS = ("chunk", "dense_free")
N_DECODE, MAX_SEQ = 6, 32
WALL_KEYS = ("select_overhead_s",)
STAT_FIELDS = ("kind", "tokens", "io_est_s", "io_sim_s", "hit_rows", "miss_rows", "nbytes",
               "compute_s", "serial_s", "overlap_s", "stall_s", "bubble_s")


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(TM, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """The reference's engines at f32 on the reduced config, ``chunk`` and
    ``dense_free``: the greedy tokens, ``io_summary`` and every step's
    stats, and the params carried across."""
    arch = request.param
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jm = jbuild(jcfg)
    old = JM.COMPUTE_DTYPE
    JM.COMPUTE_DTYPE = jnp.float32
    try:
        jp = jax.jit(jm.init)(jax.random.key(0))
        jb = jbatch(jcfg, JShape("t", 12, 2, "train"))
        ref = {}
        for method in METHODS:
            eng = JEngine(jm, jp, max_seq=MAX_SEQ, batch_size=2, method=method, seed=3)
            last = eng.prefill(jb)
            out = eng.decode(jnp.argmax(last, -1)[:, None].astype(jnp.int32), N_DECODE)
            ref[method] = (np.asarray(out), eng.io_summary(),
                           [tuple(getattr(s, f) for f in STAT_FIELDS) for s in eng.stats])
    finally:
        JM.COMPUTE_DTYPE = old
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jm=jm, jp=jp,
                tp=params_from_reference(jax.device_get(jp), tcfg, "cpu"),
                tb=tbatch(tcfg, TShape("t", 12, 2, "train"), device="cpu"), ref=ref)


def _serve(served, method, **kw):
    eng = TEngine(tbuild(served["tcfg"]), served["tp"], max_seq=MAX_SEQ, batch_size=2,
                  method=method, seed=3, torch_device="cpu", **kw)
    last = eng.prefill(served["tb"])
    return eng, last


@pytest.mark.parametrize("method", METHODS)
def test_engine_tokens_and_io_summary_equal_reference(served, method, f32):
    """Greedy tokens equal; ``io_summary`` has the reference's keys in its
    order and its values (the prefill's dense I/O and bytes, zero decode
    I/O, the compute lane's seconds); every step's stats too."""
    eng, last = _serve(served, method)
    out = eng.decode(torch.argmax(last, dim=-1)[:, None], N_DECODE)
    jout, jio, jstats = served["ref"][method]
    np.testing.assert_array_equal(out.numpy(), jout)
    io = eng.io_summary()
    assert tuple(io) == IO_SUMMARY_KEYS == tuple(jio)
    for key in IO_SUMMARY_KEYS:
        if key not in WALL_KEYS:
            assert io[key] == pytest.approx(float(jio[key]), rel=1e-6, abs=1e-12), key
    stats = [tuple(getattr(s, f) for f in STAT_FIELDS) for s in eng.stats]
    assert len(stats) == len(jstats) == 1 + N_DECODE
    for got, want in zip(stats, jstats):
        assert got[:2] == want[:2]
        np.testing.assert_allclose(got[2:], np.asarray(want[2:], np.float64), rtol=1e-6,
                                   atol=1e-12)
    dec = [s for s in eng.stats if s.kind == "decode"]
    assert all(s.io_est_s == 0.0 and s.nbytes == 0.0 for s in dec)
    assert (eng.stats[0].io_est_s > 0) == (method == "chunk")


def test_decode_per_token_equals_fused_decode(served, f32):
    """The per-token loop and the fused loop give the same tokens and the
    same accounting (select overheads aside)."""
    a, last_a = _serve(served, "chunk")
    b, last_b = _serve(served, "chunk")
    tok = torch.argmax(last_a, dim=-1)[:, None]
    assert torch.equal(a.decode(tok, 3), b.decode_per_token(tok, 3))
    for key in IO_SUMMARY_KEYS:
        if key not in WALL_KEYS:
            assert a.io_summary()[key] == pytest.approx(b.io_summary()[key], rel=1e-12), key


def test_engine_refusals(served):
    """wbits 8 and corruption injection are refused with the family's name
    (the reference fails there with ``KeyError: 'layers'``, recorded as a
    quirk), paged KV with the reference's message, slot mode and frames as
    the model refuses them; ``dense_free`` ignores wbits, as in the
    reference."""
    tm, tp, family = tbuild(served["tcfg"]), served["tp"], served["tcfg"].arch_type
    kw = dict(max_seq=MAX_SEQ, batch_size=2, torch_device="cpu")
    for bad in ({"wbits": 8}, {"corruption_profile": "bit_rot"}):
        with pytest.raises(ValueError, match=family):
            TEngine(tm, tp, method="chunk", **kw, **bad)
        with pytest.raises(KeyError, match="layers"):
            JEngine(served["jm"], served["jp"], max_seq=MAX_SEQ, batch_size=2, method="chunk",
                    **bad)
    TEngine(tm, tp, method="dense_free", wbits=8, **kw)  # nothing streams, nothing packed
    with pytest.raises(ValueError, match=r"decoder families \(dense/moe/vlm\), not"):
        TEngine(tm, tp, kv_page_tokens=8, **kw)
    eng = TEngine(tm, tp, **kw)
    with pytest.raises(NotImplementedError, match="slot mode"):
        eng.enable_slots()
    with pytest.raises(NotImplementedError, match="append_frame"):
        eng.append_frame(torch.zeros((2, 4, served["tcfg"].d_frontend or 8)))


def test_cli_serves_the_family(served, capsys):
    """``--arch`` through the port's CLI on the CPU: a Whisper prompt
    carries its encoder's frames and takes no frame append."""
    arch, tcfg = served["arch"], served["tcfg"]
    eng, out = tserve.main(["--arch", arch, "--reduced", "--torch-device", "cpu",
                            "--decode-tokens", "3", "--max-seq", "48", "--prompt-len", "8"])
    text = capsys.readouterr().out
    assert "[total] method=chunk" in text and "[frame" not in text
    assert out.shape == (2, 4) and eng.model.family == tcfg.arch_type
    assert eng.cache["length"] == 8 + 3
    if tcfg.is_encdec:
        assert eng.cache["enc_k"].shape[2] == tcfg.frontend_tokens
    with pytest.raises(ValueError, match=tcfg.arch_type):
        tserve.main(["--arch", arch, "--reduced", "--torch-device", "cpu", "--wbits", "8"])


def test_video_stream_refuses_the_family(served):
    with pytest.raises(SystemExit):
        tvideo.main(["--arch", served["arch"], "--torch-device", "cpu"])
