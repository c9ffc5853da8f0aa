"""xLSTM's chunked, checkpointed scans (``repro_torch.models.scan``,
``models/xlstm.py``): the chunking changes no value, a decode step is one
step, the scans still agree with the reference's chunked ones, and the
dry run's one-chunk count equals a trace of every step.

  * the mLSTM and sLSTM blocks at chunk 64 (s = 1, 63, 64, 150, 256) and
    at chunk 16 (s = 150) against the same block whose one chunk is as
    long as the sequence, from a random non-zero state, f32 and bf16
    inputs: outputs, final states and the gradients of the input, every
    param and every initial state leaf are bitwise equal;
  * the reference's chunked scans at chunk 8 over 21 steps (two chunks
    and a tail the reference pads), within ``tests/test_torch_ssm.py``'s
    tolerances (f32 1e-5; bf16 4e-2);
  * a decode step of reduced xLSTM-125M runs one recurrence step a block;
  * the dry run of reduced xLSTM-125M's train step over 256 positions
    (four chunks) on a fake 2×2 mesh, counting one chunk for all against
    tracing every step (two subprocesses: a dry run takes its process's
    one default process group): FLOPs, bytes, collective counts and bytes
    exactly equal, the peak within 2 %.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jx
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import xlstm as tx
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_xlstm_chunk_worker.py")
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=4e-2, rtol=4e-2)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
BLOCKS = {"mlstm": (tx.mlstm_param_shapes, tx.mlstm_forward, tx.mlstm_state_init),
          "slstm": (tx.slstm_param_shapes, tx.slstm_forward, tx.slstm_state_init)}
D, HEADS = 16, 2
# (s, chunk): shorter than a chunk, one step short of it, exactly one,
# a tail, four whole chunks; and a finer grain with a tail
CASES = ((1, 64), (63, 64), (64, 64), (150, 64), (256, 64), (150, 16))


def _params(kind, seed=0):
    """The block's params drawn from a seed (ones and zeros drawn around
    their constants, so that every term shows), f32 numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, std, _) in BLOCKS[kind][0](tx.XLSTMConfig(D, HEADS)).items():
        base = {"ones": 1.0, "zeros": 0.0}.get(std, 0.0)
        scale = 0.3 if isinstance(std, str) else std
        out[name] = (base + scale * rng.normal(size=shape)).astype(np.float32)
    return out


def _state(kind, b, seed):
    """A random state the block carries on from (m finite, as after a
    step)."""
    rng = np.random.default_rng(seed)
    init = BLOCKS[kind][2](tx.XLSTMConfig(D, HEADS), b)
    return [rng.normal(size=t.shape).astype(np.float32) for t in init]


def _run(kind, chunk, x, params, state, dtype):
    """The block at ``chunk`` from ``state``; the loss weighs every output
    and state element by a fixed random factor. Returns (out, the final
    state, the gradients of x, the params and the initial state)."""
    cfg = tx.XLSTMConfig(D, HEADS, chunk=chunk)
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    pt = {k: torch.from_numpy(v).to(dtype).requires_grad_() for k, v in params.items()}
    st = [torch.from_numpy(v).requires_grad_() for v in state]
    out, new = BLOCKS[kind][1](xt, pt, cfg, state=tuple(st))
    rng = np.random.default_rng(9)
    loss = (out.to(torch.float32) * torch.from_numpy(
        rng.normal(size=out.shape).astype(np.float32))).sum()
    for leaf in new:
        loss = loss + (leaf * torch.from_numpy(rng.normal(size=leaf.shape).astype(np.float32))).sum()
    grads = torch.autograd.grad(loss, [xt, *pt.values(), *st])
    return out.detach(), [t.detach() for t in new], grads


@pytest.mark.parametrize("s,chunk", CASES, ids=[f"s{s}-c{c}" for s, c in CASES])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_chunked_scan_bitwise_equals_one_chunk(kind, dtype, s, chunk):
    """Chunked against one chunk as long as the sequence: outputs, final
    state and every gradient bitwise equal."""
    x = np.random.default_rng(1).normal(size=(2, s, D)).astype(np.float32)
    params, state = _params(kind, seed=2), _state(kind, 2, seed=3)
    out, new, grads = _run(kind, chunk, x, params, state, DTYPES[dtype])
    out1, new1, grads1 = _run(kind, s, x, params, state, DTYPES[dtype])
    assert torch.equal(out, out1)
    assert len(new) == len(new1) and all(torch.equal(a, b) for a, b in zip(new, new1))
    assert len(grads) == len(params) + len(state) + 1
    for i, (a, b) in enumerate(zip(grads, grads1)):
        assert torch.isfinite(a).all() and torch.equal(a, b), i


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_chunked_scan_matches_reference_chunks(kind, dtype):
    """The port at the reference's grain (chunk 8, both) over 21 steps from
    the initial state, then 3 more from the carried state: outputs and
    states within the port's tolerances (the reference pads the tail
    chunk; the port runs only its steps)."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    jc, tc = jx.XLSTMConfig(D, HEADS, chunk=8), tx.XLSTMConfig(D, HEADS, chunk=8)
    params = _params(kind, seed=4)
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    tp = {k: torch.from_numpy(np.array(jp[k].astype(jnp.float32))).to(tdt) for k in params}
    jf = jax.jit(jx.slstm_forward if kind == "slstm" else jx.mlstm_forward, static_argnums=(2,))
    tf = BLOCKS[kind][1]
    x = jnp.asarray(np.random.default_rng(5).normal(size=(2, 24, D)), jdt)
    jst = tst = None
    for lo, hi in ((0, 21), (21, 24)):
        jo, jst = jf(x[:, lo:hi], jp, jc, state=jst)
        to, tst = tf(torch.from_numpy(np.array(x[:, lo:hi].astype(jnp.float32))).to(tdt), tp,
                     tc, state=tst)
        np.testing.assert_allclose(to.to(torch.float32).numpy(),
                                   np.asarray(jo.astype(jnp.float32)), **tol)
        for tl, jl in zip(tst, jst):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)


def test_decode_step_runs_one_step_a_block(monkeypatch):
    """Reduced xLSTM-125M at chunk 64: a 5-token prefill runs 5 steps a
    block, then a decode step one, not a padded chunk of 64."""
    cfg = get_config("xlstm-125m").reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    assert model._impl.xcfg.chunk == 64
    calls = {"mlstm": 0, "slstm": 0}
    for kind in calls:
        step = getattr(tx, f"_{kind}_step")

        def counted(*args, _step=step, _kind=kind):
            calls[_kind] += 1
            return _step(*args)

        monkeypatch.setattr(tx, f"_{kind}_step", counted)
    n_s = len(cfg.slstm_layers)
    _, cache = model.prefill(params, {"tokens": torch.zeros((2, 5), dtype=torch.int64)}, 8)
    assert calls == {"mlstm": 5 * (cfg.n_layers - n_s), "slstm": 5 * n_s}
    model.decode_step(params, torch.zeros((2, 1), dtype=torch.int64), cache)
    assert calls == {"mlstm": 6 * (cfg.n_layers - n_s), "slstm": 6 * n_s}


@pytest.fixture(autouse=True, scope="module")
def dry_runs(tmp_path_factory):
    """The two dry runs of the last test, started with the module so that
    they run beside its other tests."""
    tmp = tmp_path_factory.mktemp("xlstm_dry")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {mode: subprocess.Popen([sys.executable, WORKER, mode, str(tmp / f"{mode}.pkl")],
                                    env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for mode in ("chunks", "steps")}
    yield tmp, procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def test_dryrun_counts_one_chunk_as_every_step(dry_runs):
    """One chunk counted for all against every step traced: equal counts,
    the peak within 2 %."""
    tmp, procs = dry_runs
    reps = {}
    for mode, p in procs.items():
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-4000:]
        with open(tmp / f"{mode}.pkl", "rb") as f:
            reps[mode] = pickle.load(f)
    got, want = reps["chunks"], reps["steps"]
    assert got["mesh"]["axes"] == {"data": 2, "model": 2}
    for key in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device",
                "collective_per_kind"):
        assert got[key] == want[key], key
    assert got["collectives"]["counts"] == want["collectives"]["counts"]
    assert got["flops_per_device"] > 0 and got["collective_bytes_per_device"] > 0
    peak, peak1 = got["memory"]["peak_bytes"], want["memory"]["peak_bytes"]
    assert abs(peak - peak1) <= 0.02 * peak1, (peak, peak1)
    assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
