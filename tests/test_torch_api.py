"""Parity of the port's per-matrix planning path with the JAX reference:
``ChunkSelector.select`` for one site, ``NeuronChunkingPlanner`` (plan,
plan_topk, dense_latency), the reorderings and the importance helpers, and
the quickstart entry point.

Tolerances: masks, ``n_selected`` and permutations are int/bool results
and must be equal exactly. Selection is compared exactly on dyadic
activations (k/8), whose importances and prefix sums are exact in both
packages' summation orders (the port sums the prefix in float64, the
reference in float32); on random floats it is held to the port's numpy
oracle of Algorithm 1. Latency estimates, retention and the coefficient of
variation are f32 sums taken in another order: rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NeuronChunkingPlanner as JPlanner
from repro.core import chunking as jchunk
from repro.core import reorder as jreorder
from repro.core.importance import coefficient_of_variation as j_cv
from repro.core.importance import importance as j_importance
from repro.core.importance import importance_np as j_importance_np
from repro.core.importance import retention as j_retention
from repro.core.latency_model import profile_table as j_profile_table
from repro_torch.core import NeuronChunkingPlanner as TPlanner
from repro_torch.core import chunking as tchunk
from repro_torch.core import reorder as treorder
from repro_torch.core.importance import coefficient_of_variation as t_cv
from repro_torch.core.importance import importance as t_importance
from repro_torch.core.importance import importance_np as t_importance_np
from repro_torch.core.importance import retention as t_retention
from repro_torch.core.latency_model import profile_table as t_profile_table
from repro_torch.launch import quickstart
from torch_threads import one_thread  # noqa: F401


def _dyadic(rng, shape):
    return (rng.integers(0, 64, shape) / 8.0).astype(np.float32)


def _selectors(n, row_bytes, device, table_rows):
    jtab = ttab = None
    if table_rows:  # a table shorter than the largest window: lookups extrapolate
        jtab = j_profile_table(device, row_bytes, max_rows=table_rows)
        ttab = t_profile_table(device, row_bytes, max_rows=table_rows, torch_device="cpu")
    cfg = tchunk.ChunkConfig.for_shape(n, 1, device)
    js = jchunk.ChunkSelector.build(n, row_bytes, device=device,
                                    cfg=jchunk.ChunkConfig(**vars(cfg)), table=jtab)
    ts = tchunk.ChunkSelector.build(n, row_bytes, device=device, cfg=cfg, table=ttab)
    return js, ts


@pytest.mark.parametrize("table_rows", [None, 16])
@pytest.mark.parametrize("device", ["nano", "agx"])
@pytest.mark.parametrize("n,row_bytes,seed", [(256, 256.0, 0), (200, 512.0, 1), (128, 64.0, 2)])
def test_chunk_selector_select_equals_reference_on_dyadic(n, row_bytes, seed, device,
                                                          table_rows):
    rng = np.random.default_rng(seed)
    js, ts = _selectors(n, row_bytes, device, table_rows)
    v = _dyadic(rng, n)
    for budget in (0, 17, n // 2, n):
        jm, jsel, jlat = js.select(jnp.asarray(v), jnp.int32(budget))
        tm, tsel, tlat = ts.select(torch.from_numpy(v), budget)
        assert tm.dtype == torch.bool and tsel.dtype == torch.int32
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert int(tsel) == int(jsel)
        np.testing.assert_allclose(float(tlat), float(jlat), rtol=1e-6)
    jm, jsel, _ = js.select_for_sparsity(jnp.asarray(v), 0.4)
    tm, tsel, _ = ts.select_for_sparsity(torch.from_numpy(v), 0.4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tsel) == int(jsel)


@pytest.mark.parametrize("seed", range(3))
def test_chunk_selector_select_equals_oracle_on_random(seed):
    rng = np.random.default_rng(100 + seed)
    n, row_bytes = 256, 512.0
    _, ts = _selectors(n, row_bytes, "nano", None)
    v = rng.random(n).astype(np.float32)
    budget = int(rng.integers(16, 200))
    tm, tsel, _ = ts.select(torch.from_numpy(v), budget)
    oracle = tchunk.select_chunks_np(v, budget, row_bytes, ts.table, ts.cfg)
    np.testing.assert_array_equal(tm.numpy(), oracle)
    assert int(tsel) == int(oracle.sum())


def test_chunk_selector_residency_is_not_ported():
    """The name dates from before the port had residency-aware selection
    (it pinned the refusal); it now holds ``select(resident=)`` to the
    reference's on dyadic importances: the mask, the count and the
    miss-only estimate, with nothing resident, a block resident and
    everything resident."""
    rng = np.random.default_rng(11)
    js, ts = _selectors(64, 256.0, "nano", None)
    v = _dyadic(rng, 64)
    for lo, hi in ((0, 0), (8, 40), (0, 64)):
        res = np.zeros(64, bool)
        res[lo:hi] = True
        jm, jsel, jlat = js.select(jnp.asarray(v), jnp.int32(32), jnp.asarray(res))
        tm, tsel, tlat = ts.select(torch.from_numpy(v), 32, resident=torch.from_numpy(res))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert int(tsel) == int(jsel)
        np.testing.assert_allclose(float(tlat), float(jlat), rtol=1e-6)


def _calibration(rng, n):
    return _dyadic(rng, (12, n))


@pytest.mark.parametrize("reorder", [None, "hot_cold"])
@pytest.mark.parametrize("n,cols,device,sparsity", [(256, 128, "nano", 0.4),
                                                    (256, 256, "agx", 0.5),
                                                    (192, 128, "nano", 0.7)])
def test_planner_equals_reference_on_dyadic(n, cols, device, sparsity, reorder):
    rng = np.random.default_rng(n + cols)
    jr = tr = None
    if reorder:
        cal = _calibration(rng, n)
        jr, tr = jreorder.hot_cold_reordering(cal), treorder.hot_cold_reordering(cal)
        np.testing.assert_array_equal(tr.perm, jr.perm)
    jp = JPlanner.build(n, cols, device=device, reordering=jr)
    tp = TPlanner.build(n, cols, device=device, reordering=tr)
    assert tp.row_bytes == jp.row_bytes
    acts = _dyadic(rng, (16, n))
    for name in ("plan", "plan_topk"):
        j = getattr(jp, name)(jnp.asarray(acts), sparsity)
        t = getattr(tp, name)(torch.from_numpy(acts), sparsity)
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
        assert t.n_selected.dtype == torch.int32 and int(t.n_selected) == int(j.n_selected)
        np.testing.assert_allclose(float(t.est_latency_s), float(j.est_latency_s), rtol=1e-6)
        np.testing.assert_allclose(float(t.importance_retention),
                                   float(j.importance_retention), rtol=1e-6)
    np.testing.assert_allclose(tp.dense_latency(), jp.dense_latency(), rtol=1e-6)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("fraction", [0.5, 0.25])
def test_reorderings_equal_reference(seed, fraction):
    rng = np.random.default_rng(seed)
    n = 96
    cal = rng.random((10, n)).astype(np.float32)
    cal[:, ::7] = cal[:, 3:4]  # ties at the threshold and in the frequencies
    np.testing.assert_array_equal(treorder.activation_frequency(cal, fraction),
                                  jreorder.activation_frequency(cal, fraction))
    for fn in ("hot_cold_reordering", "coactivation_reordering"):
        jr = getattr(jreorder, fn)(cal, fraction)
        tr = getattr(treorder, fn)(cal, fraction)
        np.testing.assert_array_equal(tr.perm, jr.perm)
        np.testing.assert_array_equal(tr.inverse, jr.inverse)
    tr = treorder.hot_cold_reordering(cal[0], fraction)  # one sample as a 1-D vector
    np.testing.assert_array_equal(tr.perm, jreorder.hot_cold_reordering(cal[0], fraction).perm)
    acts = rng.normal(0, 1, (3, n)).astype(np.float32)
    np.testing.assert_array_equal(tr.apply_to_acts(torch.from_numpy(acts)).numpy(),
                                  np.asarray(jreorder.Reordering(tr.perm).apply_to_acts(
                                      jnp.asarray(acts))))
    w = rng.normal(0, 1, (n, 4)).astype(np.float32)
    np.testing.assert_array_equal(tr.apply_to_rows(torch.from_numpy(w)).numpy(),
                                  tr.apply_to_rows(w))
    mask = rng.random(n) < 0.5
    np.testing.assert_array_equal(tr.unapply_mask(torch.from_numpy(mask)),
                                  jreorder.Reordering(tr.perm).unapply_mask(mask))
    assert (treorder.Reordering.identity(5).perm == np.arange(5)).all()


@pytest.mark.parametrize("shape", [(64,), (4, 64), (2, 3, 64)])
def test_importance_helpers_equal_reference(shape):
    rng = np.random.default_rng(len(shape))
    acts = rng.normal(0, 1, shape).astype(np.float32)
    np.testing.assert_array_equal(t_importance_np(acts), j_importance_np(acts))
    v = t_importance(torch.from_numpy(acts))
    jv = j_importance(jnp.asarray(acts))
    np.testing.assert_allclose(float(t_cv(v)), float(j_cv(jv)), rtol=1e-6)
    mask = rng.random(64) < 0.4
    np.testing.assert_allclose(float(t_retention(v, torch.from_numpy(mask))),
                               float(j_retention(jv, jnp.asarray(mask))), rtol=1e-6)


def test_quickstart_on_cpu_matches_reference_planner(capsys):
    out = quickstart.main(["--torch-device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == [
        "selected rows", "importance retained", "est. I/O latency", "contiguity",
        "kernel vs oracle max err"]
    # the reference planner on the same activations (examples/quickstart.py)
    rng = np.random.default_rng(0)
    acts = np.abs(rng.normal(0, 1, (16, quickstart.N))) * rng.lognormal(0, 1, quickstart.N)
    jp = JPlanner.build(quickstart.N, quickstart.D, device="nano", dtype_bytes=2)
    j = jp.plan(jnp.asarray(acts), sparsity=quickstart.SPARSITY)
    np.testing.assert_array_equal(out["plan"].mask.numpy(), np.asarray(j.mask))
    np.testing.assert_allclose(float(out["plan"].est_latency_s), float(j.est_latency_s),
                               rtol=1e-6)
    assert lines[0] == f"selected rows      : {int(j.n_selected)} / {quickstart.N}"
    assert out["w"].shape == (quickstart.N, quickstart.D) and out["x"].shape == (1, quickstart.N)
    assert out["y"].shape == (1, quickstart.D)
    assert out["max_err"] / max(1.0, float(out["y"].abs().max())) < 1e-5


def test_quickstart_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])
