"""Parity of the port's chunk selection with the JAX reference.

Tolerances: masks, block tables, candidate schedules and top-k masks are
int/bool results and must be equal exactly when both packages get the same
inputs. Batched selection is compared exactly on dyadic importances (k/8),
whose prefix sums are exact in both packages' summation orders; on random
floats it is compared with the numpy oracle of Algorithm 1. Latency
estimates are f32 sums taken in another order: rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunking as jchunk
from repro.core.baselines import topk_mask as j_topk
from repro.core.contiguity import mask_to_chunks_np as j_chunks
from repro.core.contiguity import mask_to_runs_jax
from repro.core.latency_model import profile_table as j_profile_table
from repro.kernels import masks_to_block_tables as j_m2t
from repro.serving.sparse_exec import SparseExecution as JSparse
from repro_torch.configs import get_config
from repro_torch.core import chunking as tchunk
from repro_torch.core.baselines import topk_mask as t_topk
from repro_torch.core.contiguity import mask_run_sizes
from repro_torch.core.contiguity import mask_to_chunks_np as t_chunks
from repro_torch.core.latency_model import profile_table as t_profile_table
from repro_torch.kernels import masks_to_block_tables as t_m2t
from repro_torch.serving.sparse_exec import SparseExecution as TSparse

CFG = get_config("tinyllama-1.1b").reduced()


def _jcfg():
    from repro.configs import get_config as jget

    return jget("tinyllama-1.1b").reduced()


@pytest.mark.parametrize("density", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("n,max_chunk_rows", [(256, 64), (200, 32), (704, 512)])
def test_masks_to_block_tables_equal_reference(density, n, max_chunk_rows):
    rng = np.random.default_rng(int(density * 10) + n)
    masks = np.stack([rng.random(n) < density for _ in range(3)])
    js, jz = j_m2t(jnp.asarray(masks), 8, max_chunk_rows)
    ts, tz = t_m2t(torch.from_numpy(masks), 8, max_chunk_rows)
    assert ts.dtype == torch.int32 and tuple(ts.shape) == tuple(js.shape)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_masks_to_block_tables_empty_and_full():
    n = 64
    masks = np.stack([np.zeros(n, bool), np.ones(n, bool)])
    js, jz = j_m2t(jnp.asarray(masks), 8, 32)
    ts, tz = t_m2t(torch.from_numpy(masks), 8, 32)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert int(tz[0].sum()) == 0 and int(tz[1].sum()) == n


@pytest.mark.parametrize("rows,cols,device", [(256, 256, "nano"), (704, 256, "nano"),
                                              (256, 704, "agx"), (4096, 4096, "nano")])
def test_candidate_schedule_equal_reference(rows, cols, device):
    jcfg = jchunk.ChunkConfig.for_shape(rows, cols, device)
    tcfg = tchunk.ChunkConfig.for_shape(rows, cols, device)
    assert tuple(vars(jcfg).values()) == tuple(vars(tcfg).values())
    for rb in (cols * 2.0, cols + 0.5):
        js, jz = jchunk._candidate_schedule(rows, rb, jcfg)
        ts, tz = tchunk._candidate_schedule(rows, rb, tcfg)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tz, jz)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("device", ["nano", "agx"])
def test_select_chunks_np_equals_reference_oracle(seed, device):
    rng = np.random.default_rng(seed)
    n = 256
    row_bytes = 512.0
    cfg = tchunk.ChunkConfig.for_shape(n, 256, device)
    v = rng.random(n).astype(np.float32)
    budget = int(rng.integers(16, 200))
    jtab = j_profile_table(device, row_bytes, max_rows=64)
    ttab = t_profile_table(device, row_bytes, max_rows=64, torch_device="cpu")
    np.testing.assert_array_equal(ttab.table.numpy(), np.asarray(jtab.table))
    jm = jchunk.select_chunks_np(v, budget, row_bytes, jtab, jchunk.ChunkConfig(**vars(cfg)))
    tm = tchunk.select_chunks_np(v, budget, row_bytes, ttab, cfg)
    np.testing.assert_array_equal(tm, jm)


def _site_vectors(sparse, rng, dyadic):
    vs = np.zeros((sparse.batched.n_sites, sparse.batched.n_max), np.float32)
    for i, kind in enumerate(sparse.site_order):
        n = sparse.sites[kind].n
        vs[i, :n] = rng.integers(0, 64, n) / 8.0 if dyadic else rng.random(n)
    return vs


@pytest.mark.parametrize("wbits", [16, 8])
@pytest.mark.parametrize("seed", range(3))
def test_batched_select_equals_reference_on_dyadic(wbits, seed):
    js = JSparse(_jcfg(), device="nano", sparsity=0.4, method="chunk", wbits=wbits)
    ts = TSparse(CFG, device="nano", sparsity=0.4, method="chunk", wbits=wbits,
                torch_device="cpu")
    assert ts.site_order == js.site_order
    np.testing.assert_array_equal(ts._budgets.numpy(), np.asarray(js._budgets))
    vs = _site_vectors(ts, np.random.default_rng(seed), dyadic=True)
    jm, jsel = js.batched.select(jnp.asarray(vs), js._budgets)
    tm, tsel = ts.batched.select(torch.from_numpy(vs), ts._budgets)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))


@pytest.mark.parametrize("device", ["nano", "agx"])
@pytest.mark.parametrize("seed", range(3))
def test_batched_select_equals_oracle_on_random(device, seed):
    ts = TSparse(CFG, device=device, sparsity=0.4, method="chunk", torch_device="cpu")
    vs = _site_vectors(ts, np.random.default_rng(100 + seed), dyadic=False)
    tm, _ = ts.batched.select(torch.from_numpy(vs), ts._budgets)
    for i, kind in enumerate(ts.site_order):
        site = ts.sites[kind]
        sel = site.selector
        oracle = tchunk.select_chunks_np(vs[i, : site.n], site.budget(), sel.row_bytes,
                                         sel.table, sel.cfg)
        np.testing.assert_array_equal(tm[i, : site.n].numpy(), oracle)
        assert not tm[i, site.n:].any()


def test_greedy_plain_exits_early_and_skips_padding():
    starts = torch.tensor([[0, 4, 2, 0, 8]], dtype=torch.int32)
    sizes = torch.tensor([[4, 4, 4, 0, 4]], dtype=torch.int32)
    masks, sel = tchunk.greedy_select(starts, sizes, torch.tensor([8], dtype=torch.int32),
                                      torch.tensor([4], dtype=torch.int32), 12)
    assert int(sel[0]) == 8  # [0,4) and [4,8); [2,6) overlaps; budget then full
    assert masks[0].tolist() == [True] * 8 + [False] * 4


@pytest.mark.parametrize("budget", [0, 5, 37, 64])
def test_topk_mask_equal_reference(budget):
    rng = np.random.default_rng(budget)
    v = (rng.integers(0, 8, 64) / 4.0).astype(np.float32)  # many ties
    np.testing.assert_array_equal(t_topk(torch.from_numpy(v), budget).numpy(),
                                  np.asarray(j_topk(jnp.asarray(v), budget)))


@pytest.mark.parametrize("density", [0.0, 0.3, 0.8, 1.0])
def test_run_sizes_and_mask_latency_equal_reference(density):
    rng = np.random.default_rng(7)
    m = rng.random(300) < density
    _, jsizes, _ = mask_to_runs_jax(jnp.asarray(m))
    np.testing.assert_array_equal(mask_run_sizes(torch.from_numpy(m)).numpy(),
                                  np.asarray(jsizes))
    jtab = j_profile_table("nano", 1024.0, max_rows=40)
    ttab = t_profile_table("nano", 1024.0, max_rows=40, torch_device="cpu")
    np.testing.assert_allclose(float(ttab.mask_latency(torch.from_numpy(m))),
                               float(jtab.mask_latency(jnp.asarray(m))), rtol=1e-6)


@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_mask_to_chunks_equal_reference(density):
    m = np.random.default_rng(11).random(97) < density
    assert [(c.start, c.size) for c in t_chunks(m)] == [(c.start, c.size) for c in j_chunks(m)]
