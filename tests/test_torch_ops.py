"""Parity of the port's per-matrix kernels K3 (``chunk_gather_matmul``) and
K4 (``chunk_gather_swiglu``), their public ``sparse_*`` wrappers, the
torch oracles and the host table helpers with the JAX reference.

Tolerances: the plain versions and the reference kernels (interpret mode)
both accumulate in f32 but sum each 8-row block in another order, so
outputs are compared with the reference suite's relative error < 1e-5
(|Δ| / max(1, max|ref|)), at bf16 and f32 weights alike. The oracles are
matmuls in another order too: the same 1e-5. Chunk tables, masks, run
statistics and padded-table zeros are int/bool results or exact sums and
must be equal exactly. The CUDA kernels run only on a card (marker
``gpu``; ``python3 chip_smoke.py`` runs them at full width).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunking as jchunk
from repro.core import contiguity as jcont
from repro.kernels import align_chunk_table as j_align
from repro.kernels import chunk_gather_matmul as j_k3
from repro.kernels import chunk_gather_matmul_ref as j_k3_ref
from repro.kernels import chunk_gather_mlp_ref as j_k2_ref
from repro.kernels import chunk_gather_swiglu as j_k4
from repro.kernels import chunk_gather_swiglu_ref as j_k4_ref
from repro.kernels import chunk_table_to_mask as j_table_mask
from repro.kernels import plan_to_kernel_table as j_plan_table
from repro.kernels import sparse_matmul_dma as j_sparse_dma
from repro.kernels import sparse_mlp_fused as j_mlp_fused
from repro_torch.core import chunking as tchunk
from repro_torch.core import contiguity as tcont
from repro_torch.kernels import chunk_gather_dma as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# the K1-body edge cases, shared with the K1 suite
from test_torch_kernels import K1_CASES, k1_case  # noqa: E402

# the package exports functions of the same names as these modules
tk3 = importlib.import_module("repro_torch.kernels.chunk_gather_matmul")
tk4 = importlib.import_module("repro_torch.kernels.chunk_gather_swiglu")


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _weights(rng, shape, dtype):
    """The same weights for both packages: f32 numpy → each package's bf16
    (both round to nearest even) or f32."""
    w = rng.normal(0, 1, shape).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(w, jnp.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    return jnp.asarray(w), torch.from_numpy(w)


def _table(rng, n, density, max_chunk_rows):
    s, z = tops.plan_to_kernel_table(rng.random(n) < density, block_rows=8,
                                     max_chunks=max(n // 8, 1), max_chunk_rows=max_chunk_rows)
    return (jnp.asarray(s), jnp.asarray(z)), (torch.from_numpy(s), torch.from_numpy(z))


# ---------------------------------------------------------------------------
# K3 / K4 plain versions against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("n,d,b,mcr", [(128, 128, 1, 32), (256, 256, 4, 64)])
def test_k3_plain_matches_reference_kernel(dtype, n, d, b, mcr):
    rng = np.random.default_rng(n + b)
    jw, tw = _weights(rng, (n, d), dtype)
    x = rng.normal(0, 1, (b, n)).astype(np.float32)
    (js, jz), (ts, tz) = _table(rng, n, 0.5, mcr)
    y_ref = j_k3(jw, jnp.asarray(x), js, jz, max_chunk_rows=mcr, interpret=True)
    y = tk3.chunk_gather_matmul(tw, torch.from_numpy(x), ts, tz, max_chunk_rows=mcr)
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, d)
    assert _rel_err(y.numpy(), y_ref) < 1e-5
    assert _rel_err(y.numpy(), j_k3_ref(jw, jnp.asarray(x), js, jz)) < 1e-5


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("n,f,b,mcr", [(128, 128, 1, 32), (256, 256, 4, 64)])
def test_k4_plain_matches_reference_kernel(dtype, n, f, b, mcr):
    rng = np.random.default_rng(10 * n + b)
    jg, tg = _weights(rng, (n, f), dtype)
    ju, tu = _weights(rng, (n, f), dtype)
    x = rng.normal(0, 1, (b, n)).astype(np.float32)
    (js, jz), (ts, tz) = _table(rng, n, 0.4, mcr)
    h_ref = j_k4(jg, ju, jnp.asarray(x), js, jz, max_chunk_rows=mcr, interpret=True)
    h = tk4.chunk_gather_swiglu(tg, tu, torch.from_numpy(x), ts, tz, max_chunk_rows=mcr)
    assert h.dtype == torch.float32 and tuple(h.shape) == (b, f)
    assert _rel_err(h.numpy(), h_ref) < 1e-5
    assert _rel_err(h.numpy(), j_k4_ref(jg, ju, jnp.asarray(x), js, jz)) < 1e-5


def test_k3_bf16_activations_are_cast_per_block():
    """x arrives in bf16 (the quickstart's case): both packages cast it to
    f32 before the contraction."""
    rng = np.random.default_rng(3)
    jw, tw = _weights(rng, (128, 128), "bf16")
    x = rng.normal(0, 1, (2, 128)).astype(np.float32)
    (js, jz), (ts, tz) = _table(rng, 128, 0.6, 64)
    y_ref = j_k3(jw, jnp.asarray(x, jnp.bfloat16), js, jz, max_chunk_rows=64, interpret=True)
    y = tk3.chunk_gather_matmul(tw, torch.from_numpy(x).to(torch.bfloat16), ts, tz,
                                max_chunk_rows=64)
    assert _rel_err(y.numpy(), y_ref) < 1e-5


@pytest.mark.parametrize("fn", ["k3", "k4"])
def test_all_padded_table_is_exact_zero(fn):
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(0, 1, (64, 128)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (2, 64)).astype(np.float32))
    s = z = torch.zeros(8, dtype=torch.int32)
    out = (tk3.chunk_gather_matmul(w, x, s, z) if fn == "k3"
           else tk4.chunk_gather_swiglu(w, w, x, s, z))
    assert float(out.abs().max()) == 0.0


def test_k3_plain_is_k1_plain_and_k4_plain_is_k2_phase1():
    """K3/K4 compute K1's function without a mask and K2's phase 1: on one
    table the wrappers agree bitwise with K1 and with K2's h."""
    rng = np.random.default_rng(5)
    n, f = 256, 256
    _, wg = _weights(rng, (n, f), "bf16")
    _, wu = _weights(rng, (n, f), "bf16")
    _, wd = _weights(rng, (f, 128), "bf16")
    x = torch.from_numpy(rng.normal(0, 1, (2, n)).astype(np.float32))
    _, (hs, hz) = _table(rng, n, 0.5, 64)
    _, (fs, fz) = _table(rng, f, 0.5, 64)
    y3 = tk3.chunk_gather_matmul(wg, x, hs, hz, max_chunk_rows=64)
    assert torch.equal(y3, tk.chunk_gather_matmul_dma(wg, x, hs, hz, max_chunk_rows=64))
    h4 = tk4.chunk_gather_swiglu(wg, wu, x, hs, hz, max_chunk_rows=64)
    y2, h2 = tk.chunk_gather_mlp_dma(wg, wu, wd, x, torch.stack([hs, fs]),
                                     torch.stack([hz, fz]), max_chunk_rows=64, return_h=True)
    assert torch.equal(h4, h2)
    assert torch.equal(tk3.chunk_gather_matmul(wd, h4, fs, fz, max_chunk_rows=64), y2)


# ---------------------------------------------------------------------------
# wrapper contracts: the reference's errors, and the port's own
# ---------------------------------------------------------------------------


K3_BAD = [
    dict(d=96),  # D % tile_d
    dict(n=60),  # N % block_rows
    dict(max_chunk_rows=60),  # max_chunk_rows % block_rows
]


@pytest.mark.parametrize("bad", K3_BAD, ids=lambda b: next(iter(b)))
def test_k3_wrapper_errors_match_reference(bad):
    n, d, mcr = bad.get("n", 64), bad.get("d", 128), bad.get("max_chunk_rows", 64)
    s = np.zeros(4, np.int32)
    with pytest.raises(ValueError) as jerr:
        j_k3(jnp.zeros((n, d)), jnp.zeros((1, n)), jnp.asarray(s), jnp.asarray(s),
             max_chunk_rows=mcr, interpret=True)
    with pytest.raises(ValueError) as terr:
        tk3.chunk_gather_matmul(torch.zeros((n, d)), torch.zeros((1, n)), torch.from_numpy(s),
                                torch.from_numpy(s), max_chunk_rows=mcr)
    assert str(terr.value) == str(jerr.value)


K4_BAD = [
    dict(up=(64, 256)),  # w_gate/w_up shape mismatch
    dict(f=96),  # F % tile_f
    dict(n=60),  # N % block_rows
    dict(max_chunk_rows=60),
]


@pytest.mark.parametrize("bad", K4_BAD, ids=lambda b: next(iter(b)))
def test_k4_wrapper_errors_match_reference(bad):
    n, f, mcr = bad.get("n", 64), bad.get("f", 128), bad.get("max_chunk_rows", 64)
    up = bad.get("up", (n, f))
    s = np.zeros(4, np.int32)
    with pytest.raises(ValueError) as jerr:
        j_k4(jnp.zeros((n, f)), jnp.zeros(up), jnp.zeros((1, n)), jnp.asarray(s),
             jnp.asarray(s), max_chunk_rows=mcr, interpret=True)
    with pytest.raises(ValueError) as terr:
        tk4.chunk_gather_swiglu(torch.zeros((n, f)), torch.zeros(up), torch.zeros((1, n)),
                                torch.from_numpy(s), torch.from_numpy(s), max_chunk_rows=mcr)
    assert str(terr.value) == str(jerr.value)


def test_port_only_wrapper_errors_and_no_cpu_launch():
    s = z = torch.zeros(4, dtype=torch.int32)
    x = torch.zeros((1, 64))
    with pytest.raises(ValueError, match="not supported"):  # K3/K4 take no int8 payload
        tk3.chunk_gather_matmul(torch.zeros((64, 128), dtype=torch.int8), x, s, z)
    with pytest.raises(ValueError, match="block_rows must be 8"):
        tk3.chunk_gather_matmul(torch.zeros((64, 128)), x, s, z, block_rows=16)
    with pytest.raises(ValueError, match="dtype mismatch"):
        tk4.chunk_gather_swiglu(torch.zeros((64, 128)), torch.zeros((64, 128)).bfloat16(), x,
                                s, z)
    before = (dict(tk3.LAUNCHES), dict(tk4.LAUNCHES))
    tk3.chunk_gather_matmul(torch.zeros((64, 128)), x, s, z)
    tk4.chunk_gather_swiglu(torch.zeros((64, 128)), torch.zeros((64, 128)), x, s, z)
    assert (tk3.LAUNCHES, tk4.LAUNCHES) == before


@pytest.mark.parametrize("n_mat,depth,elem", [(1, 1, 2), (2, 1, 2), (1, 3, 1), (2, 3, 4)])
def test_table_smem_guard(n_mat, depth, elem):
    """The kernels hold the whole table in shared memory (8 bytes an
    entry): every full-width TinyLlama table fits, and a table too long
    raises a ValueError naming K instead of falling back. For the K1 body
    (n_mat 1) the rest is its ``K1Layout``: ring stages of padded tiles,
    scales and row offsets, the partial buffer's halves, the x slab (8 rows
    of W's 8 input values), the block-list window."""
    w = torch.zeros((8, 64), dtype={1: torch.int8, 2: torch.bfloat16, 4: torch.float32}[elem])
    g = tk.k1_geometry(tk.K1_SECTOR_BYTES, 8, elem, 1, depth, 8, nmat=n_mat)
    tile, blocks = g["tile"], g["blocks"]
    ring = tk.k1_smem_bytes(0, elem, tile, blocks, 8, depth, 8, nmat=n_mat)
    assert tk.k1_smem_bytes(10, elem, tile, blocks, 8, depth, 8, nmat=n_mat) == ring + 80
    if n_mat == 1:
        assert tile * elem == 32
        stage = blocks * 9 * tile * elem + 2 * (-(-blocks * 4 // 16) * 16)
        window = blocks * max(1, tk.K1_WINDOW_BLOCKS // blocks)
        pstride = -(-blocks // 32) * 32 + 4
        assert ring == ((depth + 1) * stage + 2 * 8 * tile * pstride * 4 + 8 * 8 * 4 + 4 * window
                        + 4)
    tk.check_table_fits(5632 // 8, w, n_mat, depth, "k", g, 8, False)
    k_max = (tk.SMEM_LIMIT_BYTES - ring) // 8
    tk.check_table_fits(k_max, w, n_mat, depth, "k", g, 8, False)
    with pytest.raises(ValueError, match=f"K={k_max + 1} "):
        tk.check_table_fits(k_max + 1, w, n_mat, depth, "k", g, 8, False)


def test_ops_dma_wrappers_match_kernels_and_reference_errors():
    rng = np.random.default_rng(6)
    n, f, d = 128, 128, 128
    ws = [torch.from_numpy(rng.normal(0, 1, shp).astype(np.float32))
          for shp in ((n, f), (n, f), (f, d))]
    x = torch.from_numpy(rng.normal(0, 1, (2, n)).astype(np.float32))
    _, (s, z) = _table(rng, n, 0.5, 64)
    st, sz = torch.stack([s, s]), torch.stack([z, z])
    assert torch.equal(tops.sparse_matmul_dma(ws[0], x, s, z, max_chunk_rows=64),
                       tk.chunk_gather_matmul_dma(ws[0], x, s, z, max_chunk_rows=64))
    assert torch.equal(tops.sparse_mlp_fused(*ws, x, st, sz, max_chunk_rows=64),
                       tk.chunk_gather_mlp_dma(*ws, x, st, sz, max_chunk_rows=64))
    jws = [jnp.asarray(w.numpy()) for w in ws]
    jx, js = jnp.asarray(x.numpy()), jnp.asarray(st.numpy())
    for tile in (96, 48):
        with pytest.raises(ValueError) as jerr:
            j_sparse_dma(jws[0], jx, js[0], js[0], tile_d=tile)
        with pytest.raises(ValueError) as terr:
            tops.sparse_matmul_dma(ws[0], x, s, z, tile_d=tile)
        assert str(terr.value) == str(jerr.value)
        with pytest.raises(ValueError) as jerr:
            j_mlp_fused(*jws, jx, js, js, tile_f=tile)
        with pytest.raises(ValueError) as terr:
            tops.sparse_mlp_fused(*ws, x, st, sz, tile_f=tile)
        assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# oracles and host helpers
# ---------------------------------------------------------------------------


def test_torch_oracles_match_reference_oracles():
    rng = np.random.default_rng(7)
    n, f, d = 256, 128, 128
    wg, wu, wd = (rng.normal(0, 1, shp).astype(np.float32) for shp in ((n, f), (n, f), (f, d)))
    x = rng.normal(0, 1, (3, n)).astype(np.float32)
    (js, jz), (ts, tz) = _table(rng, n, 0.5, 64)
    (jfs, jfz), (tfs, tfz) = _table(rng, f, 0.5, 64)
    np.testing.assert_array_equal(tref.chunk_table_to_mask(ts, tz, n).numpy(),
                                  np.asarray(j_table_mask(js, jz, n)))
    t = [torch.from_numpy(a) for a in (wg, wu, wd, x)]
    j = [jnp.asarray(a) for a in (wg, wu, wd, x)]
    assert _rel_err(tref.chunk_gather_matmul_ref(t[0], t[3], ts, tz).numpy(),
                    j_k3_ref(j[0], j[3], js, jz)) < 1e-5
    assert _rel_err(tref.chunk_gather_swiglu_ref(t[0], t[1], t[3], ts, tz).numpy(),
                    j_k4_ref(j[0], j[1], j[3], js, jz)) < 1e-5
    k = max(len(ts), len(tfs))

    def lanes(a, b):
        return np.stack([np.pad(np.asarray(a), (0, k - len(a))),
                         np.pad(np.asarray(b), (0, k - len(b)))])

    st, sz = lanes(ts, tfs), lanes(tz, tfz)
    assert _rel_err(tref.chunk_gather_mlp_ref(*t, torch.from_numpy(st), torch.from_numpy(sz)),
                    j_k2_ref(*j, jnp.asarray(st), jnp.asarray(sz))) < 1e-5


@pytest.mark.parametrize("seed", range(4))
def test_align_chunk_table_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(32, 400))
    k = int(rng.integers(0, 12))
    starts = rng.integers(0, n, k)
    sizes = rng.integers(-2, 90, k)
    for mcr in (None, 32, 64):
        ts, tz = tk3.align_chunk_table(starts, sizes, 8, n, max_chunk_rows=mcr)
        js, jz = j_align(starts, sizes, 8, n, max_chunk_rows=mcr)
        assert ts.dtype == np.int32 and tz.dtype == np.int32
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tz, jz)


@pytest.mark.parametrize("starts,sizes,err", [
    ([8.5], [8.0], TypeError),  # non-integral rows
    ([8], [8, 16], ValueError),  # length mismatch
    ([[8]], [[8]], ValueError),  # not 1-D
])
def test_align_chunk_table_errors_match_reference(starts, sizes, err):
    with pytest.raises(err) as jerr:
        j_align(np.asarray(starts), np.asarray(sizes), 8, 32)
    with pytest.raises(err) as terr:
        tk3.align_chunk_table(np.asarray(starts), np.asarray(sizes), 8, 32)
    assert str(terr.value) == str(jerr.value)
    s, z = tk3.align_chunk_table(np.asarray([8.0]), np.asarray([8.0]), 8, 32)
    assert s.tolist() == [8] and z.tolist() == [8]


@pytest.mark.parametrize("density", [0.0, 0.2, 0.6, 1.0])
@pytest.mark.parametrize("max_chunks,mcr", [(None, 512), (None, 32), (5, 64), (64, 64)])
def test_plan_to_kernel_table_equal_reference(density, max_chunks, mcr):
    rng = np.random.default_rng(int(density * 10) + mcr)
    mask = rng.random(300) < density
    js, jz = j_plan_table(mask, block_rows=8, max_chunks=max_chunks, max_chunk_rows=mcr)
    for m in (mask, torch.from_numpy(mask)):
        ts, tz = tops.plan_to_kernel_table(m, block_rows=8, max_chunks=max_chunks,
                                           max_chunk_rows=mcr)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tz, jz)


@pytest.mark.parametrize("density", [0.1, 0.5, 0.9])
def test_plan_table_equals_block_tables_nonempty_entries(density):
    """The library path's tables are the serve path's block tables with the
    padding dropped (chip_smoke.py holds this at full width)."""
    mask = np.random.default_rng(int(density * 10)).random(704) < density
    s, z = tops.plan_to_kernel_table(mask, block_rows=8, max_chunk_rows=64)
    bs, bz = tk.masks_to_block_tables(torch.from_numpy(mask)[None], 8, 64)
    keep = bz[0] > 0
    np.testing.assert_array_equal(s, bs[0][keep].numpy())
    np.testing.assert_array_equal(z, bz[0][keep].numpy())


@pytest.mark.parametrize("density", [0.0, 0.3, 0.7, 1.0])
def test_contiguity_helpers_equal_reference(density):
    mask = np.random.default_rng(int(density * 10)).random(257) < density
    assert tcont.contiguity_distribution_np(mask) == jcont.contiguity_distribution_np(mask)
    assert tcont.chunk_stats_np(mask) == jcont.chunk_stats_np(mask)
    chunks = tcont.mask_to_chunks_np(mask)
    np.testing.assert_array_equal(tcont.chunks_to_mask_np(chunks[::-1], 257), mask)
    for max_chunks in (1, 7, 300):
        t = tcont.runs_to_padded_table_np(mask, max_chunks)
        j = jcont.runs_to_padded_table_np(mask, max_chunks)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
        assert t[2] == j[2]
        c = tchunk.chunk_table_from_mask(torch.from_numpy(mask), max_chunks)
        cj = jchunk.chunk_table_from_mask(mask, max_chunks)
        assert [a.tolist() if hasattr(a, "tolist") else a for a in c] == \
            [a.tolist() if hasattr(a, "tolist") else a for a in cj]


def test_chunks_to_mask_errors_match_reference():
    for chunks in ([tcont.Chunk(-1, 2)], [tcont.Chunk(0, 4), tcont.Chunk(2, 4)]):
        jchunks = [jcont.Chunk(c.start, c.size) for c in chunks]
        with pytest.raises(ValueError) as jerr:
            jcont.chunks_to_mask_np(jchunks, 16)
        with pytest.raises(ValueError) as terr:
            tcont.chunks_to_mask_np(chunks, 16)
        assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(python3 chip_smoke.py runs them at full width)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("mlp",) + K1_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k3_k4_kernels_bitwise_equal_plain_k1_k2(cuda, dtype, case):
    rng = np.random.default_rng(60)
    if case != "mlp":
        w, x, s, z = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                      for a in k1_case(rng, case, "f32"))
        w, x, s, z = w.to(cuda, dtype), x.to(cuda), s.to(cuda), z.to(cuda)
        y = tk3.chunk_gather_matmul(w, x, s, z, tile_d=8)
        assert torch.equal(y, tk.chunk_gather_matmul_plain(w, x, s, z))
        assert torch.equal(y, tk.chunk_gather_matmul_dma(w, x, s, z, prefetch_depth=1))
        return
    n, f, d = 256, 704, 256
    wg, wu, wd = (torch.from_numpy(rng.normal(0, 1, shp).astype(np.float32)).to(cuda, dtype)
                  for shp in ((n, f), (n, f), (f, d)))
    x = torch.from_numpy(rng.normal(0, 1, (2, n)).astype(np.float32)).to(cuda)
    _, (s, z) = _table(rng, n, 0.5, 512)
    _, (fs, fz) = _table(rng, f, 0.5, 512)
    s, z, fs, fz = (t.to(cuda) for t in (s, z, fs, fz))
    y = tk3.chunk_gather_matmul(wg, x, s, z, tile_d=64)
    assert torch.equal(y, tk.chunk_gather_matmul_plain(wg, x, s, z))
    assert torch.equal(y, tk.chunk_gather_matmul_dma(wg, x, s, z, prefetch_depth=1))
    h = tk4.chunk_gather_swiglu(wg, wu, x, s, z, tile_f=64)
    assert torch.equal(h, tk.chunk_gather_swiglu_plain(wg, wu, x, s, z))
    k = max(s.shape[0], fs.shape[0])
    st = torch.zeros((2, k), dtype=torch.int32, device=cuda)
    sz = torch.zeros_like(st)
    st[0, : s.shape[0]], sz[0, : z.shape[0]] = s, z
    st[1, : fs.shape[0]], sz[1, : fz.shape[0]] = fs, fz
    _, h2 = tk.chunk_gather_mlp_dma(wg, wu, wd, x, st, sz, return_h=True)
    assert torch.equal(h, h2)
    zero = torch.zeros_like(s)
    assert float(tk3.chunk_gather_matmul(wg, x, zero, zero, tile_d=64).abs().max()) == 0.0


@pytest.mark.gpu
def test_k3_table_too_long_raises_on_card(cuda):
    w = torch.zeros((64, 128), device=cuda)
    k = tk.SMEM_LIMIT_BYTES // 8 + 1
    s = torch.zeros(k, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=f"K={k} "):
        tk3.chunk_gather_matmul(w, torch.zeros((1, 64), device=cuda), s, s)
