"""Parity of the port's K1/K2 plain versions with the JAX reference kernels
(``chunk_gather_matmul_dma`` / ``chunk_gather_mlp_dma`` in interpret mode)
and the ``kernels/ref.py`` oracles, plus the port's own invariants.

Tolerances: the plain versions and the reference both accumulate in f32
but sum each 8-row block in another order, so outputs are compared with
the reference suite's relative error < 1e-5 (|Δ| / max(1, max|ref|)).
Quantized payloads, scales, padded-table zeros and the port's
kernel-vs-twin results are compared exactly. The CUDA kernels themselves
run only on a card (marker ``gpu``; ``python3 chip_smoke.py`` runs them at
full width).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chunk_gather_matmul_dma as j_k1
from repro.kernels import chunk_gather_matmul_ref as j_k1_ref
from repro.kernels import chunk_gather_mlp_dma as j_k2
from repro.kernels import chunk_gather_mlp_ref as j_k2_ref
from repro.kernels import dequantize_rows as j_dequant
from repro.kernels import quantize_rows as j_quant
from repro_torch.core import chunking as tchunk
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels import chunk_gather_dma as tk
from repro_torch.kernels import quantize as tq

DEPTHS = (0, 1, 2)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _weights(rng, shape, dtype, std=1.0):
    """The same weights for both packages: f32 numpy → each package's bf16
    (both round to nearest even) or int8 payload + scales."""
    return _weights_from(rng.normal(0, std, shape).astype(np.float32), dtype)


def _weights_from(w, dtype):
    if dtype == "bf16":
        return jnp.asarray(w, jnp.bfloat16), torch.from_numpy(w).to(torch.bfloat16), None
    if dtype == "f32":
        return jnp.asarray(w), torch.from_numpy(w), None
    q, s = j_quant(jnp.asarray(w), 8)
    return q, torch.from_numpy(np.array(q)), (s, torch.from_numpy(np.array(s)))


def _table(rng, n, density, max_chunk_rows):
    mask = rng.random(n) < density
    s, z = tk.masks_to_block_tables(torch.from_numpy(mask[None]), 8, max_chunk_rows)
    return s[0], z[0]


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n,d,b", [(128, 128, 1), (256, 256, 4), (64, 128, 8)])
def test_k1_plain_matches_reference_kernel(depth, dtype, n, d, b):
    rng = np.random.default_rng(n + d + b)
    jw, tw, sc = _weights(rng, (n, d), dtype)
    x = rng.normal(0, 1, (b, n)).astype(np.float32)
    s, z = _table(rng, n, 0.5, 64)
    js = jnp.asarray(s.numpy())
    jz = jnp.asarray(z.numpy())
    y_ref = j_k1(jw, jnp.asarray(x), js, jz, None if sc is None else sc[0],
                 max_chunk_rows=64, prefetch_depth=depth, interpret=True)
    y = tk.chunk_gather_matmul_dma(tw, torch.from_numpy(x), s, z,
                                   None if sc is None else sc[1],
                                   max_chunk_rows=64, prefetch_depth=depth)
    assert y.dtype == torch.float32
    assert _rel_err(y.numpy(), y_ref) < 1e-5
    w_f32 = jw.astype(jnp.float32) if sc is None else j_dequant(jw, sc[0])
    assert _rel_err(y.numpy(), j_k1_ref(w_f32, jnp.asarray(x), js, jz)) < 1e-5


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_k1_all_padded_table_is_exact_zero(depth, dtype):
    rng = np.random.default_rng(1)
    _, tw, sc = _weights(rng, (64, 128), dtype)
    x = torch.from_numpy(rng.normal(0, 1, (2, 64)).astype(np.float32))
    z = torch.zeros(5, dtype=torch.int32)
    y = tk.chunk_gather_matmul_dma(tw, x, z, z, None if sc is None else sc[1],
                                   max_chunk_rows=32, prefetch_depth=depth)
    assert float(y.abs().max()) == 0.0


@pytest.mark.parametrize("depth", DEPTHS)
def test_k1_single_max_chunk(depth):
    rng = np.random.default_rng(2)
    jw, tw, _ = _weights(rng, (128, 128), "f32")
    x = rng.normal(0, 1, (3, 128)).astype(np.float32)
    s, z = np.array([32], np.int32), np.array([64], np.int32)
    y_ref = j_k1(jw, jnp.asarray(x), jnp.asarray(s), jnp.asarray(z), max_chunk_rows=64,
                 prefetch_depth=depth, interpret=True)
    y = tk.chunk_gather_matmul_dma(tw, torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(z), max_chunk_rows=64, prefetch_depth=depth)
    assert _rel_err(y.numpy(), y_ref) < 1e-5


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_k1_k_far_exceeds_real_chunks(dtype):
    rng = np.random.default_rng(3)
    jw, tw, sc = _weights(rng, (64, 128), dtype)
    x = rng.normal(0, 1, (2, 64)).astype(np.float32)
    s, z = np.zeros(32, np.int32), np.zeros(32, np.int32)
    s[0], z[0] = 8, 16
    y_ref = j_k1(jw, jnp.asarray(x), jnp.asarray(s), jnp.asarray(z),
                 None if sc is None else sc[0], max_chunk_rows=32, interpret=True)
    outs = [tk.chunk_gather_matmul_dma(tw, torch.from_numpy(x), torch.from_numpy(s),
                                       torch.from_numpy(z), None if sc is None else sc[1],
                                       max_chunk_rows=32, prefetch_depth=depth)
            for depth in DEPTHS]
    for y in outs:
        assert _rel_err(y.numpy(), y_ref) < 1e-5
        assert torch.equal(y, outs[0])  # depth-invariant, bit for bit


def test_k1_int8_saturation_and_zero_block():
    w = np.zeros((32, 128), np.float32)
    w[:8] = 4.0
    w[8:16] = -4.0
    w[16:24, 0] = 1e-3  # tiny-magnitude block; rows 24..31 stay an all-zero block
    jq, js = j_quant(jnp.asarray(w), 8)
    tq8, ts = tq.quantize_rows(torch.from_numpy(w), 8)
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tq8.max()) == 127 and int(tq8.min()) == -127 and float(ts[3]) == 0.0
    x = np.ones((1, 32), np.float32)
    s, z = np.array([0], np.int32), np.array([32], np.int32)
    y_ref = j_k1_ref(j_dequant(jq, js), jnp.asarray(x), s, z)
    y = tk.chunk_gather_matmul_dma(tq8, torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(z), ts, max_chunk_rows=32)
    assert _rel_err(y.numpy(), y_ref) < 1e-6
    assert bool(torch.isfinite(y).all())


@pytest.mark.parametrize("shape", [(64, 128), (256, 704), (2, 5, 16, 24)])
def test_quantize_rows_payload_exact(shape):
    rng = np.random.default_rng(sum(shape))
    w = rng.normal(0, 0.5, shape).astype(np.float32)
    tq8, ts = tq.quantize_rows(torch.from_numpy(w), 8)
    flat = w.reshape(-1, *w.shape[-2:])
    for i, wi in enumerate(flat):
        jq, js = j_quant(jnp.asarray(wi), 8)
        np.testing.assert_array_equal(tq8.reshape(flat.shape)[i].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.reshape(len(flat), -1)[i].numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize_rows(tq8.reshape(flat.shape)[0], ts.reshape(len(flat), -1)[0]).numpy(),
        np.asarray(j_dequant(*j_quant(jnp.asarray(flat[0]), 8))))


def test_quantize_params_layerwise_equals_reference():
    """``quantize_params`` quantizes a stacked (L, N, D) leaf layer by layer:
    payloads and scales equal the reference's over the whole stack."""
    from repro.kernels.quantize import quantize_params as j_quantize_params

    rng = np.random.default_rng(12)
    layers = {"wq": rng.normal(0, 0.5, (3, 64, 40)).astype(np.float32),
              "w_down": rng.normal(0, 0.5, (3, 96, 16)).astype(np.float32)}
    got = tq.quantize_params({k: torch.from_numpy(v) for k, v in layers.items()},
                             ("wq", "wk", "w_down"))
    want = j_quantize_params({k: jnp.asarray(v) for k, v in layers.items()},
                             ("wq", "wk", "w_down"))
    assert set(got) == set(want) == {"wq_q8", "wq_sc", "w_down_q8", "w_down_sc"}
    for key, leaf in want.items():
        assert got[key].dtype == (torch.int8 if key.endswith("_q8") else torch.float32)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(leaf))


def _mlp_inputs(rng, dtype, n=128, f=256, d=128):
    wg = _weights(rng, (n, f), dtype, 0.2)
    wu = _weights(rng, (n, f), dtype, 0.2)
    wd = _weights(rng, (f, d), dtype, 0.2)
    x = rng.normal(0, 1, (2, n)).astype(np.float32)
    hs, hz = _table(rng, n, 0.7, 64)
    fs, fz = _table(rng, f, 0.3, 64)
    k = max(n, f) // 8
    st = torch.zeros((2, k), dtype=torch.int32)
    sz = torch.zeros((2, k), dtype=torch.int32)
    st[0, : len(hs)], sz[0, : len(hz)] = hs, hz
    st[1, : len(fs)], sz[1, : len(fz)] = fs, fz
    return wg, wu, wd, x, st, sz


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("masked", [False, True])
def test_k2_plain_matches_reference_kernel(depth, dtype, masked):
    rng = np.random.default_rng(10 + depth)
    wg, wu, wd, x, st, sz = _mlp_inputs(rng, dtype)
    fmask = (rng.random(256) < 0.3).astype(np.float32) if masked else None
    jscales = tscales = None
    if dtype == "int8":
        jscales = (wg[2][0], wu[2][0], wd[2][0])
        tscales = (wg[2][1], wu[2][1], wd[2][1])
    y_ref, h_ref = j_k2(wg[0], wu[0], wd[0], jnp.asarray(x), jnp.asarray(st.numpy()),
                        jnp.asarray(sz.numpy()),
                        None if fmask is None else jnp.asarray(fmask), jscales,
                        max_chunk_rows=64, prefetch_depth=depth, interpret=True,
                        return_h=True)
    y, h = tk.chunk_gather_mlp_dma(wg[1], wu[1], wd[1], torch.from_numpy(x), st, sz,
                                   None if fmask is None else torch.from_numpy(fmask),
                                   tscales, max_chunk_rows=64, prefetch_depth=depth,
                                   return_h=True)
    assert _rel_err(h.numpy(), h_ref) < 1e-5
    assert _rel_err(y.numpy(), y_ref) < 1e-5
    if not masked:
        deq = [w[0].astype(jnp.float32) if w[2] is None else j_dequant(w[0], w[2][0])
               for w in (wg, wu, wd)]
        oracle = j_k2_ref(*deq, jnp.asarray(x), jnp.asarray(st.numpy()), jnp.asarray(sz.numpy()))
        assert _rel_err(y.numpy(), oracle) < 1e-5


@pytest.mark.parametrize("empty_lane", [0, 1])
def test_k2_empty_lane_is_exact_zero(empty_lane):
    rng = np.random.default_rng(20)
    wg, wu, wd, x, st, sz = _mlp_inputs(rng, "f32", 128, 128, 128)
    st[empty_lane] = 0
    sz[empty_lane] = 0
    y = tk.chunk_gather_mlp_dma(wg[1], wu[1], wd[1], torch.from_numpy(x), st, sz,
                                max_chunk_rows=64)
    assert float(y.abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_twin_equals_kernel_path_bitwise(dtype):
    """The reference backend's twin (every block of the pre-masked input)
    and the kernel path (only the chunk table's blocks) agree bit for bit
    on tables built from the mask — the port's byte-identity invariant."""
    rng = np.random.default_rng(30)
    n, f, d = 256, 704, 256
    mask = torch.from_numpy(rng.random(n) < 0.6)
    fmask = torch.from_numpy(rng.random(f) < 0.6)
    hst, hsz = tk.masks_to_block_tables(mask[None], 8, 512)
    fst, fsz = tk.masks_to_block_tables(fmask[None], 8, 512)
    x = torch.from_numpy(rng.normal(0, 1, (2, n)).astype(np.float32)).to(torch.bfloat16)
    kern = tbackend.ExecutionBackend.create("kernel")
    ref = tbackend.ExecutionBackend.create("reference")
    _, w, sc = _weights(rng, (n, d), dtype)
    s = None if sc is None else sc[1]
    assert torch.equal(kern.project(w, x, mask, hst[0], hsz[0], s),
                       ref.project(w, x, mask, hst[0], hsz[0], s))
    wg, wu, wd = (_weights(rng, shp, dtype, 0.2) for shp in ((n, f), (n, f), (f, d)))
    st = torch.zeros((2, f // 8), dtype=torch.int32)
    sz = torch.zeros((2, f // 8), dtype=torch.int32)
    st[0, : n // 8], sz[0, : n // 8] = hst[0], hsz[0]
    st[1], sz[1] = fst[0], fsz[0]
    scales = None if dtype != "int8" else (wg[2][1], wu[2][1], wd[2][1])
    yk, hk = kern.swiglu_mlp(wg[1], wu[1], wd[1], x, mask, fmask, st, sz, scales)
    yr, hr = ref.swiglu_mlp(wg[1], wu[1], wd[1], x, mask, fmask, st, sz, scales)
    assert torch.equal(hk, hr) and torch.equal(yk, yr)


def test_wrapper_contract_errors():
    w = torch.zeros((16, 128))
    x = torch.zeros((1, 16))
    s = z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="checksums"):  # one word per 8-row block: 2
        tk.chunk_gather_matmul_dma(w, x, s, z, checksums=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        tk.chunk_gather_matmul_dma(w, x, s, z, prefetch_depth=-1)
    with pytest.raises(ValueError):  # int8 payload without its scales lane
        tk.chunk_gather_matmul_dma(w.to(torch.int8), x, s, z)
    before = dict(tk.LAUNCHES)
    tk.chunk_gather_matmul_dma(w, x, s, z)  # CPU: the plain version, no launch
    assert tk.LAUNCHES == before


def test_matmul_dma_depth_deeper_than_steps():
    """The reference suite's depth-7 case (``test_dma_kernels.py``): a
    prefetch depth above the table's one step is accepted and changes no
    bit of y; the reference kernel (interpret mode) and its oracle agree.
    On the card the ring runs at ``ring_depth`` = min(depth, 3)."""
    rng = np.random.default_rng(7)
    w = rng.normal(0, 1, (16, 128)).astype(np.float32)
    x = rng.normal(0, 1, (1, 16)).astype(np.float32)
    s, z = np.array([0], np.int32), np.array([8], np.int32)
    y = tk.chunk_gather_matmul_dma(*(torch.from_numpy(a) for a in (w, x, s, z)),
                                   max_chunk_rows=8, prefetch_depth=7)
    jy = j_k1(*(jnp.asarray(a) for a in (w, x, s, z)), max_chunk_rows=8, prefetch_depth=7,
              interpret=True)
    assert _rel_err(y.numpy(), jy) < 1e-5
    assert _rel_err(y.numpy(), j_k1_ref(*(jnp.asarray(a) for a in (w, x, s, z)))) < 1e-5
    assert torch.equal(y, tk.chunk_gather_matmul_dma(
        *(torch.from_numpy(a) for a in (w, x, s, z)), max_chunk_rows=8, prefetch_depth=1))
    assert [tk.ring_depth(d) for d in (0, 1, 3, 4, 7)] == [0, 1, 3, 3, 3]
    assert tbackend.ExecutionBackend.create("kernel", prefetch_depth=7).prefetch_depth == 7


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(python3 chip_smoke.py runs them at full width)")
    return torch.device("cuda")


# K1-body cases that stress its partition of the work: batch 1, 8 and 9
# (two slabs of 8 rows), D = 256 and a ragged D, a table with fewer blocks
# than the CTA has lane groups, the empty table, one 512-row chunk, K far
# above the real chunks, blocks partly outside [0, N), overlapping chunks
# whose block list spans several windows of the list, and an x too large
# to hold whole (8 rows of N = 4096: per-block input records).
K1_CASES = ("b1", "b8", "b9", "d256", "ragged", "few", "empty", "one512", "k_far",
            "outside", "windows", "records")


def k1_case(rng, case, dtype):
    """(w (N, D) f32 numpy, x (B, N) f32 numpy, starts, sizes) for a case."""
    n, d, b = {"b1": (512, 256, 1), "b8": (512, 256, 8), "b9": (512, 256, 9),
               "d256": (2048, 256, 2), "ragged": (512, 208 if dtype == "int8" else 200, 2),
               "records": (4096, 256, 8)}.get(case, (1024, 256, 2))
    k = n // 8
    st, sz = np.zeros(k, np.int32), np.zeros(k, np.int32)
    if case == "few":
        st[:1], sz[:1] = 64, 16
    elif case == "one512":
        st[0], sz[0] = 512, 512
    elif case == "k_far":
        st[:2], sz[:2] = (64, 512), (16, 40)
    elif case == "outside":
        st[:3], sz[:3] = (-24, n - 16, 96), (48, 64, 8)
    elif case == "windows":
        st[:40], sz[:40] = 0, 512  # 40 x 64 blocks, over K1_WINDOW_BLOCKS
    elif case != "empty":
        s, z = _table(rng, n, 0.5, 512)
        st, sz = s.numpy(), z.numpy()
    w = rng.normal(0, 1, (n, d)).astype(np.float32)
    x = rng.normal(0, 1, (b, n)).astype(np.float32)
    return w, x, torch.from_numpy(st), torch.from_numpy(sz)


@pytest.mark.parametrize("case", K1_CASES)
def test_k1_block_list_equals_plain_walk(case):
    """The K1 body's closed-form block list (per-entry counts, exclusive
    scan, scatter) visits the plain walk's blocks, each once, in order."""
    rng = np.random.default_rng(70)
    w, _, st, sz = k1_case(rng, case, "bf16")
    for mcr in (512, 64, 8):
        assert tk.k1_block_list(st, sz, w.shape[0], mcr) == \
            tk._table_blocks(st, sz, w.shape[0], mcr)


@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("n,d,b,masked", [(2048, 2048, 2, False), (2048, 256, 2, False),
                                          (5632, 2048, 2, True), (2048, 2048, 1, True),
                                          (512, 208, 9, False), (5632, 2048, 16, True),
                                          (2048, 16384, 2, False)])
def test_k1_geometry_covers_every_output_once(dtype, n, d, b, masked):
    """Every output column lands in exactly one tile and every batch row in
    one slab; a tile is one 32-byte sector of a weight row, or one 16-byte
    copy where the grid would fill under half the SMs; a stage is whole
    rounds of the CTA's lane groups where it holds one; x is held whole where it fits, and the
    full-width tables fit in shared memory at every depth."""
    elem = {"bf16": 2, "f32": 4, "int8": 1}[dtype]
    for depth in range(tk.MAX_PREFETCH_DEPTH + 1):
        g = tk.k1_geometry(d, b, elem, 132, depth, n, masked)
        tile, (gx, gy), blocks = g["tile"], g["grid"], g["blocks"]
        cols = [c for t in range(gx) for c in range(t * tile, min(d, (t + 1) * tile))]
        assert cols == list(range(d))
        rows = [r for s in range(gy) for r in range(s * 8, min(b, s * 8 + 8))]
        assert rows == list(range(b))
        assert tile * elem == (16 if -(-d // (32 // elem)) * gy * 2 <= 132 else 32)
        lanes = tk.K1_WARPS * 32 // tile
        assert 32 % tile == 0 and blocks >= tk.K1_WARPS and (blocks < lanes or blocks % lanes == 0)
        assert tk.k1_smem_bytes(5632 // 8, elem, tile, blocks, b, depth, n, masked) \
            <= tk.SMEM_LIMIT_BYTES
        assert (tk._k1_xrec(b, masked, n) == 0) == ((min(b, 8) + masked) * n * 4 <= 80 * 1024)


@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("n,f,b", [(2048, 5632, 2), (2048, 5632, 1), (2048, 5632, 9),
                                   (256, 704, 2), (512, 200, 2), (4096, 256, 8)])
def test_k2_geometry_covers_every_output_once(dtype, n, f, b):
    """The body over two weight streams (gate and up: K2's phase 1, K4):
    every output column in one sector-wide tile (F = 5632 in bf16 gives 352
    CTAs of 16 columns), stages of at least a round of warps, the shared
    memory of both streams' tiles and partials within the limit at every
    depth for a full-width table, and its layout the one-stream layout plus
    the second stream's tiles, scales and partials."""
    elem = {"bf16": 2, "f32": 4, "int8": 1}[dtype]
    ragged = 208 if dtype == "int8" and f == 200 else f
    for depth in range(tk.MAX_PREFETCH_DEPTH + 1):
        g = tk.k1_geometry(ragged, b, elem, 132, depth, n, nmat=2)
        tile, (gx, gy), blocks = g["tile"], g["grid"], g["blocks"]
        assert [c for t in range(gx) for c in range(t * tile, min(ragged, (t + 1) * tile))] \
            == list(range(ragged))
        assert gy == -(-b // 8) and tile * elem in (16, 32) and blocks >= tk.K1_WARPS
        if (ragged, b, dtype) == (5632, 2, "bf16"):
            assert (tile, gx) == (16, 352)
        k = max(n, 5632) // 8
        two = tk.k1_smem_bytes(k, elem, tile, blocks, b, depth, n, nmat=2)
        assert two <= tk.SMEM_LIMIT_BYTES
        one = tk.k1_smem_bytes(k, elem, tile, blocks, b, depth, n)
        pad16 = -(-blocks * 4 // 16) * 16
        assert two - one == ((depth + 1) * (blocks * 9 * tile * elem + pad16)
                             + 2 * min(b, 8) * tile * tk._k1_pstride(blocks) * 4)


# InternVL2-76B's decode launches (d_model 8192, 64/8 heads of 128, d_ff
# 28672, batch 2): every site's table is padded to the widest site's
# N = 28672, so K = 3584 entries at every site
IVL_K = 28672 // 8
IVL_SITES = {  # name: (N, D, streams, x_mask)
    "q": (8192, 8192, 1, False), "k": (8192, 1024, 1, False), "o": (8192, 8192, 1, False),
    "gate_up": (8192, 28672, 2, False), "down": (28672, 8192, 1, True),
    "q_masked": (8192, 8192, 1, True)}


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("site", sorted(IVL_SITES))
def test_internvl2_geometry_fits_shared_memory(dtype, site):
    """At InternVL2-76B's widths every launch of the K1 body fits the
    card's shared memory at every ring depth with the full-width table;
    x is held whole (a 64 KB slab) for the unmasked batch-2 launches, and
    the masked ones (K2's phase 2, the N = 8192 masked edge case of the
    chip run) take the per-block input records; tiles are one 32-byte
    sector of a weight row (16 bytes for k/v); gate/up runs 1792 CTAs of 16
    columns in bf16 and 896 of 32 in int8."""
    n, d, nmat, masked = IVL_SITES[site]
    elem = {"bf16": 2, "int8": 1}[dtype]
    for depth in range(tk.MAX_PREFETCH_DEPTH + 1):
        g = tk.k1_geometry(d, 2, elem, 132, depth, n, masked, nmat)
        need = tk.k1_smem_bytes(IVL_K, elem, g["tile"], g["blocks"], 2, depth, n, masked, nmat)
        assert need <= tk.SMEM_LIMIT_BYTES, (depth, need)
        # k/v's 1024 columns in 32-byte tiles would fill under half the SMs
        assert g["blocks"] >= tk.K1_WARPS and g["tile"] * elem == (16 if site == "k" else 32)
        assert (tk._k1_xrec(2, masked, n) > 0) == masked
        if site == "gate_up":
            assert g["grid"] == ((1792, 1) if dtype == "bf16" else (896, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("case", K1_CASES)
@pytest.mark.parametrize("depth", (0, 1, 2, 3))
@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
def test_k2_phase1_and_k4_bitwise_equal_plain(cuda, depth, dtype, case):
    """The body over two streams (K2's phase 1 at every depth, K4 at depth
    1) on the K1 body's edge shapes: h bitwise equal to the plain gather."""
    from repro_torch.kernels.chunk_gather_swiglu import chunk_gather_swiglu

    rng = np.random.default_rng(80 + depth)
    wg, x, st, sz = k1_case(rng, case, dtype)
    _, tg, sg = _weights_from(wg, dtype)
    _, tu, su = _weights_from(rng.normal(0, 1, wg.shape).astype(np.float32), dtype)
    scales = None if sg is None else (sg[1].to(cuda), su[1].to(cuda))
    tg, tu, xs, st, sz = (t.to(cuda) for t in (tg, tu, torch.from_numpy(x), st, sz))
    want = tk.chunk_gather_swiglu_plain(tg, tu, xs, st, sz, scales)
    h = tk._launch_k2_gate_up(tg, tu, xs, st, sz, *(scales or (None, None)), 512, depth)
    assert torch.equal(h, want)
    if dtype != "int8" and depth == 1:
        assert torch.equal(chunk_gather_swiglu(tg, tu, xs, st, sz, tile_f=8), want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("mlp",) + K1_CASES)
@pytest.mark.parametrize("depth", (0, 1, 2, 3))
@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
def test_k1_k2_kernels_bitwise_equal_plain(cuda, depth, dtype, case):
    rng = np.random.default_rng(40 + depth)
    if case != "mlp":
        w, x, st, sz = k1_case(rng, case, dtype)
        _, tw, sc = _weights_from(w, dtype)
        xs = torch.from_numpy(x).to(cuda)
        sc = None if sc is None else sc[1]
        y = tk.chunk_gather_matmul_dma(tw.to(cuda), xs, st.to(cuda), sz.to(cuda),
                                       None if sc is None else sc.to(cuda),
                                       prefetch_depth=depth)
        assert torch.equal(y, tk.chunk_gather_matmul_plain(tw.to(cuda), xs, st.to(cuda),
                                                           sz.to(cuda),
                                                           None if sc is None else sc.to(cuda)))
        if case == "empty":
            assert float(y.abs().max()) == 0.0
        g = tk.k1_geometry(w.shape[1], x.shape[0], tw.element_size(),
                           torch.cuda.get_device_properties(cuda).multi_processor_count, depth,
                           w.shape[0])
        from repro_torch.kernels.build import library

        assert library("chunk_gather.cu").k1_smem_bytes(
            tk._WTYPE[tw.dtype], g["tile"], g["blocks"], x.shape[0], 0, w.shape[0], depth,
            st.shape[0], 1, 0) == tk.k1_smem_bytes(st.shape[0], tw.element_size(), g["tile"],
                                                g["blocks"], x.shape[0], depth, w.shape[0])
        return
    wg, wu, wd, x, st, sz = _mlp_inputs(rng, dtype, 256, 704, 256)
    tw = [w[1].to(cuda) for w in (wg, wu, wd)]
    sc = None if dtype != "int8" else tuple(w[2][1].to(cuda) for w in (wg, wu, wd))
    xs = torch.from_numpy(x).to(cuda)
    y = tk.chunk_gather_matmul_dma(tw[0], xs, st[0].to(cuda), sz[0].to(cuda),
                                   None if sc is None else sc[0], prefetch_depth=depth)
    y_plain = tk.chunk_gather_matmul_plain(tw[0], xs, st[0], sz[0],
                                           None if sc is None else sc[0])
    assert torch.equal(y, y_plain)
    yk, hk = tk.chunk_gather_mlp_dma(*tw, xs, st.to(cuda), sz.to(cuda), None, sc,
                                     prefetch_depth=depth, return_h=True)
    yp, hp = tk.chunk_gather_mlp_plain(*tw, xs, st, sz, None, sc)
    assert torch.equal(hk, hp) and torch.equal(yk, yp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_kernels_at_depth_beyond_the_ring(cuda, dtype):
    """Depths above MAX_PREFETCH_DEPTH run the ring at 3: K1 and K2 at depth
    7 equal depth 1 bitwise."""
    rng = np.random.default_rng(60)
    wg, wu, wd, x, st, sz = _mlp_inputs(rng, dtype, 256, 704, 256)
    tw = [w[1].to(cuda) for w in (wg, wu, wd)]
    sc = None if dtype != "int8" else tuple(w[2][1].to(cuda) for w in (wg, wu, wd))
    xs, st, sz = torch.from_numpy(x).to(cuda), st.to(cuda), sz.to(cuda)
    y = [tk.chunk_gather_matmul_dma(tw[0], xs, st[0], sz[0], None if sc is None else sc[0],
                                    prefetch_depth=d) for d in (1, 7)]
    assert torch.equal(y[0], y[1])
    h = [tk.chunk_gather_mlp_dma(*tw, xs, st, sz, None, sc, prefetch_depth=d, return_h=True)
         for d in (1, 7)]
    assert torch.equal(h[0][0], h[1][0]) and torch.equal(h[0][1], h[1][1])


@pytest.mark.gpu
def test_k5_kernel_equals_plain(cuda):
    from repro_torch.serving.sparse_exec import SparseExecution
    from repro_torch.configs import get_config

    cfg = get_config("tinyllama-1.1b").reduced()
    sp = SparseExecution(cfg, torch_device=cuda)
    rng = np.random.default_rng(50)
    lanes = cfg.n_layers * sp.batched.n_sites
    vs = torch.from_numpy(rng.random((lanes, sp.batched.n_max)).astype(np.float32))
    before = tchunk.LAUNCHES["greedy_select"]
    masks, sel = sp.batched.select(vs.to(cuda), sp.lane_budgets)
    assert tchunk.LAUNCHES["greedy_select"] == before + 1  # every layer's lanes at once
    cpu = SparseExecution(cfg, torch_device="cpu")
    masks_p, sel_p = cpu.batched.select(vs, cpu.lane_budgets)
    assert torch.equal(masks.cpu(), masks_p) and torch.equal(sel.cpu(), sel_p)
