"""What one rank of a mesh computes and holds, where the layouts split the
work: a prefill's KV cache made as each rank's block, the causal attention
of each model rank's query rows where the heads do not divide the model
axis, and the mLSTM, sLSTM, Mamba2 SSD and causal-conv regions split over
'model'. Each against the same port on one process (the 1×1 run).

The processes start together in one module fixture (``started``: the
ranks and the fake mesh's two subprocesses, ``tests/torch_procs.py``) and
each test waits only for those whose results it reads (``mesh``,
``fake``); ``one`` runs the 1×1 cases in this process meanwhile.

On a 2×2 (data, model) mesh of four spawned gloo ranks
(``tests/torch_layout_ranks.py``), f32:
  * TinyLlama (reduced): prefill, then four greedy decode steps: the same
    tokens as 1×1, logits within 1e-5, each rank's K cache a quarter of
    the whole; reduced xLSTM-125M (block 1 an sLSTM) alike: the same
    tokens, logits within 1e-5;
  * an attention sublayer of 3 heads over 1 kv head (Scout's GQA shape at
    a size the model axis of 2 does not divide), on the direct path and,
    with ``attention.BLOCKWISE_THRESHOLD`` lowered, the blockwise one: the
    rules split q's sequence over 'model'. The core's output and the
    gradient of q are bitwise those of 1×1: a query row's scores, softmax
    and output, and its gradient, are the same ops on the same operands
    on any rank. The gradients of k and v are partial sums over the two
    model ranks, added in another order than one process adds them, and
    the sublayer's output and gradients go through products over dims the
    mesh shards: those agree within the f32 bounds of
    tests/test_torch_mesh_training.py (relative L2 5e-2, cosine 0.995),
    and in fact to 1e-5;
  * the mLSTM scan split along C's value rows, the SSD by heads and the
    conv by channel, at the reduced configs' widths. Bitwise those of 1×1,
    and so each rank's own block of them: the mLSTM's final C, n and m and
    the gradients of its split arguments (v, the initial C); the SSD's y
    and state and the gradients of its x, B, C and step sizes. Each of
    those elements is the same ops on the same operands. Within 1e-5
    relative, for the reasons given: the mLSTM's y (C's rows times q is a
    batched matrix-vector product, and the CPU's picks its summation order
    by the number of rows, which the split halves); the gradients of the
    mLSTM's q, k, gates and initial n and m (whole on both model ranks:
    sums of each rank's rows' parts, in another order); the SSD's
    log-decay gradient (a sum over (q, q, h) tiles that the CPU vectorises
    over the head dim); the conv (its einsum over the taps takes another
    path at half the channels; its weights' gradients also sum over the
    data ranks' rows). Everything, those included, is bitwise the 1×1
    function run in one process on each rank's own block of the inputs
    (``torch_layout_ranks.region_by_rank``: no rules, no collective; the
    parts of a whole operand's or a weight's gradient added, two at a
    time, which is the same sum in either order): each rank computes op
    for op what one process computes on its rows, heads or channels, so
    the gap to the whole 1×1 run is the CPU's arithmetic at the smaller
    shapes, not the mesh;
  * the sLSTM split over 'model' by its gate columns (``xlstm.
    _slstm_region``: at 2 model ranks each rank two gates of every head,
    its half of the recurrent mix, the gate sums all-gathered each step,
    the state whole on both). Nothing of it is bitwise the whole 1×1 run:
    a rank's half of the recurrent mix is a product over half the gate
    columns, whose summation order the CPU picks by its shape, and every
    output and gradient depends on it; all within 1e-5 relative (2e-7 in
    fact). Bitwise ``torch_layout_ranks._slstm_by_rank``: the model ranks
    run in lockstep in one process, each on its block with the same ops,
    the gathered sums concatenated, the parts of a gradient added two at
    a time.

On a fake (4, 4) mesh (a subprocess; fake tensors):
  * reduced OLMoE's and Zamba2's prefill: each cache leaf's local storage
    is its whole size over the ranks its placements divide it over, and
    the largest allocation inside the prefill is less than one layer's
    whole K cache (the cache had been made whole, (L, b, S, kv, hd), on
    every rank);
  * 6 heads over 4 model ranks: the largest f32 storage of the attention's
    forward and backward is the score tile of s/4 query rows, not of s;
  * the sLSTM region's forward at reduced xLSTM-125M's widths: a rank's
    FLOPs are the 1×1 run's over 16, and each step issues one all-gather
    of its data rank's (b/4, 4d) gate sums;
  * reduced xLSTM-125M's train step: the dry run that counts one chunk
    for all equals a trace of every step (FLOPs, bytes, collectives),
    with the mLSTM split over 'model'.
"""
import os
import pickle
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_layout_ranks as ranks  # noqa: E402
import torch_procs as procs  # noqa: E402
from torch_mesh_ranks import GRAD_COS, GRAD_REL  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# where a sum over model ranks is reordered (never bitwise)
SUM_RTOL = 1e-5


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The fake mesh's two subprocesses and the four gloo ranks, started
    together when the module's first test needs any of them; a test waits
    only for what it reads (``one``, ``mesh``, ``fake``)."""
    tmp = tmp_path_factory.mktemp("sharded_layouts")
    subs = {mode: procs.Sub([os.path.join(ROOT, "tests", "torch_layout_ranks.py"), mode,
                             tmp / f"{mode}.pkl"], tmp, mode) for mode in ("fake", "steps")}
    rank_procs = procs.Ranks(ranks.rank_main, (ranks.WORLD, str(tmp / "store"), str(tmp)),
                             ranks.WORLD, tmp, "layouts")
    yield tmp, subs, rank_procs
    for p in (*subs.values(), rank_procs):
        p.stop()


@pytest.fixture(scope="module")
def one(started):
    """The 1×1 cases, run in this process while the others work."""
    data = ranks.case_inputs()
    res = {"decode": ranks.prefill_decode(), "xlstm_decode": ranks.xlstm_prefill_decode()}
    for region in REGIONS:
        res[region] = getattr(ranks, region)(data[region])
        res[("by_rank", region)] = ranks.region_by_rank(region, data[region])
    for path in ranks.ATTN_PATHS:
        res[("attn", path)] = ranks.attention(path, data["attn"])
        res[("core", path)] = ranks.attention_core(path, data["core"])
    return res


@pytest.fixture(scope="module")
def mesh(started):
    """The four gloo ranks' results (``torch_layout_ranks.rank_main``)."""
    tmp, _, rank_procs = started
    rank_procs.wait()
    res = []
    for r in range(ranks.WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def fake(started):
    """The fake (4, 4) mesh's results (``torch_layout_ranks.fake_main``),
    the trace of every step under "steps"."""
    tmp, subs, _ = started
    res = {}
    for mode, sub in subs.items():
        sub.wait()
        with open(tmp / f"{mode}.pkl", "rb") as f:
            res[mode] = pickle.load(f)
    res["fake"]["steps"] = res["steps"]
    return res["fake"]


def _close(got, want, rtol=SUM_RTOL):
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= rtol * np.linalg.norm(want)


def _within_mesh_bounds(got, want):
    norm = np.linalg.norm(want)
    assert np.linalg.norm(got - want) <= GRAD_REL * norm
    assert float(np.dot(got.ravel(), want.ravel())) >= GRAD_COS * norm * np.linalg.norm(got)


# --- A: the cache as each rank's block -------------------------------------


def test_prefill_then_decode_tokens_equal_one_process(one, mesh):
    want = one["decode"]
    for res in mesh:
        got = res["decode"]
        for g, w in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got["logits"], want["logits"]):
            _close(g, w)
        # (L, b, S, kv, hd): the batch over 2 data ranks, the kv heads over 2
        whole_k = ranks.get_config("tinyllama-1.1b").reduced()
        assert got["k_local"][1] == ranks.DECODE_BATCH // 2
        assert got["k_local"][3] == whole_k.n_cache_kv_heads // 2


def test_xlstm_prefill_then_decode_tokens_equal_one_process(one, mesh):
    """Reduced xLSTM-125M, its sLSTM block split over 'model' (each model
    rank its two gates' columns, the gate sums all-gathered a step)."""
    want = one["xlstm_decode"]
    for res in mesh:
        got = res["xlstm_decode"]
        for g, w in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got["logits"], want["logits"]):
            _close(g, w)


@pytest.mark.parametrize("arch", ranks.PREFILL_ARCHS)
def test_fake_4x4_prefill_cache_is_each_ranks_block(fake, arch):
    leaves = fake[arch]["leaves"]
    assert leaves
    for path, whole_bytes, local_bytes, n_ranks in leaves:
        assert local_bytes * n_ranks == whole_bytes, path
    # the KV leaves split over all 16 ranks (batch over data, kv heads over
    # model)
    assert any(n == 16 for _, _, _, n in leaves)


@pytest.mark.parametrize("arch", ranks.PREFILL_ARCHS)
def test_fake_4x4_prefill_largest_allocation_is_under_one_layers_cache(fake, arch):
    assert fake[arch]["largest"] < fake[arch]["layer_k"]


# --- B: attention's query rows over 'model' --------------------------------


@pytest.mark.parametrize("path", ranks.ATTN_PATHS)
def test_attention_core_rows_bitwise_equal_one_process(one, mesh, path):
    want = one[("core", path)]
    for res in mesh:
        got = res[("core", path)]
        np.testing.assert_array_equal(got["out"], want["out"])
        np.testing.assert_array_equal(got["grads"][0], want["grads"][0])  # q
        for g, w in zip(got["grads"][1:], want["grads"][1:]):  # k, v: sums over ranks
            _close(g, w)


@pytest.mark.parametrize("path", ranks.ATTN_PATHS)
def test_attention_sublayer_odd_heads_agrees_with_one_process(one, mesh, path):
    want = one[("attn", path)]
    assert not want["seq_split"]
    for res in mesh:
        got = res[("attn", path)]
        assert got["seq_split"]
        _within_mesh_bounds(got["out"], want["out"])
        _close(got["out"], want["out"])
        for g, w in zip(got["grads"], want["grads"]):
            _within_mesh_bounds(g, w)
            _close(g, w)


def test_fake_4x4_score_tile_is_a_quarter_of_the_rows(fake):
    a = ranks.FAKE_ATTN
    assert fake["attention"]["seq_split"]
    # one data rank's row × every head × s/4 query rows × s keys
    tile = (a["b"] // 4) * a["h"] * (a["s"] // 4) * a["s"]
    for phase in ("forward", "backward"):
        assert fake["attention"][phase] == tile, phase


# --- C: the recurrences over 'model' ---------------------------------------


REGIONS = ("mlstm", "ssd", "conv", "slstm")
# the outputs (flat: the mLSTM's y, C, n, m; the SSD's y, state; the
# conv's output) and the arguments (``torch_layout_ranks.mlstm`` / ``ssd``
# / ``conv``) whose values and gradients are bitwise those of 1×1, by
# position; the others agree within SUM_RTOL, see the module doc
BITWISE_OUT = {"mlstm": (1, 2, 3), "ssd": (0, 1), "conv": (), "slstm": ()}
BITWISE_GRADS = {"mlstm": (2, 5), "ssd": (0, 1, 2, 3), "conv": (), "slstm": ()}


def _equal(bitwise, got, want):
    if bitwise:
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want)


@pytest.mark.parametrize("region", REGIONS)
def test_region_outputs_and_blocks_equal_one_process(one, mesh, region):
    want = one[region]["out"]
    for res in mesh:
        got = res[region]
        for i, (g, w) in enumerate(zip(got["out"], want)):
            _equal(i in BITWISE_OUT[region], g, w)
        # each rank's block is the 1×1 output's block at its coordinates
        for i, ((blk, placements), w) in enumerate(zip(got["local"], want)):
            _equal(i in BITWISE_OUT[region], blk,
                   w[_block_index(blk.shape, placements, res["coords"])])


def _block_index(local_shape, placements, coords):
    """The slice of the whole output that a rank at ``coords`` (data,
    model) holds, from its placements' string (Shard(dim) per mesh dim)."""
    index = [slice(None)] * len(local_shape)
    for coord, (_, dim) in zip(coords, re.findall(r"(Shard\(dim=(\d+)\)|Replicate\(\))",
                                                  placements)):
        if dim:
            n = local_shape[int(dim)]
            index[int(dim)] = slice(coord * n, (coord + 1) * n)
    return tuple(index)


@pytest.mark.parametrize("region", REGIONS)
def test_region_gradients_equal_one_process(one, mesh, region):
    want = one[region]["grads"]
    for res in mesh:
        got = res[region]["grads"]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            if i in BITWISE_GRADS[region]:
                np.testing.assert_array_equal(g, w)
            else:
                _close(g, w)


@pytest.mark.parametrize("region", REGIONS)
def test_region_bitwise_equals_each_ranks_own_one_process_run(one, mesh, region):
    want = one[("by_rank", region)]
    for res in mesh:
        got = res[region]
        for g, w in zip(got["out"], want["out"]):
            np.testing.assert_array_equal(g, w)
        for (blk, placements), w in zip(got["local"], want["out"]):
            np.testing.assert_array_equal(blk, w[_block_index(blk.shape, placements,
                                                              res["coords"])])
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            np.testing.assert_array_equal(g, w)


def test_fake_4x4_slstm_splits_the_product_and_gathers_each_step(fake):
    """The sLSTM region on 4 × 4 ranks: a rank's FLOPs (the recurrent mix,
    the region's one product) are the 1×1 run's over 16 (its data rank's
    rows, its gate's columns), and each step issues one collective, an
    all-gather of the (b/4, 4d) gate sums over 'model'."""
    f, d = ranks.FAKE_SLSTM, ranks._X.d_model
    got, whole = fake["slstm"]["mesh"], fake["slstm"]["one"]
    assert whole["flops"] > 0 and whole["collective_bytes"] == 0
    assert got["flops"] * 16 == whole["flops"]
    counts = got["collectives"]["counts"]
    assert counts == {**{k: 0 for k in counts}, "all-gather": f["s"]}
    assert got["collective_per_kind"]["all-gather"] == f["s"] * (f["b"] // 4) * 4 * d * 4


def test_fake_4x4_chunk_count_equals_every_step(fake):
    chunks, steps = fake["chunks"], fake["steps"]
    for key in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device"):
        assert chunks[key] == steps[key], key
    assert chunks["collectives"]["counts"] == steps["collectives"]["counts"]
