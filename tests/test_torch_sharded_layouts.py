"""What one rank of a mesh computes and holds, where the layouts split the
work: a prefill's KV cache made as each rank's block, the causal attention
of each model rank's query rows where the heads do not divide the model
axis, and the mLSTM, Mamba2 SSD and causal-conv regions split over
'model'. Each against the same port on one process (the 1×1 run).

On a 2×2 (data, model) mesh of four spawned gloo ranks
(``tests/torch_layout_ranks.py``), f32:
  * TinyLlama (reduced): prefill, then four greedy decode steps: the same
    tokens as 1×1, logits within 1e-5, each rank's K cache a quarter of
    the whole;
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
    shapes, not the mesh.

On a fake (4, 4) mesh (a subprocess; fake tensors):
  * reduced OLMoE's and Zamba2's prefill: each cache leaf's local storage
    is its whole size over the ranks its placements divide it over, and
    the largest allocation inside the prefill is less than one layer's
    whole K cache (the cache had been made whole, (L, b, S, kv, hd), on
    every rank);
  * 6 heads over 4 model ranks: the largest f32 storage of the attention's
    forward and backward is the score tile of s/4 query rows, not of s;
  * reduced xLSTM-125M's train step: the dry run that counts one chunk
    for all equals a trace of every step (FLOPs, bytes, collectives),
    with the mLSTM split over 'model'.
"""
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(__file__))
import torch_layout_ranks as ranks  # noqa: E402
from torch_mesh_ranks import GRAD_COS, GRAD_REL, _join  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# where a sum over model ranks is reordered (never bitwise)
SUM_RTOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the fake mesh's, started together; this
    process runs the 1×1 cases meanwhile."""
    tmp = tmp_path_factory.mktemp("sharded_layouts")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    subs = {mode: subprocess.Popen([sys.executable, os.path.join(ROOT, "tests",
                                                                 "torch_layout_ranks.py"),
                                    mode, str(tmp / f"{mode}.pkl")], env=env,
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for mode in ("fake", "steps")}
    procs = mp.start_processes(ranks.rank_main, args=(ranks.WORLD, str(tmp / "store"), str(tmp)),
                               nprocs=ranks.WORLD, join=False, start_method="spawn")
    data = ranks.case_inputs()
    one = {"decode": ranks.prefill_decode(), "mlstm": ranks.mlstm(data["mlstm"]),
           "ssd": ranks.ssd(data["ssd"]), "conv": ranks.conv(data["conv"])}
    for region in REGIONS:
        one[("by_rank", region)] = ranks.region_by_rank(region, data[region])
    for path in ranks.ATTN_PATHS:
        one[("attn", path)] = ranks.attention(path, data["attn"])
        one[("core", path)] = ranks.attention_core(path, data["core"])
    for sub in subs.values():
        out, _ = sub.communicate(timeout=600)
        assert sub.returncode == 0, out[-4000:]
    _join(procs)
    mesh = []
    for r in range(ranks.WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            mesh.append(pickle.load(f))
    fake = {}
    for mode in subs:
        with open(tmp / f"{mode}.pkl", "rb") as f:
            fake[mode] = pickle.load(f)
    fake["fake"]["steps"] = fake["steps"]
    return one, mesh, fake["fake"]


def _close(got, want, rtol=SUM_RTOL):
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= rtol * np.linalg.norm(want)


def _within_mesh_bounds(got, want):
    norm = np.linalg.norm(want)
    assert np.linalg.norm(got - want) <= GRAD_REL * norm
    assert float(np.dot(got.ravel(), want.ravel())) >= GRAD_COS * norm * np.linalg.norm(got)


# --- A: the cache as each rank's block -------------------------------------


def test_prefill_then_decode_tokens_equal_one_process(runs):
    one, mesh, _ = runs
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


@pytest.mark.parametrize("arch", ranks.PREFILL_ARCHS)
def test_fake_4x4_prefill_cache_is_each_ranks_block(runs, arch):
    _, _, fake = runs
    leaves = fake[arch]["leaves"]
    assert leaves
    for path, whole_bytes, local_bytes, n_ranks in leaves:
        assert local_bytes * n_ranks == whole_bytes, path
    # the KV leaves split over all 16 ranks (batch over data, kv heads over
    # model)
    assert any(n == 16 for _, _, _, n in leaves)


@pytest.mark.parametrize("arch", ranks.PREFILL_ARCHS)
def test_fake_4x4_prefill_largest_allocation_is_under_one_layers_cache(runs, arch):
    _, _, fake = runs
    assert fake[arch]["largest"] < fake[arch]["layer_k"]


# --- B: attention's query rows over 'model' --------------------------------


@pytest.mark.parametrize("path", ranks.ATTN_PATHS)
def test_attention_core_rows_bitwise_equal_one_process(runs, path):
    one, mesh, _ = runs
    want = one[("core", path)]
    for res in mesh:
        got = res[("core", path)]
        np.testing.assert_array_equal(got["out"], want["out"])
        np.testing.assert_array_equal(got["grads"][0], want["grads"][0])  # q
        for g, w in zip(got["grads"][1:], want["grads"][1:]):  # k, v: sums over ranks
            _close(g, w)


@pytest.mark.parametrize("path", ranks.ATTN_PATHS)
def test_attention_sublayer_odd_heads_agrees_with_one_process(runs, path):
    one, mesh, _ = runs
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


def test_fake_4x4_score_tile_is_a_quarter_of_the_rows(runs):
    _, _, fake = runs
    a = ranks.FAKE_ATTN
    assert fake["attention"]["seq_split"]
    # one data rank's row × every head × s/4 query rows × s keys
    tile = (a["b"] // 4) * a["h"] * (a["s"] // 4) * a["s"]
    for phase in ("forward", "backward"):
        assert fake["attention"][phase] == tile, phase


# --- C: the recurrences over 'model' ---------------------------------------


REGIONS = ("mlstm", "ssd", "conv")
# the outputs (flat: the mLSTM's y, C, n, m; the SSD's y, state; the
# conv's output) and the arguments (``torch_layout_ranks.mlstm`` / ``ssd``
# / ``conv``) whose values and gradients are bitwise those of 1×1, by
# position; the others agree within SUM_RTOL, see the module doc
BITWISE_OUT = {"mlstm": (1, 2, 3), "ssd": (0, 1), "conv": ()}
BITWISE_GRADS = {"mlstm": (2, 5), "ssd": (0, 1, 2, 3), "conv": ()}


def _equal(bitwise, got, want):
    if bitwise:
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want)


@pytest.mark.parametrize("region", REGIONS)
def test_region_outputs_and_blocks_equal_one_process(runs, region):
    one, mesh, _ = runs
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
def test_region_gradients_equal_one_process(runs, region):
    one, mesh, _ = runs
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
def test_region_bitwise_equals_each_ranks_own_one_process_run(runs, region):
    one, mesh, _ = runs
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


def test_fake_4x4_chunk_count_equals_every_step(runs):
    _, _, fake = runs
    chunks, steps = fake["chunks"], fake["steps"]
    for key in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device"):
        assert chunks[key] == steps[key], key
    assert chunks["collectives"]["counts"] == steps["collectives"]["counts"]
