"""Sharded serving at full width: four gloo ranks of a 2×2 (data, model)
serve mesh on the CPU against the unsharded engine, bitwise. At these
widths a CPU product of one data rank's rows rounds otherwise than the
product of the whole batch (the rounding follows the row count), so every
computation on a split-row path runs at the whole batch's row count on
every data rank (``sharding.serve.whole_rows``); this module holds that,
case by case (``torch_serve_ranks.WIDE_CASES``, batch 2, wbits 16, seed
0, depth cut, never width):

  * TinyLlama-1.1B, 1 layer, chunk: prefill, frames of 8, 8 and 1 tokens
    (no projector: a frame enters at d 2048), 6 decode tokens;
  * the same with ``dense`` (an empty plan) and ``dense_free`` (no sparse
    context), 6 decode tokens;
  * StarCoder2-3B, 1 layer, chunk and ``dense_free``, 6 tokens: its 3072 →
    49152 head rounds by its row count as StarCoder2-7B's 4608 → 49152
    does (``tools/row_count_probe.py``), and StarCoder2-7B's 1-layer
    process peaked at 2.45 GB;
  * Zamba2-7B as one group of 2 Mamba2 layers and the shared block once
    (attn_every 2: its group of 6 peaked at 3.14 GB), xLSTM-125M and
    Whisper-small whole (16 encoder frames), chunk, 6 tokens each.

Each holds each frame's returned hidden states, each rank's rows of every
cache tensor, every decode step's logits and the tokens bitwise to the 1×1
mesh's. One module-scoped spawn of four ranks (one intra-op thread each)
runs every case while this process runs the 1×1 side (~60 s on an
8-core x86 host, nothing else running).

Peak RSS per process (the same host, torch 2.13): each case alone in the
1×1 process, TinyLlama 0.88 GB, StarCoder2-3B 1.72, Zamba2-7B 1.60,
xLSTM-125M 0.88, Whisper-small 1.04; a rank, running every case in turn,
0.97 GB through TinyLlama and 2.00 from StarCoder2-3B on (its model-
sharded decode copies besides).
"""
import datetime
import os
import pickle
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.sharding import ServeMesh

sys.path.insert(0, os.path.dirname(__file__))
import torch_procs as procs  # noqa: E402
from torch_serve_ranks import WIDE_CASES, WORLD, _wide_serve, hold_wide  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401


def _rank_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = ServeMesh.create(2, 2, "cpu")
        res = {"coords": (mesh.rank("data"), mesh.rank("model"))}
        for case in WIDE_CASES:
            res[case] = _wide_serve(mesh, case)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        procs.drain()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the four ranks' results, the 1×1 runs): the ranks spawn first and
    this process serves the 1×1 runs while they work."""
    tmp = tmp_path_factory.mktemp("wide")
    rank_procs = procs.Ranks(_rank_main, (WORLD, str(tmp / "store"), str(tmp)), WORLD, tmp,
                             "full_width")
    try:
        single = {case: _wide_serve(None, case) for case in WIDE_CASES}
    except BaseException:
        rank_procs.stop()
        raise
    rank_procs.wait()
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, single


def test_ranks_hold_their_data_rows(runs):
    ranks, _ = runs
    assert sorted(r["coords"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert all(r[case]["rows"] == [r["coords"][0]] for case in WIDE_CASES)


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_full_width_2x2_is_the_1x1_mesh_bitwise(runs, case):
    """Each frame's hidden states, each rank's cache rows, every decode
    step's logits and the greedy tokens of the 2×2 mesh equal the 1×1
    mesh's, on every rank."""
    ranks, single = runs
    hold_wide([r[case] for r in ranks], single[case])
