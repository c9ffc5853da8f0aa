"""The MoE dispatch sharded over a training mesh (``models/moe.py``,
``_moe_ffn_blocks``): each rank fills and computes its block of the
expert buffer, its experts over 'model' × its capacity slots over the data
axes, as the reference's ``expert_capacity`` layout asks.

On a 2×2 (data, model) mesh of four spawned gloo ranks
(``tests/torch_moe_ranks.py``), reduced OLMoE (top-2) and Scout (top-1 and
the shared expert), f32, the ``scatter`` and ``gather`` dispatches, at
capacity factor 8.0 and 1.25 (where the router, leaning to expert 0,
drops), at batch 4 (rows split over the data ranks) and, once, batch 3
(every data rank routes every row), against the same ``moe_ffn`` in this
process (the 1×1 path):
  * each rank's x_buf block is bitwise that block of the 1×1 buffer;
  * the output and the aux loss are bitwise equal, and the drops over the
    data ranks add up to the 1×1 path's;
  * the gradients of x and every param agree within the f32 bounds of
    tests/test_torch_mesh_training.py (relative L2 5e-2, cosine 0.995).

On a fake (4, 4) mesh (a subprocess: torch's fake process group is its
process's one default group; fake tensors), the largest tensor rank 0
allocates inside ``moe_ffn`` is at most t·d elements in the forward and,
for OLMoE, in the backward; Scout's backward holds its shared expert's
(t, d_ff) gradient, a dense layer outside the dispatch. The replicated
dispatch this replaced built the whole (E, cap, d) buffer on every rank:
E·cap·d elements, more than t·d here.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.models import moe as tmoe

sys.path.insert(0, os.path.dirname(__file__))
import torch_moe_ranks as ranks  # noqa: E402
from torch_mesh_ranks import GRAD_COS, GRAD_REL, _join  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = [f"{a.split('-')[0]}-cf{cf}-{disp}-b{b}" for a, cf, disp, b in ranks.CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the fake mesh's allocations, started
    together; this process runs the 1×1 path meanwhile."""
    tmp = tmp_path_factory.mktemp("sharded_moe")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    sub = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_moe_ranks.py"),
                            str(tmp / "largest.pkl")], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    procs = mp.start_processes(ranks.rank_main, args=(ranks.WORLD, str(tmp / "store"), str(tmp)),
                               nprocs=ranks.WORLD, join=False, start_method="spawn")
    one = {case: ranks.run(*case[:3], ranks.inputs(case[0], case[3])) for case in ranks.CASES}
    out, _ = sub.communicate(timeout=600)
    assert sub.returncode == 0, out[-4000:]
    _join(procs)
    mesh = []
    for r in range(ranks.WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            mesh.append(pickle.load(f))
    with open(tmp / "largest.pkl", "rb") as f:
        largest = pickle.load(f)
    return one, mesh, largest


def _one_process_buffer(arch, cf, dispatch, batch):
    """The 1×1 path's whole (E, cap, d) buffer on the case's inputs."""
    cfg = ranks.moe_cfg(arch, cf, dispatch)
    data = ranks.inputs(arch, batch)
    xt = torch.from_numpy(data["x"]).reshape(-1, cfg.d_model)
    x_buf, *_ = tmoe._dispatch(xt, torch.from_numpy(data["params"]["router"]), cfg,
                               cfg.capacity(xt.shape[0]))
    return x_buf.numpy()


@pytest.mark.parametrize("case", ranks.CASES, ids=IDS)
def test_each_rank_fills_its_block_of_the_one_process_buffer(runs, case):
    _, mesh, _ = runs
    buf = _one_process_buffer(*case)
    e, cap, _ = buf.shape
    seen = set()
    for res in mesh:
        (e0, c0, blk), = res[case]["blocks"]
        assert blk.shape[0] < e and blk.shape[1] < cap  # a block, not the buffer
        np.testing.assert_array_equal(blk, buf[e0: e0 + blk.shape[0], c0: c0 + blk.shape[1]])
        seen.add((e0, c0))
    assert len(seen) == ranks.WORLD  # four distinct blocks tile the buffer


@pytest.mark.parametrize("case", ranks.CASES, ids=IDS)
def test_forward_aux_and_drops_equal_one_process(runs, case):
    one, mesh, _ = runs
    want = one[case]
    for res in mesh:
        np.testing.assert_array_equal(res[case]["y"], want["y"])
        np.testing.assert_array_equal(res[case]["aux"], want["aux"])
    # a data rank logs its own rows' drops (every row's where the batch
    # does not divide over them): add model rank 0's of each
    split = case[3] % 2 == 0
    drops = sum(res[case]["drops"][0] for res in mesh
                if res["coords"][1] == 0 and (split or res["coords"][0] == 0))
    assert [drops] == want["drops"]
    assert (drops > 0) == (case[1] == 1.25)


@pytest.mark.parametrize("case", ranks.CASES, ids=IDS)
def test_gradients_agree_with_one_process(runs, case):
    one, mesh, _ = runs
    want = one[case]["grads"]
    for res in mesh:
        got = res[case]["grads"]
        assert set(got) == set(want)
        for name, w in want.items():
            g = got[name]
            assert np.isfinite(g).all(), name
            norm = np.linalg.norm(w)
            assert np.linalg.norm(g - w) <= GRAD_REL * norm, name
            assert float(np.dot(g.ravel(), w.ravel())) >= GRAD_COS * norm * np.linalg.norm(g), name


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_fake_4x4_largest_allocation_is_at_most_t_by_d(runs, arch):
    _, _, largest = runs
    cfg = ranks.moe_cfg(arch, ranks.FAKE_CF, "scatter")
    t = ranks.FAKE_BATCH * ranks.FAKE_SEQ
    td = t * cfg.d_model
    assert largest[arch]["forward"] <= td
    assert largest[arch]["backward"] <= (t * cfg.d_ff if cfg.shared_expert else td)
    # the replicated dispatch's whole buffer at these sizes
    cap = cfg.capacity(t)
    x_buf, *_ = tmoe._dispatch(torch.zeros((t, cfg.d_model)),
                               torch.zeros((cfg.d_model, cfg.n_experts)), cfg, cap)
    assert x_buf.numel() == cfg.n_experts * cap * cfg.d_model > td
