"""The all-layer refresh (``SparseExecution.refresh_step``: one selection
over every site of every layer, one K5 walk over L·S lanes) against the
reference's per-layer refreshes (``repro.serving.sparse_exec``'s
``refresh_layer``, one layer's S lanes at a time, run on each layer's slice
of its plan), on the CPU at ``tinyllama-1.1b --reduced`` cut to 3 layers.

Tolerances: the importances are dyadic (k/8), whose prefix sums are exact
in both packages' summation orders (as in ``test_torch_selection``), so
masks, kernel tables and the hit/miss/bytes counters are compared exactly.
The per-layer I/O estimates are f32 sums of run latencies that the two
packages take in another order: rtol 1e-6, as in ``test_torch_selection``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.serving.sparse_exec import SparseExecution as JSparse
from repro_torch.configs import get_config
from repro_torch.core import chunking as tchunk
from repro_torch.serving.sparse_exec import SparseExecution

CFG = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), n_layers=3)
JCFG = dataclasses.replace(jget("tinyllama-1.1b").reduced(), n_layers=3)


def _record(plan, jplans, rng):
    """A step's importances: dyadic values for every site and layer, the
    same in the port's plan and in each layer's slice of the reference's."""
    for kind, entry in plan.items():
        v = (rng.integers(0, 64, tuple(entry["pending"].shape)) / 8.0).astype(np.float32)
        entry["pending"].copy_(torch.from_numpy(v))
        for layer, jplan in enumerate(jplans):
            jplan[kind] = {**jplan[kind], "pending": jnp.asarray(v[layer])}


@pytest.mark.parametrize("interval", [1, 3])
@pytest.mark.parametrize("method", ["chunk", "topk"])
def test_all_layer_refresh_equals_per_layer_refreshes(method, interval):
    """Five decode steps, refreshing every ``interval`` steps: after each
    step the port's plan (masks, kernel tables, counters) and per-layer I/O
    estimates equal the reference's per-layer refreshes; reuse steps cost
    zero I/O."""
    sp = SparseExecution(CFG, sparsity=0.4, method=method, torch_device="cpu")
    js = JSparse(JCFG, device="nano", sparsity=0.4, method=method)
    assert sp.site_order == js.site_order
    refresh_layer = jax.jit(lambda pl, r: js.refresh_layer(pl, r))
    plan = sp.init_plan(CFG.n_layers)
    jfull = js.init_plan(JCFG.n_layers)
    jplans = [jax.tree_util.tree_map(lambda a, i=layer: a[i], jfull)
              for layer in range(JCFG.n_layers)]
    rng = np.random.default_rng(10 * interval + len(method))
    for step in range(5):
        refresh = step % interval == 0
        before = dict(tchunk.LAUNCHES)
        io = sp.refresh_step(plan, refresh)
        assert tchunk.LAUNCHES == before  # the CPU takes the plain walk
        want = []
        for layer in range(JCFG.n_layers):
            jplans[layer], lat = refresh_layer(jplans[layer], jnp.bool_(refresh))
            want.append(np.asarray(lat))
        assert io.shape == (CFG.n_layers,) and io.dtype == torch.float32
        np.testing.assert_allclose(io.numpy(), np.stack(want), rtol=1e-6)
        assert bool((io > 0).all()) == refresh
        for kind in sp.site_order:
            for key, leaf in plan[kind].items():
                ref = np.stack([np.asarray(jp[kind][key]) for jp in jplans])
                np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=f"{step} {kind} {key}")
        _record(plan, jplans, rng)


@pytest.mark.parametrize("seed", range(3))
def test_greedy_select_over_all_lanes_equals_per_layer_calls(seed):
    """One walk over L·S lanes equals L walks over S lanes, and the batched
    selector's (L·S)-lane select equals L one-layer selects."""
    sp = SparseExecution(CFG, sparsity=0.4, torch_device="cpu")
    b = sp.batched
    n_layers = CFG.n_layers
    rng = np.random.default_rng(seed)
    vs = torch.from_numpy(rng.random((n_layers, b.n_sites, b.n_max)).astype(np.float32))
    starts, sizes = b.sorted_candidates(vs)
    assert starts.shape == (n_layers, b.n_sites, b.starts.shape[1])
    lanes = n_layers * b.n_sites
    masks, sel = tchunk.greedy_select(starts.reshape(lanes, -1), sizes.reshape(lanes, -1),
                                      sp.lane_budgets, sp.lane_min_sizes, b.n_max)
    all_masks, all_sel = b.select(vs.reshape(lanes, b.n_max), sp.lane_budgets,
                                  sp.lane_min_sizes)
    for layer in range(n_layers):
        s_l, z_l = b.sorted_candidates(vs[layer])
        assert torch.equal(s_l, starts[layer]) and torch.equal(z_l, sizes[layer])
        m_l, sel_l = tchunk.greedy_select(s_l, z_l, sp._budgets, b.min_sizes, b.n_max)
        rows = slice(layer * b.n_sites, (layer + 1) * b.n_sites)
        assert torch.equal(masks[rows], m_l) and torch.equal(sel[rows], sel_l)
        bm, bsel = b.select(vs[layer], sp._budgets)
        assert torch.equal(all_masks[rows], bm) and torch.equal(all_sel[rows], bsel)


def test_batched_select_rejects_a_partial_layer():
    sp = SparseExecution(CFG, torch_device="cpu")
    b = sp.batched
    with pytest.raises(ValueError, match="must be"):
        b.select(torch.zeros((b.n_sites + 1, b.n_max)), sp.lane_budgets)


def test_refresh_step_rejects_a_plan_of_another_depth():
    """The lanes' budgets are built once for the model's depth: a plan of
    another depth raises instead of misaligning them."""
    sp = SparseExecution(CFG, torch_device="cpu")
    with pytest.raises(ValueError, match=f"{CFG.n_layers} layers"):
        sp.refresh_step(sp.init_plan(CFG.n_layers - 1), True)
