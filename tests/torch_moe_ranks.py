"""The rank side of tests/test_torch_sharded_moe.py: what each of the four
spawned gloo ranks of a 2×2 (data, model) mesh runs, and the cases the
test module shares with them. It imports only the port (a spawned rank
imports this module, not the test module, which imports the JAX
package). The checks against one process (``hold_blocks``,
``hold_forward``, ``hold_grads``) are defined here once, for the test
module and for chip_smoke.py's phase 19 (``tests/torch_mesh_phase.py``)."""
import dataclasses
import datetime
import os
import pickle
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import moe_cfg_of
from repro_torch.sharding import MeshRules, use_rules
from repro_torch.sharding.specs import sharded_compute
from repro_torch.training.optimizer import whole
from torch_mesh_ranks import GRAD_COS, GRAD_REL
from torch_procs import drain

WORLD = 4
ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e")
# (arch, capacity factor, dispatch, batch): the reduced configs' own
# capacity factor (no drop) and the full configs' (drops bind), both
# dispatches, at a batch the data ranks divide; and one batch they do not
# (every data rank routes every row)
CASES = tuple((arch, cf, dispatch, 4) for arch in ARCHS for cf in (8.0, 1.25)
              for dispatch in ("scatter", "gather")) + (("olmoe-1b-7b", 1.25, "gather", 3),)
# x (b, s, d): t = b · 32 tokens
SEQ = 32


def moe_cfg(arch, cf, dispatch):
    return dataclasses.replace(moe_cfg_of(get_config(arch).reduced()), capacity_factor=cf,
                               dispatch=dispatch)


def inputs(arch, batch, seed=0):
    """Seeded f32 params, x and the cotangents of y and of the aux loss. The
    router leans to expert 0 (x has a positive mean, the router's column 0
    too), so that at capacity factor 1.25 its slots overflow."""
    cfg = moe_cfg(arch, 8.0, "scatter")
    rng = np.random.default_rng(seed)
    params = {name: (std * rng.normal(size=shape)).astype(np.float32)
              for name, (shape, std, _) in tmoe.moe_param_shapes(cfg).items()}
    params["router"][:, 0] += 0.02
    x = (0.5 + rng.normal(size=(batch, SEQ, cfg.d_model))).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    return {"params": params, "x": x, "g": g, "g_aux": 3.0}


def run(arch, cf, dispatch, data, rules=None):
    """``moe_ffn`` in f32 under ``rules`` (None: one process): y, aux, the
    drops, the x_buf blocks logged, and the gradients of <y, g> + g_aux ·
    aux with respect to x and every param, whole, as numpy."""
    cfg = moe_cfg(arch, cf, dispatch)
    axes = {name: a for name, (_, _, a) in tmoe.moe_param_shapes(cfg).items()}

    def place(v, logical):
        t = torch.from_numpy(v)
        return rules.distribute(t, logical) if rules is not None else t

    tmoe.DROP_LOG, tmoe.BLOCK_LOG = [], []
    try:
        with use_rules(rules), sharded_compute():
            params = {n: place(v, axes[n]).requires_grad_(True) for n, v in data["params"].items()}
            x = place(data["x"], ("batch", None, "act_embed")).requires_grad_(True)
            y, aux = tmoe.moe_ffn(x, params, cfg)
            loss = (y * place(data["g"], ("batch", None, "act_embed"))).sum() + \
                data["g_aux"] * aux
            names = sorted(params)
            grads = torch.autograd.grad(whole(loss) if rules else loss,
                                        [x] + [params[n] for n in names])
            out = {"y": whole(y).detach().numpy(), "aux": whole(aux).detach().numpy(),
                   "drops": [int(v) for v in tmoe.DROP_LOG],
                   "blocks": [(e0, c0, blk.numpy()) for e0, c0, blk in tmoe.BLOCK_LOG],
                   "grads": dict(zip(["x"] + names, (whole(g).numpy() for g in grads)))}
    finally:
        tmoe.DROP_LOG = tmoe.BLOCK_LOG = None
    return out


def one_process_buffer(arch, cf, dispatch, batch):
    """The 1×1 path's whole (E, cap, d) buffer on the case's inputs."""
    cfg = moe_cfg(arch, cf, dispatch)
    data = inputs(arch, batch)
    xt = torch.from_numpy(data["x"]).reshape(-1, cfg.d_model)
    x_buf, *_ = tmoe._dispatch(xt, torch.from_numpy(data["params"]["router"]), cfg,
                               cfg.capacity(xt.shape[0]))
    return x_buf.numpy()


def hold_blocks(mesh, case) -> float:
    """Every rank's x_buf block (``mesh``: the four ranks' results) is
    bitwise that block of the 1×1 buffer, and the four blocks differ (they
    tile it); the largest difference, 0."""
    buf = one_process_buffer(*case)
    e, cap, _ = buf.shape
    seen, worst = set(), 0.0
    for res in mesh:
        (e0, c0, blk), = res[case]["blocks"]
        assert blk.shape[0] < e and blk.shape[1] < cap  # a block, not the buffer
        want = buf[e0: e0 + blk.shape[0], c0: c0 + blk.shape[1]]
        np.testing.assert_array_equal(blk, want)
        worst = max(worst, float(np.abs(blk - want).max()) if blk.size else 0.0)
        seen.add((e0, c0))
    assert len(seen) == WORLD  # four distinct blocks tile the buffer
    return worst


def hold_forward(mesh, case, want) -> float:
    """y and the aux loss of every rank bitwise the 1×1 path's (``want``),
    and the drops over the data ranks adding up to its; the largest
    difference, 0."""
    worst = 0.0
    for res in mesh:
        np.testing.assert_array_equal(res[case]["y"], want["y"])
        np.testing.assert_array_equal(res[case]["aux"], want["aux"])
        worst = max(worst, float(np.abs(res[case]["y"] - want["y"]).max()))
    # a data rank logs its own rows' drops (every row's where the batch
    # does not divide over them): add model rank 0's of each
    split = case[3] % 2 == 0
    drops = sum(res[case]["drops"][0] for res in mesh
                if res["coords"][1] == 0 and (split or res["coords"][0] == 0))
    assert [drops] == want["drops"], (drops, want["drops"])
    assert (drops > 0) == (case[1] == 1.25)
    return worst


def hold_grads(mesh, case, want):
    """Every rank's gradients of x and every param within the f32 bounds
    of tests/test_torch_mesh_training.py (relative L2 GRAD_REL, cosine
    GRAD_COS) of the 1×1 path's (``want``: its gradients); (the largest
    relative distance, the smallest cosine)."""
    worst = (0.0, 1.0)
    for res in mesh:
        got = res[case]["grads"]
        assert set(got) == set(want)
        for name, w in want.items():
            g = got[name]
            assert np.isfinite(g).all(), name
            norm, dist_ = np.linalg.norm(w), np.linalg.norm(g - w)
            dot = float(np.dot(g.ravel(), w.ravel()))
            assert dist_ <= GRAD_REL * norm, name
            assert dot >= GRAD_COS * norm * np.linalg.norm(g), name
            worst = (max(worst[0], float(dist_ / norm) if norm else float(dist_)),
                     min(worst[1], dot / max(float(norm * np.linalg.norm(g)), 1e-300)))
    return worst


def rank_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        rules = MeshRules.for_mesh(mesh)
        res = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
        for case in CASES:
            res[case] = run(*case[:3], inputs(case[0], case[3]), rules)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        drain()
    finally:
        dist.destroy_process_group()


# the fake (4, 4) mesh's case: x (b, s, d) with b over the 4 data ranks,
# the full configs' capacity factor
FAKE_MESH, FAKE_BATCH, FAKE_SEQ, FAKE_CF = (4, 4), 8, 64, 1.25


def largest_allocations(arch):
    """The largest tensor (elements of a new storage) rank 0 of a fake
    (4, 4) mesh allocates inside ``moe_ffn``'s forward and inside its
    backward, under a ``CostCounter`` (local ops only; DTensor's
    whole-size propagation copies skipped). Needs this process's one
    default process group."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.launch.dryrun import _placed_empty
    from repro_torch.launch.mesh import make_dry_mesh

    class Largest(CostCounter):
        def __init__(self):
            super().__init__()
            self.largest = 0

        def _add_storage(self, t):
            if t.untyped_storage() not in self._storages:
                self.largest = max(self.largest, t.untyped_storage().nbytes() // t.element_size())
            super()._add_storage(t)

    cfg = moe_cfg(arch, FAKE_CF, "scatter")
    mesh = make_dry_mesh(FAKE_MESH, ("data", "model"), "cpu")
    rules = MeshRules.for_mesh(mesh)
    with FakeTensorMode(), use_rules(rules), sharded_compute():
        params = {n: _placed_empty(shape, torch.float32, axes, rules, "cpu").requires_grad_(True)
                  for n, (shape, _, axes) in tmoe.moe_param_shapes(cfg).items()}
        x = _placed_empty((FAKE_BATCH, FAKE_SEQ, cfg.d_model), torch.float32,
                          ("batch", None, "act_embed"), rules, "cpu").requires_grad_(True)
        forward, backward = Largest(), Largest()
        with forward:
            y, aux = tmoe.moe_ffn(x, params, cfg)
        with backward:
            torch.autograd.grad((y.sum() + aux).full_tensor(), [x, *params.values()])
    dist.destroy_process_group()
    return {"forward": forward.largest, "backward": backward.largest}


if __name__ == "__main__":
    import sys

    torch.set_num_threads(1)
    with open(sys.argv[1], "wb") as f:
        pickle.dump({arch: largest_allocations(arch) for arch in ARCHS}, f)
