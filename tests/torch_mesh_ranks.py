"""The rank side of tests/test_torch_mesh_training.py: what each of the
four spawned gloo ranks of a 2×2 (data, model) mesh runs, and the settings
the test module shares with them. It imports only the port (a spawned
rank imports this module, not the test module, which imports the JAX
package). The comparisons of a step with another (``hold``,
``hold_mesh_step``) are defined here once, for the test module and for
chip_smoke.py's phase 19 (``tests/torch_mesh_phase.py``)."""
import contextlib
import dataclasses
import datetime
import io
import os
import pathlib
import pickle
import re
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config as tget
from repro_torch.data import DataConfig, lm_batches
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.common import tree_leaves
from repro_torch.sharding import MeshRules, use_rules
from repro_torch.sharding.specs import sharded_compute
from repro_torch.training import AdamWConfig, Trainer, load_checkpoint
from repro_torch.training.optimizer import whole
from torch_procs import drain

WORLD = 4
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)
BATCH, SEQ, LOSS_CHUNK = 2, 32, 16
METRIC_RTOL = {"loss": 5e-3, "ce": 5e-3, "moe_aux": 5e-3, "grad_norm": 2e-2, "lr": 1e-6}
GRAD_REL, GRAD_COS, M_REL, V_REL = 5e-2, 0.995, 5e-2, 1e-1
PIECE_TOL = 1e-4
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# case → (arch, fsdp, optimized_for(2))
CASES = {
    "tinyllama": ("tinyllama-1.1b", False, False),
    "tinyllama-fsdp": ("tinyllama-1.1b", True, False),
    "starcoder2-3b": ("starcoder2-3b", False, False),
    "granite-3-2b": ("granite-3-2b", True, False),
    "internvl2": ("internvl2-76b", False, False),
    "olmoe": ("olmoe-1b-7b", False, False),
    "olmoe-ep": ("olmoe-1b-7b", True, True),
    "scout-ep": ("llama4-scout-17b-a16e", False, True),
    "zamba2": ("zamba2-7b", False, False),
    "xlstm": ("xlstm-125m", False, False),
    "whisper": ("whisper-small", True, False),
}
FAMILIES = ("tinyllama-1.1b", "internvl2-76b", "olmoe-1b-7b", "starcoder2-3b", "granite-3-2b",
            "llama4-scout-17b-a16e", "zamba2-7b", "xlstm-125m", "whisper-small")
CLI = ["--arch", "tinyllama-1.1b", "--reduced", "--steps", "2", "--batch", "2", "--seq", "32",
       "--log-every", "1", "--torch-device", "cpu"]
ROOT = pathlib.Path(__file__).resolve().parents[1]
# (heads, batch, positions) for ``_want_seq_shard_map`` on the 2×2 mesh
WANT_CASES = ((3, 2, 4096), (3, 2, 2048), (4, 2, 4096), (3, 3, 4096), (3, 2, 4097))
# the reference CLI's line: f"step {i:5d} loss {:.4f} ce {:.4f} gnorm {:.2f} lr {:.2e} ..."
LINE = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) ce (\d+\.\d{4}) gnorm (\d+\.\d{2}) "
                  r"lr (\d\.\d{2}e[-+]\d{2}) \d+\.\d{2}s/step$")


def _cfg(get, arch, optimized):
    cfg = get(arch).reduced()
    return cfg.optimized_for(2) if optimized else cfg


def _batch(cfg):
    return {k: torch.from_numpy(v)
            for k, v in next(lm_batches(cfg, DataConfig(batch=BATCH, seq_len=SEQ, seed=3))).items()}


def _np_tree(tree):
    """{path: f32 numpy} of a (possibly DTensor) tree; a collective for
    DTensors, so every rank calls it."""
    return {path: whole(leaf).detach().float().numpy() for path, leaf in tree_leaves(tree)}


def _step(cfg, rules, dtype="bf16", keep=True):
    """One seed-0 train step in the compute ``dtype`` ("bf16", the port's,
    or "f32", both packages' ``COMPUTE_DTYPE`` set as in
    tests/test_torch_families.py): the metrics as floats, the count of
    sharded param leaves, the all_to_all counts and, with ``keep``, the
    initial params and the moments, whole, as numpy (gathered on every
    rank: a collective)."""
    old = tmodel.COMPUTE_DTYPE
    tmodel.COMPUTE_DTYPE = DTYPES[dtype]
    try:
        trainer = Trainer(tbuild(cfg), AdamWConfig(**OPT), loss_chunk=LOSS_CHUNK)
        for key in tmoe.ALL_TO_ALL_COUNT:
            tmoe.ALL_TO_ALL_COUNT[key] = 0
        with use_rules(rules):
            params, state = trainer.init_state(seed=0, device="cpu", rules=rules)
            sharded = sum(type(leaf).__name__ == "DTensor"
                          and any(p.is_shard() for p in leaf.placements)
                          for _, leaf in tree_leaves(params))
            init = _np_tree(params)
            params, state, m = trainer.train_step(params, state, _batch(cfg))
            out = {"metrics": {k: float(v) for k, v in m.items()}, "sharded": sharded,
                   "a2a": dict(tmoe.ALL_TO_ALL_COUNT)}
            m_np, v_np = _np_tree(state.m), _np_tree(state.v)
    finally:
        tmodel.COMPUTE_DTYPE = old
    if keep:
        out.update(m=m_np, v=v_np, init=init)
    return out


def rel_cos(a, b):
    """(relative L2 distance of a from b, cosine of a and b), in f64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    if nb == 0:
        return float(np.linalg.norm(a)), 1.0
    return (float(np.linalg.norm(a - b) / nb),
            float((a * b).sum() / max(np.linalg.norm(a) * nb, 1e-300)))


def step_grads(step):
    """The clipped-then-unclipped gradients from the first step's m."""
    scale = min(1.0, 1.0 / max(step["metrics"]["grad_norm"], 1e-9))
    return {k: m / ((1 - 0.9) * scale) for k, m in step["m"].items()}


def hold(got, want, moments=True):
    """A step's results (``_step``) held to another's: every metric within
    METRIC_RTOL (relative, at least 1e-12 absolute) and finite; with
    ``moments``, every leaf's gradient (from m) within GRAD_REL relative L2
    and GRAD_COS cosine, m within M_REL and v within V_REL. Raises
    AssertionError naming the first that is not; returns the largest
    relative difference of each kind (and the smallest gradient cosine)."""
    worst = {"metric_rel": 0.0}
    for key, rtol in METRIC_RTOL.items():
        g, w = got["metrics"][key], want["metrics"][key]
        assert np.isfinite(g), key
        assert abs(g - w) <= max(rtol * abs(w), 1e-12), (key, g, w)
        worst["metric_rel"] = max(worst["metric_rel"], abs(g - w) / max(abs(w), 1e-12))
    if not moments:
        return worst
    assert sorted(got["m"]) == sorted(want["m"])
    worst.update(grad_rel=0.0, grad_cos=1.0, m_rel=0.0, v_rel=0.0)
    g_got, g_want = step_grads(got), step_grads(want)
    for key in got["m"]:
        rel, cos = rel_cos(g_got[key], g_want[key])
        assert rel <= GRAD_REL and cos >= GRAD_COS, (key, rel, cos)
        m_rel, v_rel = rel_cos(got["m"][key], want["m"][key])[0], \
            rel_cos(got["v"][key], want["v"][key])[0]
        assert m_rel <= M_REL, key
        assert v_rel <= V_REL, key
        worst.update(grad_rel=max(worst["grad_rel"], rel), grad_cos=min(worst["grad_cos"], cos),
                     m_rel=max(worst["m_rel"], m_rel), v_rel=max(worst["v_rel"], v_rel))
    return worst


def hold_mesh_step(steps, want, moments=True):
    """The ranks' results of one mesh step (``steps``, rank 0's first: it
    alone keeps the moments): the same metrics on every rank, params
    sharded, and rank 0's held to ``want`` (``hold``, whose largest
    differences it returns)."""
    got = steps[0]
    assert all(s["metrics"] == got["metrics"] for s in steps), "the ranks' metrics differ"
    assert got["sharded"] > 0
    return hold(got, want, moments)


def _moe_ep(mesh, inputs):
    """The expert-parallel MoE on the mesh: y, aux and the gradients of
    <y, g> with respect to x and every param, whole."""
    cfg = tmoe.MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=32, capacity_factor=8.0,
                         dispatch="ep_shard_map")
    rules = MeshRules.for_mesh(mesh)
    for key in tmoe.ALL_TO_ALL_COUNT:
        tmoe.ALL_TO_ALL_COUNT[key] = 0
    with use_rules(rules), sharded_compute():
        params = {name: rules.distribute(torch.from_numpy(inputs["params"][name]), axes)
                  .requires_grad_(True)
                  for name, (_, _, axes) in tmoe.moe_param_shapes(cfg).items()}
        x = rules.distribute(torch.from_numpy(inputs["x"]), ("batch", "act_seq", "act_embed"))
        x.requires_grad_(True)
        y, aux = tmoe.moe_ffn(x, params, cfg)
        loss = whole((y * torch.from_numpy(inputs["g"])).sum())
        names = sorted(params)
        grads = torch.autograd.grad(loss, [x] + [params[n] for n in names])
        out = {"y": whole(y).detach().numpy(), "aux": float(whole(aux)),
               "grads": dict(zip(["x"] + names, (whole(g).numpy() for g in grads))),
               "a2a": dict(tmoe.ALL_TO_ALL_COUNT)}
    return out


def _seq_attention(mesh, inputs):
    """The sequence-sharded attention on the mesh: its output and the
    gradients of <out, g> with respect to q, k and v, whole; and
    ``_want_seq_shard_map``'s answers."""
    rules = dataclasses.replace(MeshRules.for_mesh(mesh), seq_shard_attention=True)
    with use_rules(rules), sharded_compute():
        q, k, v = (rules.distribute(torch.from_numpy(inputs[n]),
                                    ("batch", "act_seq", "heads", "head_dim")).requires_grad_(True)
                   for n in ("q", "k", "v"))
        out = tattn._seq_sharded_attention(q, k, v, None)
        loss = whole((out * torch.from_numpy(inputs["g"])).sum())
        grads = torch.autograd.grad(loss, [q, k, v])
        res = {"out": whole(out).detach().numpy(), "q_layout": str(q.placements),
               "grads": [whole(g).numpy() for g in grads],
               "want": [tattn._want_seq_shard_map(h, (b, s, h, 8)) for h, b, s in WANT_CASES]}
    with use_rules(MeshRules.for_mesh(mesh)):
        res["want_off"] = tattn._want_seq_shard_map(3, (2, 4096, 3, 8))
    return res


def _cli(ckpt):
    """``--mesh 2,2`` through the CLI in this rank: its output, and the
    checkpoint rank 0 wrote loaded back onto the mesh."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params = tlaunch.main(CLI + ["--mesh", "2,2", "--ckpt-dir", ckpt])
    dist.barrier()
    loaded, step = load_checkpoint(ckpt, params)
    same = all(torch.equal(whole(a), whole(b))
               for (_, a), (_, b) in zip(tree_leaves(loaded), tree_leaves(params)))
    placed = all(a.placements == b.placements
                 for (_, a), (_, b) in zip(tree_leaves(loaded), tree_leaves(params)))
    return {"stdout": buf.getvalue(), "step": step, "reloaded_equal": same,
            "reloaded_placed": placed, "params": _np_tree(params)}


def _rank_main(rank, world, store, out_dir, pieces):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        res = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
        for case, (arch, fsdp, optimized) in CASES.items():
            rules = MeshRules.for_mesh(mesh, fsdp=fsdp)
            cfg = _cfg(tget, arch, optimized)
            res[case] = {dtype: _step(cfg, rules, dtype, keep=rank == 0) for dtype in DTYPES}
        res["moe_ep"] = _moe_ep(mesh, pieces["moe"])
        res["seq_attention"] = _seq_attention(mesh, pieces["attention"])
        res["cli"] = _cli(os.path.join(out_dir, "ckpt"))
        if rank:
            res["cli"].pop("params")
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        drain()
    finally:
        dist.destroy_process_group()


def _reference_rank_main(rank, world, store, out_dir, ref_path):
    """A rank of the port's 2×2 mesh on the reference's weights and batch."""
    from repro_torch.models import params_from_reference
    from repro_torch.training import init_opt_state

    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
        cfg = tget("tinyllama-1.1b").reduced()
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        out = {}
        for fsdp in (False, True):
            rules = MeshRules.for_mesh(mesh, fsdp=fsdp)
            trainer = Trainer(tbuild(cfg), AdamWConfig(**OPT), loss_chunk=LOSS_CHUNK)
            with use_rules(rules):
                params = rules.place(params_from_reference(ref["params"], cfg, "cpu"),
                                     trainer.model.param_axes())
                batch = {k: torch.from_numpy(np.asarray(v)) for k, v in ref["batch"].items()}
                _, _, m = trainer.train_step(params, init_opt_state(params), batch)
            out[fsdp] = {k: float(v) for k, v in m.items()}
        with open(os.path.join(out_dir, f"ref_rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        drain()
    finally:
        dist.destroy_process_group()


