"""Training on a 2×2 (data, model) mesh of four gloo ranks on the CPU:
DTensor params placed by ``Model.param_axes()``, ``shard_act`` as a
redistribute, the expert-parallel MoE over ``all_to_all`` and the
sequence-sharded attention, each against the same port on one process
(the 1×1 run) and against the JAX package.

One module-scoped ``torch.multiprocessing`` spawn of four ranks (a file
store under ``tmp_path_factory``) runs every mesh case; each rank writes
its results to a file. While the ranks run, this process runs the 1×1
steps and the reference's steps (``Trainer.train_step`` jitted, on the
port's seed-0 weights carried over as numpy).

Whole steps: every family's ``.reduced()`` config (TinyLlama with FSDP
off and on; OLMoE with its own dispatch and with ``optimized_for(2)``'s
expert parallelism; Scout's expert parallelism with the shared expert),
the shapes of tests/test_torch_training_families.py (batch 2 × 32, loss
chunk 16, AdamW at lr 1e-2 after one warmup step) and its tolerances:
loss, ce and moe_aux relative 5e-3, grad_norm relative 2e-2, lr relative
1e-6; the moments m and v relative L2 5e-2 and 1e-1 a leaf; the
gradients, recovered from m (the first step's m is (1 - b1) · the clipped
gradient), relative L2 5e-2 and cosine 0.995. Each step runs in bf16 (the
compute dtype) and in f32 (the port's ``COMPUTE_DTYPE`` set, as
tests/test_torch_families.py does). Against the 1×1 step: the bf16
metrics, and the f32 metrics, gradients and moments. Against the
reference (whose training does not run in f32): the bf16 metrics; its
gradients and moments stand to the 1×1 step's in
tests/test_torch_training_families.py. In bf16 a mesh rounds its partial
sums where one process rounds once, and a leaf whose gradient is a sum
with much cancellation, or hangs on a top-k choice, moves by more than
5e-2 (OLMoE's router and embedding, Scout's embedding, xLSTM's forget-gate
bias); in f32 the mesh and the 1×1 step agree to about 1e-6.

The pieces, against the reference in this process (no JAX mesh): the
expert-parallel MoE against the reference's ``moe_ffn`` with the
``gather`` dispatch on the inputs of the reference's own test
(tests/test_perf_optimizations.py: 8 experts, top-2, d 16, d_ff 32,
capacity 8.0, x (4, 8, 16) f32), and the sequence-sharded attention
against the reference's ``_blockwise_attention`` (q, k, v (2, 64, 3, 8)
f32, blocks of 16): values and the gradients of a fixed cotangent within
1e-4. ``MeshRules.placements`` of every leaf against the reference's
specs on fake meshes needs no ranks.

The ``slow`` test runs the JAX package's own 2×2 train step (four
simulated host devices in a subprocess) and the port's four ranks on the
reference's weights and batch.
"""
import contextlib
import io
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import attention as jattn
from repro.models.common import init_params as j_init_params
from repro.models.moe import MoEConfig as JMoE
from repro.models.moe import moe_ffn as j_moe_ffn
from repro.models.moe import moe_param_defs as j_moe_defs
from repro.sharding.specs import MeshRules as JRules
from repro.training import AdamWConfig as JAdamW
from repro.training import Trainer as JTrainer
from repro.training import init_opt_state as j_init_opt
from repro.training import load_checkpoint as j_load_checkpoint
from repro_torch.configs import get_config as tget
from repro_torch.launch import train as tlaunch
from repro_torch.models import build_model as tbuild
from repro_torch.models.common import tree_leaves
from repro_torch.sharding import MeshRules
from repro_torch.training import load_checkpoint
from torch_mesh_ranks import (CASES, CLI, DTYPES, FAMILIES, LINE, LOSS_CHUNK, METRIC_RTOL, OPT,
                              PIECE_TOL, ROOT, WORLD, _batch, _cfg, _rank_main,
                              _reference_rank_main, _step, hold, hold_mesh_step)
import torch_procs as procs
from torch_threads import one_thread  # noqa: F401

def _pieces():
    """The reference tests' inputs for the two pieces, and a cotangent each."""
    mcfg = JMoE(n_experts=8, top_k=2, d_model=16, d_ff=32, capacity_factor=8.0)
    params, _ = j_init_params(j_moe_defs(mcfg), jax.random.key(0), jnp.float32)
    x = np.random.default_rng(0).normal(0, 1, (4, 8, 16)).astype(np.float32)
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(0, 1, (2, 64, 3, 8)).astype(np.float32) for _ in range(3))
    return {"moe": {"params": {n: np.asarray(a) for n, a in params.items()}, "x": x,
                    "g": np.random.default_rng(2).normal(0, 1, x.shape).astype(np.float32)},
            "attention": {"q": q, "k": k, "v": v,
                          "g": np.random.default_rng(3).normal(0, 1, q.shape).astype(np.float32)}}


def _reference_step(arch, optimized, init):
    """The reference's ``Trainer.train_step`` (jitted, bf16) on the port's
    seed-0 weights (numpy) and the same batch: its metrics."""
    jcfg = _cfg(jget, arch, optimized)
    tree = {}
    for path, leaf in init.items():
        *tops, last = path.split("/")
        node = tree
        for top in tops:
            node = node.setdefault(top, {})
        node[last] = jnp.asarray(leaf, jnp.bfloat16)
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batch(jcfg).items()}
    jt = JTrainer(jbuild(jcfg), JAdamW(**OPT), loss_chunk=LOSS_CHUNK)
    _, _, metrics = jax.jit(jt.train_step)(tree, j_init_opt(tree), batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the four ranks' results, the 1×1 steps, the reference's steps, the
    pieces' inputs, the 1×1 CLI's output): the ranks spawn first and this
    process works while they run."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    pieces = _pieces()
    rank_procs = procs.Ranks(_rank_main, (WORLD, str(tmp / "store"), str(tmp), pieces), WORLD,
                             tmp, "mesh_train")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single, reference = {}, {}
        for arch, optimized in sorted({(a, o) for a, _, o in CASES.values()}):
            for dtype in DTYPES:
                single[arch, optimized, dtype] = _step(_cfg(tget, arch, optimized), None, dtype)
            reference[arch, optimized] = _reference_step(arch, optimized,
                                                         single[arch, optimized, "bf16"]["init"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tlaunch.main(CLI)
        cli = buf.getvalue()
    finally:
        torch.set_num_threads(n)
    rank_procs.wait()
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "single": single, "reference": reference, "pieces": pieces,
            "cli": cli, "ckpt": str(tmp / "ckpt")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_step_equals_single(runs, case):
    """A 2×2 step equals the same port's 1×1 step of the same seed and
    batch (the metrics in bf16; in f32 the metrics, gradients and moments);
    every rank reports the same metrics; the params are sharded."""
    arch, fsdp, optimized = CASES[case]
    ranks = runs["ranks"]
    assert sorted(r["coords"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for dtype in DTYPES:
        hold_mesh_step([r[case][dtype] for r in ranks], runs["single"][arch, optimized, dtype],
                       moments=dtype == "f32")


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_step_equals_reference(runs, case):
    """A 2×2 bf16 step's metrics equal the reference's unsharded
    ``Trainer.train_step``'s on the same weights and batch."""
    arch, _, optimized = CASES[case]
    hold(runs["ranks"][0][case]["bf16"], runs["reference"][arch, optimized], moments=False)


def test_expert_parallel_ran(runs):
    """``optimized_for(2)``'s ``ep_shard_map`` reached ``moe_ffn_ep`` on the
    mesh: three all_to_alls a MoE layer forward (six with remat's
    recomputation) and two backward; none without it or on one process."""
    ranks, single = runs["ranks"], runs["single"]
    layers = tget("olmoe-1b-7b").reduced().n_layers
    for dtype in DTYPES:
        assert ranks[0]["olmoe-ep"][dtype]["a2a"] == {"forward": 6 * layers,
                                                      "backward": 2 * layers}
        assert ranks[0]["olmoe"][dtype]["a2a"] == {"forward": 0, "backward": 0}
        assert single["olmoe-1b-7b", True, dtype]["a2a"] == {"forward": 0, "backward": 0}
    assert _cfg(tget, "olmoe-1b-7b", True).moe_dispatch == "ep_shard_map"


def test_moe_ffn_ep_equals_reference_gather(runs):
    """``moe_ffn_ep`` on the 2×2 mesh against the reference's ``moe_ffn``
    with the gather dispatch: y, the aux loss and the gradients with respect
    to x and every param within 1e-4, on the reference test's inputs."""
    inp = runs["pieces"]["moe"]
    cfg = JMoE(n_experts=8, top_k=2, d_model=16, d_ff=32, capacity_factor=8.0, dispatch="gather")
    x = jnp.asarray(inp["x"])
    params = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    (y, aux), vjp = jax.vjp(lambda x_, p_: j_moe_ffn(x_, p_, cfg), x, params)
    gx, gp = vjp((jnp.asarray(inp["g"]), jnp.zeros_like(aux)))
    want = {"x": gx, **gp}
    for r in runs["ranks"]:
        got = r["moe_ep"]
        assert got["a2a"]["forward"] == 3 and got["a2a"]["backward"] == 2
        np.testing.assert_allclose(got["y"], np.asarray(y), atol=PIECE_TOL, rtol=0)
        assert got["aux"] == pytest.approx(float(aux), abs=PIECE_TOL)
        assert sorted(got["grads"]) == sorted(want)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g, np.asarray(want[name]), atol=PIECE_TOL, rtol=0,
                                       err_msg=name)


def test_seq_sharded_attention_equals_reference_blockwise(runs):
    """``_seq_sharded_attention`` (3 heads, which the model axis does not
    divide, so the sequence takes it) against the reference's
    ``_blockwise_attention`` at offset 0 with blocks of 16: the output and
    the gradients with respect to q, k and v within 1e-4; and the
    reference's conditions for taking it."""
    inp = runs["pieces"]["attention"]
    q, k, v = (jnp.asarray(inp[n]) for n in ("q", "k", "v"))
    ref, vjp = jax.vjp(lambda *t: jattn._blockwise_attention(*t, jnp.int32(0), True, None,
                                                             block_q=16, block_kv=16), q, k, v)
    want = vjp(jnp.asarray(inp["g"]))
    for r in runs["ranks"]:
        got = r["seq_attention"]
        assert got["q_layout"] == "(Shard(dim=0), Shard(dim=1))"
        np.testing.assert_allclose(got["out"], np.asarray(ref), atol=PIECE_TOL, rtol=0)
        for g, w in zip(got["grads"], want):
            np.testing.assert_allclose(g, np.asarray(w), atol=PIECE_TOL, rtol=0)
        # only heads the model axis does not divide, over 2048 positions
        # that it divides, a batch the data axis divides, and the flag
        assert got["want"] == [True, False, False, False, False]
        assert got["want_off"] is False


def test_train_cli_mesh_in_ranks(runs):
    """``--mesh 2,2`` through ``python -m repro_torch.launch.train`` in the
    four ranks: two steps, the reference's line on rank 0 only, losses
    within the metric tolerance of the one-process CLI's; the checkpoint
    written from rank 0 loads back onto the mesh, equal and placed as the
    trained params."""
    def _lines(text):
        return [m.groups() for m in map(LINE.match, text.splitlines()) if m]

    want = _lines(runs["cli"])
    assert [w[0] for w in want] == ["0", "1"]
    for r in runs["ranks"]:
        cli = r["cli"]
        got = _lines(cli["stdout"])
        if r["coords"] == (0, 0):
            assert [g[0] for g in got] == ["0", "1"], cli["stdout"]
            assert "saved checkpoint to" in cli["stdout"]
            for g, w in zip(got, want):
                assert float(g[1]) == pytest.approx(float(w[1]), rel=5e-3)
                assert g[4] == w[4]
        else:
            assert cli["stdout"] == ""
        assert cli["step"] == 2 and cli["reloaded_equal"] and cli["reloaded_placed"]


def test_mesh_checkpoint_loads_unsharded(runs):
    """The 2×2 run's checkpoint holds whole tensors in the reference's
    format: the reference's ``load_checkpoint`` and the port's, unsharded
    on the CPU, read the trained params' values."""
    trained = next(r for r in runs["ranks"] if r["coords"] == (0, 0))["cli"]["params"]
    cfg = tget("tinyllama-1.1b").reduced()
    port, step = load_checkpoint(runs["ckpt"], tbuild(cfg).init(seed=1, device="cpu"))
    assert step == 2
    like = jax.eval_shape(jbuild(jget("tinyllama-1.1b").reduced()).init, jax.random.key(0))
    ref, jstep = j_load_checkpoint(runs["ckpt"], like)
    assert jstep == 2
    ref_flat = {"/".join(str(q.key) for q in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert sorted(ref_flat) == sorted(trained)
    for path, leaf in tree_leaves(port):
        assert type(leaf) is torch.Tensor and leaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(leaf.float().numpy(), trained[path])
        np.testing.assert_array_equal(np.asarray(ref_flat[path], np.float32), trained[path])


# ---------------------------------------------------------------------------
# metadata: no ranks
# ---------------------------------------------------------------------------


class FakeMesh:
    """The reference tests' mesh-like: axis names and a shape dict."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _want_placements(spec, axes):
    from torch.distributed.tensor import Replicate, Shard

    on = {a: i for i, s in enumerate(spec) if s is not None
          for a in (s if isinstance(s, tuple) else (s,))}
    return tuple(Shard(on[a]) if a in on else Replicate() for a in axes)


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_axes_equal_reference(arch):
    """``Model.param_axes()`` is the reference's: the same tree, the same
    tuples, leaf for leaf (at the full config)."""
    got, want = tbuild(tget(arch)).param_axes(), jbuild(jget(arch)).param_axes()
    assert got == want


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("mesh", [((2, 2), False), ((16, 16), True), ((2, 16, 16), True)],
                         ids=["2x2", "16x16-fsdp", "2x16x16-fsdp"])
def test_placements_equal_reference_specs(arch, mesh):
    """``MeshRules.placements`` of every param leaf (its full-config shape)
    on a fake mesh: the reference's ``spec`` of the same leaf, as DTensor
    placements (a dim on ("pod", "data") shards over both)."""
    shape, fsdp = mesh
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    fake = FakeMesh(shape, axes)
    tr, jr = MeshRules.for_mesh(fake, fsdp=fsdp), JRules.for_mesh(fake, fsdp=fsdp)
    model = tbuild(tget(arch))
    for name, (leaf_shape, _, logical) in model.param_shapes().items():
        spec = tuple(jr.spec(logical, leaf_shape))
        assert tr.spec(logical, leaf_shape) == spec, name
        assert tr.placements(logical, leaf_shape) == _want_placements(spec, axes), name


# ---------------------------------------------------------------------------
# the reference's own 2×2 train step (slow)
# ---------------------------------------------------------------------------

JAX_MESH = r"""
import pickle, sys
sys.path.insert(0, sys.argv[1])
import conftest  # noqa: F401  (the Pallas aliases the reference needs under jax 0.9)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType

# jax 0.9's make_mesh types its axes Explicit; the reference was written
# for Auto (GSPMD propagation) meshes
_make_mesh = jax.make_mesh
def _auto_mesh(shape, names, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(shape))
    return _make_mesh(shape, names, **kw)
jax.make_mesh = _auto_mesh
from repro.configs import get_config
from repro.data import DataConfig, lm_batches
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.sharding import MeshRules, use_rules
from repro.training import AdamWConfig, Trainer, init_opt_state

cfg = get_config("tinyllama-1.1b").reduced()
model = build_model(cfg)
params = model.init(jax.random.key(0))
batch = {k: jnp.asarray(v) for k, v in
         next(lm_batches(cfg, DataConfig(batch=4, seq_len=32, seed=3))).items()}
out = {"params": jax.device_get(params), "batch": jax.device_get(batch)}
mesh = make_mesh((2, 2), ("data", "model"))
trainer = Trainer(model, AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10), loss_chunk=16)
for fsdp in (False, True):
    with use_rules(MeshRules.for_mesh(mesh, fsdp=fsdp)), mesh:
        _, _, m = jax.jit(trainer.train_step)(params, init_opt_state(params), batch)
    out[fsdp] = {k: float(v) for k, v in m.items()}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.mark.slow
def test_reference_mesh_step_equals_port_mesh_step(tmp_path):
    """The JAX package's own 2×2 train step (four simulated host devices,
    FSDP off and on) against the port's 2×2 step on the same weights and
    batch: the metrics within the tolerances above."""
    ref_path = tmp_path / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", JAX_MESH, str(ROOT), str(ref_path)], env=env,
                         capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-4000:]
    procs.Ranks(_reference_rank_main, (WORLD, str(tmp_path / "store"), str(tmp_path),
                                       str(ref_path)), WORLD, tmp_path, "ref_ranks").wait()
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    for r in range(WORLD):
        with open(tmp_path / f"ref_rank{r}.pkl", "rb") as f:
            got = pickle.load(f)
        for fsdp in (False, True):
            for key, rtol in METRIC_RTOL.items():
                assert got[fsdp][key] == pytest.approx(ref[fsdp][key], rel=rtol, abs=1e-12), \
                    (fsdp, key)
