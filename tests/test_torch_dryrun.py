"""The dry-run tools of the port (``configs/shapes.py``, ``input_specs``,
``launch/mesh.make_dry_mesh``, ``launch/cost_analysis.py``,
``launch/dryrun.py``) against the JAX package's.

The port's dry runs run in one subprocess (``tests/torch_dryrun_worker.py``:
each takes the process's one default process group, torch's fake one) and
the real 2×2 step in four spawned gloo ranks, both started by one module
fixture while this process computes the reference's side; a test waits
only for the processes whose results it reads (``port``: the dry runs;
``gloo``: the ranks, which only ``test_fake_mesh_equals_real_gloo_mesh``
reads), and a failed process fails with the tail of its log
(``tests/torch_procs.py``).

Tolerances: shapes, argument bytes, collective counts and bytes are exact,
and so are FLOPs. Against the reference's ``analyze_hlo`` of its compiled
step (1×1, reduced configs, batch 2 × 64 positions) two known terms part
them (``flop_gap``), and the test holds the port to the reference's count
plus exactly those:
  * train: the loss walks its (padded) 512-position chunk under
    ``torch.utils.checkpoint``, so the backward recomputes the chunk's head
    product, 2·b·512·d·V more (+11 % at these shapes); XLA keeps the
    forward's logits and computes it once. The layers' remat recomputation
    is counted alike by both;
  * decode: the port computes a decode step's two attention products as
    broadcast multiplies summed over the innermost dim (so a data rank's
    rows sum in the 1×1 order), which are not products,
    where XLA's are ``dot``s: 4·b·h·P·hd a layer fewer (P = 64 cache
    positions, −1.7 to −3.6 % here).
xLSTM's scans, one chunk of 64 steps here in both packages, part them in
two more places:
  * train, each mLSTM step's backward: the outer product v ⊗ k is a
    broadcast multiply in torch and a ``dot`` with no contracted dim in
    XLA, so neither counts it forward; backward, XLA counts its two
    gradients (contractions over dh, 2·2·b·h·dh²) and torch none, while
    torch counts the gradient of C in C·q (a ``bmm`` over a dim of one,
    2·b·h·dh²) and the two gradients of n·q (2·2·b·h·dh), which XLA makes
    multiplies: 4·b·h·dh − 2·b·h·dh² a step and mLSTM block;
  * decode: the reference runs a one-token step as a whole chunk, 63 of
    its 64 steps padded, and counts them; the port runs one step: 63 times
    a step's forward products fewer (mLSTM 2·b·h·dh² + 2·b·h·dh, sLSTM
    2·b·h·sdh·4·sdh).
Prefill agrees to the FLOP.
"""
import math
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as rget
from repro.configs.base import InputShape as RInputShape
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import build_model as rbuild
from repro.models.inputs import input_specs as ref_input_specs
from repro.sharding import MeshRules as RMeshRules
from repro.training import AdamWConfig as RAdamW
from repro.training import Trainer as RTrainer
from repro.training import init_opt_state as r_init_opt_state
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.launch.cost_analysis import CostCounter, collective_kind
from repro_torch.launch.mesh import make_dry_mesh
from repro_torch.models import build_model
from repro_torch.models.inputs import input_specs, make_dummy_batch
from repro_torch.models.xlstm import XLSTMConfig
from repro_torch.training import AdamWConfig, Trainer

sys.path.insert(0, os.path.dirname(__file__))
import torch_dryrun_worker as worker  # noqa: E402
import torch_procs as procs  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("train", "prefill", "decode")


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The port's dry runs (one subprocess) and the real 2×2 step (four
    gloo ranks), started together when the module's first test needs
    either; each test waits only for what it reads (``port``, ``gloo``)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    fake = procs.Sub([os.path.join(ROOT, "tests", "torch_dryrun_worker.py"), tmp / "fake.pkl"],
                     tmp, "fake")
    real = procs.Ranks(worker.real_2x2, (4, str(tmp / "store"), str(tmp)), 4, tmp, "real2x2")
    yield tmp, fake, real
    fake.stop()
    real.stop()


@pytest.fixture(scope="module")
def port(started):
    """The fake dry runs' pickle (``torch_dryrun_worker.fake_main``)."""
    tmp, fake, _ = started
    fake.wait()
    with open(tmp / "fake.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def gloo(started):
    """Rank 0's summary of the real 2×2 step (``torch_dryrun_worker.real_2x2``)."""
    tmp, _, real = started
    real.wait()
    with open(tmp / "real2x2.pkl", "rb") as f:
        return pickle.load(f)


def test_shapes_equal_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    assert {k: (s.seq_len, s.global_batch, s.kind) for k, s in SHAPES.items()} == \
        {k: (s.seq_len, s.global_batch, s.kind) for k, s in REF_SHAPES.items()}
    with pytest.raises(KeyError, match="unknown input shape"):
        get_shape("train_8k")


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-76b", "whisper-small"])
def test_input_specs_geometry_equal_reference(arch, shape_name):
    """Shapes equal the reference's; they hold no storage (meta); tokens
    are int64 where the reference's are int32, the frontend bf16 in both."""
    got = input_specs(get_config(arch), get_shape(shape_name))
    want = ref_input_specs(rget(arch), REF_SHAPES[shape_name])
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.is_meta for v in got.values())
    assert got["tokens"].dtype == torch.int64 and want["tokens"].dtype == jnp.int32
    if "frontend" in got:
        assert got["frontend"].dtype == torch.bfloat16 and want["frontend"].dtype == jnp.bfloat16
    # make_dummy_batch keeps the prompt geometry and refuses decode shapes
    if get_shape(shape_name).is_decode:
        with pytest.raises(ValueError, match="decode shapes"):
            make_dummy_batch(get_config(arch), get_shape(shape_name), device="cpu")


def _ref_train_argument_bytes(arch, shape, axes) -> int:
    """One device's bytes of the reference's params, AdamW m and v (f32)
    and step (int32), from its own specs on an ``AbstractMesh``."""
    cfg = rget(arch)
    model = rbuild(cfg)
    rules = RMeshRules.for_mesh(jax.sharding.AbstractMesh(shape, axes), fsdp=cfg.fsdp)
    sizes = dict(zip(axes, shape))
    leaves = jax.tree.leaves(jax.eval_shape(model.init, jax.random.key(0)))
    axes_leaves = jax.tree.leaves(model.param_axes(), is_leaf=lambda x: isinstance(x, tuple))
    assert len(leaves) == len(axes_leaves)
    total = 0
    for sds, ax in zip(leaves, axes_leaves):
        n = math.prod(sds.shape)
        for entry in rules.spec(ax, sds.shape):
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                if name is not None:
                    n //= sizes[name]
        total += n * (sds.dtype.itemsize + 4 + 4)
    return total + 4


@pytest.mark.parametrize("mesh", worker.MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_reference_recount(port, arch, mesh):
    """Per-rank bytes of the placed train step's arguments (params, AdamW
    m, v and step) on the fake production meshes, against a recount from
    the reference's ``MeshRules.spec`` over its ``eval_shape``d init."""
    assert port[(mesh[0], arch)] == _ref_train_argument_bytes(arch, *mesh)


def _ref_step(arch, kind):
    """The reference's reduced step of ``kind`` and its abstract arguments
    (the reference dry run's ``build_step`` at 1×1)."""
    cfg = rget(arch).reduced()
    model = rbuild(cfg)
    shape = RInputShape(f"{kind}_small", 64, 2, kind)
    params = jax.eval_shape(model.init, jax.random.key(0))
    if kind == "train":
        trainer = RTrainer(model, RAdamW(), loss_chunk=512)
        opt = jax.eval_shape(r_init_opt_state, params)
        return trainer.train_step, (params, opt, ref_input_specs(cfg, shape))
    if kind == "prefill":
        return (lambda p, b: model.prefill(p, b, 64)), (params, ref_input_specs(cfg, shape))
    cache = jax.eval_shape(lambda: model.init_cache(2, 64))
    token = jax.ShapeDtypeStruct((2, 1), jnp.int32)
    return (lambda p, t, c: model.decode_step(p, t, c)), (params, token, cache)


def flop_gap(arch: str, kind: str) -> int:
    """The port's FLOPs less the reference's for a reduced step of batch 2
    over 64 positions (see the module doc)."""
    cfg = get_config(arch).reduced()
    b, positions, chunk = 2, 64, 512
    gap = 2 * b * chunk * cfg.d_model * cfg.vocab_size if kind == "train" else 0
    if cfg.slstm_layers:  # xLSTM
        xc = XLSTMConfig(cfg.d_model, cfg.n_heads)
        h, dh, sdh = xc.n_heads, xc.head_dim, xc.s_head_dim
        n_s = len(cfg.slstm_layers)
        n_m = cfg.n_layers - n_s
        if kind == "train":
            gap += positions * n_m * (4 * b * h * dh - 2 * b * h * dh * dh)
        if kind == "decode":
            gap -= (xc.chunk - 1) * (n_m * (2 * b * h * dh * dh + 2 * b * h * dh)
                                     + n_s * 2 * b * h * sdh * 4 * sdh)
        return gap
    if kind == "decode":
        return -4 * b * cfg.n_heads * positions * cfg.resolved_head_dim * cfg.n_layers
    return gap


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", worker.FLOP_ARCHS)
def test_flops_agree_with_reference_analyze_hlo(port, arch, kind):
    """The dry run's per-device FLOPs at 1×1 against ``analyze_hlo`` of the
    reference's compiled step: equal once the known gap is added."""
    fn, args = _ref_step(arch, kind)
    want = analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())["flops"]
    got = port[("flops", arch, kind)]
    assert got > 0
    assert got == want + flop_gap(arch, kind), (got, want)


def _real_step(arch, kind):
    """The port's reduced step of ``kind`` on seeded CPU tensors, no mesh."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    shape = worker.SMALL[kind]
    params = model.init(seed=0, device="cpu")
    if kind == "decode":
        cache = model.init_cache(2, 64, "cpu")
        return lambda: model.decode_step(params, torch.zeros((2, 1), dtype=torch.int64), cache)
    batch = make_dummy_batch(cfg, shape, device="cpu")
    if kind == "prefill":
        return lambda: model.prefill(params, batch, 64)
    trainer = Trainer(model, AdamWConfig(), loss_chunk=512)
    params, state = trainer.init_state(seed=0, device="cpu")
    return lambda: trainer.train_step(params, state, batch)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", worker.FLOP_ARCHS)
def test_flops_equal_flop_counter_of_real_step(port, arch, kind):
    """The fake 1×1 step (DTensors on a one-rank fake mesh, no storage)
    predicts exactly what ``FlopCounterMode`` counts of the real step on
    plain tensors (the check chip_smoke.py phase 17 makes on the card)."""
    step = _real_step(arch, kind)
    with FlopCounterMode(display=False) as fc:
        step()
    assert port[("flops", arch, kind)] == fc.get_total_flops()


def test_fake_mesh_equals_real_gloo_mesh(port, gloo):
    """Reduced TinyLlama's FSDP train step on a fake 2×2 mesh and on four
    real gloo ranks: the same collectives (counts and bytes by kind), FLOPs
    and argument bytes for rank 0."""
    rep, got = port["fake2x2"], gloo["summary"]
    assert rep["mesh"]["axes"] == {"data": 2, "model": 2}
    assert rep["collectives"]["counts"] == got["collectives"]["counts"]
    assert rep["collective_per_kind"] == got["collective_per_kind"]
    assert rep["collective_bytes_per_device"] == got["collective_bytes"] > 0
    assert rep["flops_per_device"] == got["flops"] > 0
    assert rep["memory"]["argument_bytes"] == gloo["argument_bytes"]
    assert rep["memory"]["peak_bytes"] >= rep["memory"]["argument_bytes"]
    assert rep["memory"]["fits"] and rep["trace_s"] > 0


def test_real_step_under_the_counter_waits_its_collectives(started, gloo):
    """Under the counter a real collective's wait runs (a fake one's it
    skips): no rank of the real 2×2 step ends with a collective unwaited.
    Unwaited, gloo wrote into outputs the step had freed, and a rank died
    at exit ("malloc(): unaligned tcache chunk detected")."""
    _, _, real = started
    for log in real.logs:
        with open(log) as f:
            assert "unwaited collective" not in f.read(), log


def test_cost_counter_conventions():
    """A product's FLOPs, a materialized op's bytes (views are free), the
    collective kinds by the reference's names, and the live high-water
    mark."""
    a, b = torch.ones(8, 16), torch.ones(16, 32)
    counter = CostCounter()
    assert counter.track([a, b]) == (8 * 16 + 16 * 32) * 4
    with counter:
        y = a @ b          # 2·8·32·16 FLOPs; (8·16 + 16·32 + 8·32)·4 bytes
        y.t()              # a view: no bytes
        del y
        z = a + 1          # (8·16·2 + 1)·4 bytes... the scalar is not a tensor
    assert counter.flops == 2 * 8 * 32 * 16
    assert counter.bytes == (8 * 16 + 16 * 32 + 8 * 32) * 4 + 2 * 8 * 16 * 4
    assert counter.peak_bytes == (8 * 16 + 16 * 32 + 8 * 32) * 4
    assert z.shape == a.shape
    ops = torch.ops
    assert collective_kind(ops._c10d_functional.all_gather_into_tensor.default) == "all-gather"
    assert collective_kind(ops._c10d_functional.reduce_scatter_tensor.default) == \
        "reduce-scatter"
    assert collective_kind(ops._c10d_functional.all_reduce.default) == "all-reduce"
    assert collective_kind(ops._c10d_functional.all_to_all_single.default) == "all-to-all"
    assert collective_kind(ops.c10d.alltoall_base_.default) == "all-to-all"
    assert collective_kind(ops.aten.mm.default) is None


def test_dry_mesh_refuses_an_initialised_group(tmp_path):
    """A real group is never taken for a fake one: with a gloo group up,
    ``make_dry_mesh`` refuses (in a subprocess: a process has one group)."""
    code = (
        "import torch.distributed as dist\n"
        "from repro_torch.launch.mesh import make_dry_mesh\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path / 'store'}', "
        "rank=0, world_size=1)\n"
        "try:\n"
        "    make_dry_mesh((16, 16), ('data', 'model'), 'cpu')\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "refused: a process group (gloo, 1 ranks) is initialised already" in res.stdout
    with pytest.raises(ValueError, match="differ in length"):
        make_dry_mesh((2, 2), ("data",), "cpu")
