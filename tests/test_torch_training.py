"""The port's training substrate against the JAX reference's
(``repro.training``), on the CPU: the chunked cross entropy, the lr
schedule, AdamW on equal f32 gradients, checkpoints across the two
packages, the load-time row permutations, the loss falling on reduced
TinyLlama (as ``tests/test_training.py`` holds the reference), and the
per-layer remat leaving loss and gradients bitwise as they were.

Tolerances: the xent in f32 at rtol 1e-5 (the reference suite's); the
schedule at rtol 1e-6 (f32 cos and division); AdamW's f32 moments at a
relative L2 error of 1e-6 a leaf (``MOMENT_REL``: the global norm sums in
another order, and a second step's moment cancels where b1·m ≈ -(1-b1)·g,
so single elements differ by up to 3e-5 relative, ~10 f32 ulps) and its
bf16 params within one bf16 ulp; checkpoints and permutations exactly.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.training import AdamWConfig as JAdamW
from repro.training import adamw_update as j_adamw
from repro.training import apply_row_permutations as j_permute
from repro.training import init_opt_state as j_init_opt
from repro.training import load_checkpoint as j_load
from repro.training import lr_schedule as j_lr
from repro.training import save_checkpoint as j_save
from repro.training.train_step import _chunked_softmax_xent as j_xent
from repro_torch.configs import get_config as tget
from repro_torch.data import DataConfig, lm_batches
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.training import (
    AdamWConfig,
    Trainer,
    adamw_update,
    apply_row_permutations,
    init_opt_state,
    lm_loss,
    load_checkpoint,
    lr_schedule,
    save_checkpoint,
)
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training.train_step import _chunked_softmax_xent
from torch_threads import one_thread  # noqa: F401

MOMENT_REL = 1e-6
REMAT_ARCHS = ("tinyllama-1.1b", "internvl2-76b", "olmoe-1b-7b", "zamba2-7b", "xlstm-125m",
               "whisper-small")


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("s,chunk", ((13, 4), (16, 4), (13, 16)),
                         ids=("padded", "whole-chunks", "one-padded-chunk"))
def test_chunked_xent_matches_reference(s, chunk):
    rng = np.random.default_rng(s * 100 + chunk)
    b, d, v = 2, 8, 32
    hidden = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    head = rng.normal(0, 1, (d, v)).astype(np.float32)
    targets = rng.integers(0, v, (b, s)).astype(np.int32)
    want = float(j_xent(jnp.asarray(hidden), jnp.asarray(targets), jnp.asarray(head), chunk))
    got = _chunked_softmax_xent(_t(hidden), _t(targets), _t(head), chunk)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-5)
    logits = torch.from_numpy(hidden) @ torch.from_numpy(head)
    direct = torch.nn.functional.cross_entropy(logits.reshape(-1, v),
                                               torch.from_numpy(targets).long().reshape(-1))
    assert float(got) == pytest.approx(float(direct), rel=1e-5)


def test_chunked_xent_bf16_hidden_matches_reference():
    """A bf16 hidden state: the logits are a bf16 product cast to f32 in
    both packages."""
    rng = np.random.default_rng(7)
    hidden = rng.normal(0, 1, (2, 13, 16)).astype(np.float32)
    head = (0.3 * rng.normal(0, 1, (16, 40))).astype(np.float32)
    targets = rng.integers(0, 40, (2, 13)).astype(np.int32)
    want = float(j_xent(jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(targets),
                        jnp.asarray(head, jnp.bfloat16), 4))
    got = float(_chunked_softmax_xent(_t(hidden).bfloat16(), _t(targets), _t(head).bfloat16(),
                                      4))
    assert got == pytest.approx(want, rel=1e-5)


def test_lr_schedule_matches_reference():
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    cfg, jcfg = AdamWConfig(**kw), JAdamW(**kw)
    steps = np.arange(0, 121)
    got = np.array([float(lr_schedule(cfg, torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps])
    want = np.array([float(j_lr(jcfg, jnp.asarray(int(s), jnp.int32))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0] == 0.0 and got[10] == pytest.approx(1.0) and got[120] == pytest.approx(0.1)
    assert float(lr_schedule(cfg, 55)) == pytest.approx(got[55])


def _adamw_case(seed):
    """Params with a stacked (L, d) norm leaf, a (d,) leaf and a bf16
    matrix (stacked too), and two steps of f32 gradients, as numpy."""
    rng = np.random.default_rng(seed)
    L, d = 3, 16
    params = {"final_norm_w": 1 + 0.1 * rng.normal(size=(d,)),
              "head": rng.normal(size=(d, 24)),
              "layers": {"ln1_w": 1 + 0.1 * rng.normal(size=(L, d)),
                         "wq": rng.normal(size=(L, d, d)) / 4}}
    params = {k: ({s: a.astype(np.float32) for s, a in v.items()} if isinstance(v, dict)
                  else v.astype(np.float32)) for k, v in params.items()}
    grads = [jax.tree.map(lambda a: (rng.normal(size=a.shape) * 3).astype(np.float32), params)
             for _ in range(2)]
    return params, grads


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in bf16 ulps between two arrays of bf16 values."""
    ia = _t(a).bfloat16().view(torch.int16).int()
    ib = _t(b).bfloat16().view(torch.int16).int()
    return int((ia - ib).abs().max())


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm((got - want).astype(np.float64))
                 / max(np.linalg.norm(want.astype(np.float64)), 1e-30))


@pytest.mark.parametrize("clip", (1.0, 1e3), ids=("clipped", "unclipped"))
def test_adamw_update_matches_reference(clip):
    """Two steps on equal f32 gradients: the decay mask (the stacked (L, d)
    norm leaf decays, the top-level (d,) leaf does not), the global-norm
    clip, bias correction and the moments; bf16 params rounded once."""
    params_np, grads_np = _adamw_case(0)
    kw = dict(lr=0.05, warmup_steps=1, total_steps=10, grad_clip=clip, weight_decay=0.1)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params_np)
    jp["head"] = jnp.asarray(params_np["head"])  # one f32 matrix beside the bf16 ones
    jstate = j_init_opt(jp)
    tp = tree_map(lambda a: _t(a).bfloat16(), params_np)
    tp["head"] = _t(params_np["head"])
    tstate = init_opt_state(tp)
    for g in grads_np:
        jp, jstate, jm = j_adamw(JAdamW(**kw), jp, jax.tree.map(jnp.asarray, g), jstate)
        tp, tstate, tm = adamw_update(AdamWConfig(**kw), tp,
                                      tree_map(_t, g), tstate)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(tstate.step) == int(jstate.step) == 2
    for (path, p), (_, m), (_, v) in zip(tree_leaves(tp), tree_leaves(tstate.m),
                                         tree_leaves(tstate.v)):
        top, _, sub = path.partition("/")

        def ref(tree):
            return tree[top][sub] if sub else tree[top]

        for got, want in ((m, ref(jstate.m)), (v, ref(jstate.v))):
            assert _rel_l2(got.numpy(), np.asarray(want)) <= MOMENT_REL, path
        if p.dtype == torch.bfloat16:
            assert _bf16_ulps(p.float().numpy(), _f32(ref(jp))) <= 1, path
        else:
            np.testing.assert_allclose(p.numpy(), np.asarray(ref(jp)), rtol=1e-6, atol=1e-7)


def test_adamw_decay_mask_takes_stacked_norms():
    """Zero gradients: only decay moves a param. The stacked (L, d) norm
    leaf and the matrices shrink by lr·wd·p; the top-level (d,) final
    norm does not move (the reference's ``ndim >= 2`` mask)."""
    params_np, _ = _adamw_case(1)
    tp = tree_map(_t, params_np)
    zeros = tree_map(torch.zeros_like, tp)
    before = tree_map(torch.clone, tp)
    cfg = AdamWConfig(lr=0.1, warmup_steps=1, total_steps=10, weight_decay=0.5)
    tp, _, metrics = adamw_update(cfg, tp, zeros, init_opt_state(tp))
    assert float(metrics["grad_norm"]) == 0.0
    assert torch.equal(tp["final_norm_w"], before["final_norm_w"])
    for leaf in (("layers", "ln1_w"), ("layers", "wq"), ("head",)):
        got = tp[leaf[0]][leaf[1]] if len(leaf) == 2 else tp[leaf[0]]
        old = before[leaf[0]][leaf[1]] if len(leaf) == 2 else before[leaf[0]]
        torch.testing.assert_close(got, old * (1 - 0.1 * 0.5), rtol=1e-6, atol=1e-7)


def _granite():
    jcfg, tcfg = jget("granite-3-2b").reduced(), tget("granite-3-2b").reduced()
    jm = jbuild(jcfg)
    return jm, jax.jit(jm.init)(jax.random.key(0)), tcfg


def test_checkpoint_loads_across_packages(tmp_path):
    """Written by the reference, loaded by the port, and the other way,
    bitwise (bf16 stored as f32); the manifests are the same."""
    jm, jp, tcfg = _granite()
    j_save(str(tmp_path / "ref"), jp, step=7, extra={"by": "reference"})
    like = tbuild(tcfg).init(seed=3, device="cpu")
    tp, step = load_checkpoint(str(tmp_path / "ref"), like)
    assert step == 7
    want = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    got_leaves, want_leaves = list(tree_leaves(tp)), list(tree_leaves(want))
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves]
    for (k, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b), k

    save_checkpoint(str(tmp_path / "port"), tp, step=9, extra={"by": "reference"})
    restored, step = j_load(str(tmp_path / "port"), jax.eval_shape(jm.init, jax.random.key(0)))
    assert step == 9
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_f32(a), _f32(b))
    man = [json_of(tmp_path / d / "manifest.json") for d in ("ref", "port")]
    assert {**man[0], "step": 0} == {**man[1], "step": 0}


def json_of(path):
    import json

    return json.loads(path.read_text())


def test_checkpoint_rejects_a_shape_mismatch(tmp_path):
    params = {"embed": torch.zeros(4, 2, dtype=torch.bfloat16)}
    save_checkpoint(str(tmp_path), params)
    with pytest.raises(ValueError, match="embed"):
        load_checkpoint(str(tmp_path), {"embed": torch.zeros(2, 4, dtype=torch.bfloat16)})


def test_apply_row_permutations_matches_reference():
    """The reference's case (a 2-d leaf whose rows the permutation covers)
    and its quirk on the stacked tree: a permutation over d_model rows
    leaves an (L, d, f) leaf as it was, and one of length L permutes the
    layers."""
    rng = np.random.default_rng(4)
    flat = rng.normal(0, 1, (8, 4)).astype(np.float32)
    stacked = rng.normal(0, 1, (2, 8, 4)).astype(np.float32)
    perm8 = np.array([3, 1, 0, 2, 7, 6, 5, 4])
    perm2 = np.array([1, 0])
    cases = (({"layers": {"w_gate": flat}}, {"w_gate": perm8}),
             ({"layers": {"w_gate": stacked, "ln1_w": stacked[:, :, 0]}}, {"w_gate": perm8}),
             ({"layers": {"w_gate": stacked}}, {"w_gate": perm2}))
    for params, perms in cases:
        want = j_permute(jax.tree.map(jnp.asarray, params), perms)
        got = apply_row_permutations(tree_map(_t, params), perms)
        for (k, a), (_, b) in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    got = apply_row_permutations({"layers": {"w_gate": _t(stacked)}}, {"w_gate": perm8})
    assert torch.equal(got["layers"]["w_gate"], _t(stacked))  # the stacked no-op
    got = apply_row_permutations({"layers": {"w_gate": _t(flat)}}, {"w_gate": perm8})
    assert torch.equal(got["layers"]["w_gate"], _t(flat[perm8]))


def test_loss_decreases_tinyllama():
    """The reference suite's case on the port: 12 steps of reduced
    TinyLlama, batch 8 × 64, lr 1e-3 after 5 warmup steps."""
    cfg = tget("tinyllama-1.1b").reduced()
    tr = Trainer(tbuild(cfg), AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=50),
                 loss_chunk=32)
    params, opt = tr.init_state(seed=0, device="cpu")
    losses = []
    for batch in itertools.islice(lm_batches(cfg, DataConfig(batch=8, seq_len=64, seed=0)), 12):
        params, opt, m = tr.train_step(params, opt, {k: _t(v) for k, v in batch.items()})
        assert all(bool(torch.isfinite(m[k])) for k in ("loss", "ce", "grad_norm"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert int(opt.step) == 12


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_leaves_loss_and_grads_bitwise(arch):
    """Remat on against off at the families' grains: the recomputation
    repeats the same CPU products, so the loss, the aux loss and every
    gradient are bitwise equal."""
    cfg = tget(arch).reduced()
    assert cfg.remat
    params = tbuild(cfg).init(seed=0, device="cpu")
    batch = {k: _t(v) for k, v in next(lm_batches(cfg, DataConfig(batch=2, seq_len=24,
                                                                  seed=1))).items()}
    out = []
    for model in (tbuild(cfg), tbuild(dataclasses.replace(cfg, remat=False))):
        tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
        paths, leaves = zip(*tree_leaves(tree))
        loss, parts = lm_loss(model, tree, batch, 8)
        out.append((loss.detach(), parts["moe_aux"].detach(), torch.autograd.grad(loss, leaves)))
    (l1, a1, g1), (l2, a2, g2) = out
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    assert (float(a1) > 0) == cfg.has_moe
    for path, x, y in zip(paths, g1, g2):
        assert torch.equal(x, y), path
