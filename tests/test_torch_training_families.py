"""One training step of the port against the JAX reference's
``Trainer.train_step`` and ``jax.grad`` of its ``lm_loss``, for every
family's ``--reduced`` config in bf16 (the compute dtype of both): dense
(TinyLlama), the early-fusion VLM (InternVL2: the text offset), MoE
(OLMoE: the aux loss), gelu with biases (StarCoder2-3B), the tied head
(Granite), the hybrid (Zamba2), the recurrent (xLSTM) and the
encoder-decoder (Whisper). The reference's params and a batch of its
``lm_batches`` are carried over; AdamW runs at lr 1e-2 with one warmup
step, so the update is visible.

bf16 gradients differ between the frameworks by rounding order, and
Adam's first step is about ±lr·sign(g), which flips where |g| is tiny, so
the updated params are not compared elementwise. The bounds, beside the
largest gap measured over the eight families on the CPU:
  loss, ce, moe_aux   relative 5e-3   (measured 1.33e-4, Zamba2)
  grad_norm           relative 2e-2   (6.72e-5 - 5.53e-4)
  lr                  relative 1e-6   (equal)
  gradients           relative L2 5e-2 a leaf (2.76e-2, Zamba2's dt_bias)
                      and cosine >= 0.995 (0.99964)
  moments m / v       relative L2 5e-2 / 1e-1 a leaf (2.74e-2 / 4.44e-2;
                      v is quadratic in g, so twice the gradients' bound)
The reference's step and gradients are jitted together, once a family.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import DataConfig as JData
from repro.data import lm_batches as jbatches
from repro.models import build_model as jbuild
from repro.training import AdamWConfig as JAdamW
from repro.training import Trainer as JTrainer
from repro.training import init_opt_state as j_init_opt
from repro.training import lm_loss as j_lm_loss
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.training import AdamWConfig, Trainer, init_opt_state, lm_loss
from repro_torch.models.common import tree_leaves, tree_map

FAMILIES = ("tinyllama-1.1b", "internvl2-76b", "olmoe-1b-7b", "starcoder2-3b", "granite-3-2b",
            "zamba2-7b", "xlstm-125m", "whisper-small")
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)
BATCH, SEQ, LOSS_CHUNK = 2, 32, 16
METRIC_RTOL = {"loss": 5e-3, "ce": 5e-3, "moe_aux": 5e-3, "grad_norm": 2e-2, "lr": 1e-6}
GRAD_REL, GRAD_COS, M_REL, V_REL = 5e-2, 0.995, 5e-2, 1e-1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32), dtype=np.float64)


def _ref_leaves(tree):
    """{"top" or "top/sub": leaf} of a reference tree."""
    return {"/".join(str(q.key) for q in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel_cos(got: torch.Tensor, want) -> tuple:
    a, b = got.double().numpy(), _f64(want)
    nb = np.linalg.norm(b)
    if nb == 0:
        return float(np.linalg.norm(a)), 1.0
    return (float(np.linalg.norm(a - b) / nb),
            float((a * b).sum() / max(np.linalg.norm(a) * nb, 1e-300)))


@pytest.fixture(scope="module", params=FAMILIES)
def step(request):
    arch = request.param
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    batch = next(jbatches(jcfg, JData(batch=BATCH, seq_len=SEQ, seed=3)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jt = JTrainer(jm, JAdamW(**OPT), loss_chunk=LOSS_CHUNK)

    def both(p, o, b):
        return jt.train_step(p, o, b), jax.grad(lambda q: j_lm_loss(jm, q, b, LOSS_CHUNK)[0])(p)

    (_, j_opt, j_metrics), j_grads = jax.jit(both)(jp, j_init_opt(jp), jb)

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    carried = jax.device_get(jp)
    tree = tree_map(lambda p: p.detach().requires_grad_(True),
                    params_from_reference(carried, tcfg, "cpu"))
    paths, leaves = zip(*tree_leaves(tree))
    loss, _ = lm_loss(tm, tree, tb, LOSS_CHUNK)
    t_grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    tt = Trainer(tm, AdamWConfig(**OPT), loss_chunk=LOSS_CHUNK)
    tp = params_from_reference(carried, tcfg, "cpu")
    _, t_opt, t_metrics = tt.train_step(tp, init_opt_state(tp), tb)
    return dict(arch=arch, cfg=tcfg, j_metrics=j_metrics, j_grads=_ref_leaves(j_grads),
                j_m=_ref_leaves(j_opt.m), j_v=_ref_leaves(j_opt.v), t_grads=t_grads,
                t_opt=t_opt, t_metrics=t_metrics)


def test_metrics_match_reference(step):
    tm, jm = step["t_metrics"], step["j_metrics"]
    assert sorted(tm) == sorted(jm) == sorted(METRIC_RTOL)
    for key, rtol in METRIC_RTOL.items():
        assert tm[key].dtype == torch.float32 and bool(torch.isfinite(tm[key]))
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=rtol, abs=1e-12), key
    # the MoE aux loss is non-zero for OLMoE only, and enters the loss
    assert (float(tm["moe_aux"]) > 0) == step["cfg"].has_moe
    assert float(tm["loss"]) == pytest.approx(float(tm["ce"]) + float(tm["moe_aux"]), rel=1e-6)


def test_grads_match_reference(step):
    got, want = step["t_grads"], step["j_grads"]
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()), key
        rel, cos = _rel_cos(g, want[key])
        assert rel <= GRAD_REL and cos >= GRAD_COS, (key, rel, cos)


def test_moments_match_reference(step):
    opt = step["t_opt"]
    assert int(opt.step) == 1
    for tree, want, bound in ((opt.m, step["j_m"], M_REL), (opt.v, step["j_v"], V_REL)):
        for key, leaf in tree_leaves(tree):
            assert leaf.dtype == torch.float32
            rel, _ = _rel_cos(leaf, want[key])
            assert rel <= bound, (key, rel)
