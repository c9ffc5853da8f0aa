"""The port's sharding vocabulary and serve-mesh logic against the JAX
reference, in one process (the engine on a 2×2 mesh is
``tests/test_torch_sharded_serving.py``).

Tolerances: specs, tables, byte lanes, configs and error messages are
compared exactly. The KV-replicated model is held to the reference's same
model at the bf16 tolerance of ``tests/test_torch_model.py`` (atol = rtol =
4e-2: both packages round at the same places and reduce in other orders),
and to the port's unreplicated model exactly (replication copies heads,
the attention's arithmetic is the same).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import InputShape as JShape
from repro.core.offload import FlashOffloadSimulator as JSim
from repro.launch.serve import resolve_mesh as j_resolve_mesh
from repro.models import build_model as jbuild
from repro.models.inputs import make_dummy_batch as jbatch
from repro.sharding.serve import ServeMesh as JServeMesh
from repro.sharding.serve import shard_block_tables as j_shard_block_tables
from repro.sharding.serve import validate_serve_mesh as j_validate
from repro.sharding.specs import MeshRules as JRules
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape as TShape
from repro_torch.core.offload import FlashOffloadSimulator as TSim
from repro_torch.launch.serve import resolve_mesh as t_resolve_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.models.inputs import make_dummy_batch as tbatch
from repro_torch.sharding import (
    DECODE_WEIGHT_AXES,
    ROW_SHARDED_WEIGHTS,
    MeshRules as TRules,
    ServeMesh as TServeMesh,
    logical_to_spec,
    shard_act,
    shard_block_tables as t_shard_block_tables,
    use_rules,
    validate_serve_mesh as t_validate,
)
from torch_threads import one_thread  # noqa: F401

BF16_TOL = dict(atol=4e-2, rtol=4e-2)


class FakeMesh:
    """The reference tests' mesh-like: axis names and a shape dict."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _rules(shape=(2, 2), axes=("data", "model"), fsdp=False):
    mesh = FakeMesh(shape, axes)
    return JRules.for_mesh(mesh, fsdp=fsdp), TRules.for_mesh(mesh, fsdp=fsdp)


# the five cases of tests/test_sharding.py, each (mesh shape, axes, fsdp,
# logical axes, tensor shape)
RULE_CASES = {
    "divisibility_36_heads": ((4, 16), ("data", "model"), False,
                              ("batch", None, "heads", None), (8, 1, 36, 128)),
    "divisibility_64_heads": ((4, 16), ("data", "model"), False,
                              ("batch", None, "heads", None), (8, 1, 64, 128)),
    "cache_seq_fallback": ((16, 16), ("data", "model"), False,
                           ("layer", "batch", "cache_seq", "cache_kv_heads", "head_dim"),
                           (22, 128, 32768, 8, 64)),
    "cache_kv_takes_model": ((16, 16), ("data", "model"), False,
                             ("layer", "batch", "cache_seq", "cache_kv_heads", "head_dim"),
                             (22, 128, 32768, 16, 64)),
    "no_axis_reuse": ((2, 2), ("data", "model"), False, ("heads", "ffn"), (4, 8)),
    "multipod_batch": ((2, 16, 16), ("pod", "data", "model"), False,
                       ("batch", None), (256, 4096)),
    "multipod_batch_1": ((2, 16, 16), ("pod", "data", "model"), False,
                         ("batch", None), (1, 1)),
    "fsdp_embed": ((16, 16), ("data", "model"), True, ("embed", "ffn"), (8192, 28672)),
    "no_fsdp_embed": ((16, 16), ("data", "model"), False, ("embed", "ffn"), (8192, 28672)),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_mesh_rules_spec_equals_reference(case):
    shape, axes, fsdp, logical, tshape = RULE_CASES[case]
    jr, tr = _rules(shape, axes, fsdp)
    assert tr.spec(logical, tshape) == tuple(jr.spec(logical, tshape))
    assert tr.spec(logical) == tuple(jr.spec(logical))
    assert tr.rules == jr.rules and tr.fallbacks == jr.fallbacks
    for axis in (None, "model", ("pod", "data") if "pod" in axes else "data"):
        assert tr.axis_size(axis) == jr.axis_size(axis)


def test_decode_weight_specs_equal_reference():
    """ServeMesh.weight_spec / scale_spec of every decode-streamed matrix on
    a 2×2 and a 1×3 mesh (rules over a fake mesh: the specs are metadata),
    divisible and not."""
    for shape in ((2, 2), (1, 3)):
        jr, tr = _rules(shape)
        jm = JServeMesh(shape[0], shape[1], None, jr)
        tm = TServeMesh(shape[0], shape[1], None, tr)
        for name in DECODE_WEIGHT_AXES:
            for dims in ((2, 256, 704), (2, 704, 256), (2, 24, 36)):
                js, ts = jm.weight_spec(name, dims), tm.weight_spec(name, dims)
                assert ts == tuple(js), (name, dims)
                assert tm.scale_spec(ts) == tuple(jm.scale_spec(js))
        for n in (64, 704, 24, 48):
            assert tm.row_shard_count(n) == 1  # no DeviceMesh: unsharded
    assert set(ROW_SHARDED_WEIGHTS) == {"wo", "w_down", "w_proj"}


def test_rules_are_inert_until_installed():
    x = torch.ones(4, 4)
    assert shard_act(x, ("batch", None)) is x
    assert logical_to_spec(("batch", "heads"), (4, 4)) == ()
    _, tr = _rules((2, 2))
    with use_rules(tr):
        assert logical_to_spec(("batch", "heads"), (4, 4)) == ("data", "model")
        # installed rules redistribute DTensors; a plain tensor is an error
        with pytest.raises(TypeError, match="needs a DTensor"):
            shard_act(x, ("batch", None))
    assert logical_to_spec(("batch",)) == ()


def _err(fn, *a, **kw):
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


def test_validate_serve_mesh_errors_equal_reference():
    t_validate(1, 1)
    j_validate(1, 1)
    for args, kw in (((0, 2), {}), ((2, 1), dict(batch=3, n_devices=8)),
                     ((2, 1), dict(batch=2, streams=5, n_devices=8)),
                     ((1, 3), dict(d_ff=704, n_devices=8))):
        assert _err(t_validate, *args, **kw) == _err(j_validate, *args, **kw)
    msg = _err(t_validate, 2, 2, n_devices=2)
    ref = _err(j_validate, 2, 2, n_devices=2)
    # the same message up to the hint: torchrun ranks, not simulated XLA devices
    assert msg.split(";")[0] == ref.split(";")[0]
    assert "torchrun --nproc-per-node 4" in msg


def test_resolve_mesh_cli_errors_equal_reference():
    """A bad --mesh fails before any model is built, with the reference's
    messages; 1,1 is the inert single mesh. One process: a 2,1 mesh needs
    more ranks than the world has."""
    jcfg, tcfg = jget("internvl2-76b").reduced(), tget("internvl2-76b").reduced()
    for spec in ("2", "a,b", "2,1,1"):
        assert _err(t_resolve_mesh, spec, tcfg, 2, 0, "cpu") == \
            _err(j_resolve_mesh, spec, jcfg, batch=2, streams=0)
    assert "torchrun" in _err(t_resolve_mesh, "2,1", tcfg, 2, 3, "cpu")
    mesh = t_resolve_mesh("1,1", tcfg, 2, 0, "cpu")
    assert not mesh.is_sharded and mesh.size == 1


def test_cli_mesh_flag_equals_reference():
    from repro.launch.serve import build_parser as jparser
    from repro_torch.launch.serve import build_parser as tparser

    j = {a.dest: a for a in jparser()._actions}["mesh"]
    t = {a.dest: a for a in tparser()._actions}["mesh"]
    assert (t.option_strings, t.default, t.metavar, t.type) == \
        (j.option_strings, j.default, j.metavar, j.type)


def test_single_mesh_is_inert():
    mesh = TServeMesh.single()
    assert not mesh.is_sharded and mesh.size == 1
    x = torch.ones((4, 4))
    assert mesh.replicate(x) is x and mesh.put_batch(x) is x and mesh.gather_batch(x) is x
    tree = {"k": torch.zeros(2, 4), "length": 3}
    assert mesh.place_cache(tree, {"k": ("batch", None), "length": ()}) is tree
    params = {"layers": {"wq": torch.zeros(2, 8, 8)}}
    assert mesh.place_params(params, 16, ("wq",)) is params
    assert mesh.batch_spec((4, 2)) == (None, None) == tuple(JServeMesh.single().batch_spec((4, 2)))
    assert mesh.row_shard_count(64) == 1 and mesh.rank("data") == 0
    assert TServeMesh.create(1, 1, "cpu").mesh is None


def _tables(seed, n_rows, k):
    """A seeded block-aligned chunk table: sorted, non-overlapping starts,
    sizes of 8-row multiples, zero-size padding entries at the end."""
    rng = np.random.default_rng(seed)
    blocks = np.sort(rng.choice(n_rows // 8, size=k, replace=False))
    starts = blocks * 8
    sizes = np.minimum(rng.integers(1, 4, k) * 8, np.diff(np.append(starts, n_rows)))
    sizes[-2:] = 0
    return starts.astype(np.int32), sizes.astype(np.int32)


@pytest.mark.parametrize("seed,n_rows,n_shards", [(0, 64, 2), (1, 704, 2), (2, 256, 4),
                                                  (3, 512, 8)])
def test_shard_block_tables_equal_reference(seed, n_rows, n_shards):
    starts, sizes = _tables(seed, n_rows, 6)
    jcs, jcz = j_shard_block_tables(starts, sizes, n_rows, n_shards)
    tcs, tcz = t_shard_block_tables(torch.from_numpy(starts), torch.from_numpy(sizes),
                                    n_rows, n_shards)
    np.testing.assert_array_equal(tcs.numpy(), np.asarray(jcs))
    np.testing.assert_array_equal(tcz.numpy(), np.asarray(jcz))
    assert tcs.dtype == torch.int32 and tuple(tcs.shape) == (n_shards, 6)
    assert int(tcz.sum()) == int(sizes.sum())
    seg = n_rows // n_shards
    for s in range(n_shards):
        keep = tcz[s] > 0
        assert bool((tcs[s][keep] >= s * seg).all() and (tcs[s][keep] % 8 == 0).all())
        assert bool(((tcs[s] + tcz[s])[keep] <= (s + 1) * seg).all())


def test_shard_block_tables_straddle_and_divisibility():
    """A chunk across the shard boundary splits in two halves (numpy input
    as well as tensors); rows that do not divide into whole 8-row blocks
    per shard are refused with the reference's message."""
    cs, cz = t_shard_block_tables(np.array([24]), np.array([16]), 64, 2)
    jcs, jcz = j_shard_block_tables(jnp.asarray([24]), jnp.asarray([16]), 64, 2)
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs))
    np.testing.assert_array_equal(cz.numpy(), np.asarray(jcz))
    assert cz.tolist() == [[8], [8]] and cs.tolist() == [[24], [32]]
    assert _err(t_shard_block_tables, np.array([0]), np.array([8]), 24, 2) == \
        _err(j_shard_block_tables, jnp.asarray([0]), jnp.asarray([8]), 24, 2)


def test_total_bytes_by_shard_equals_reference():
    """Recorded lanes split exactly, lane-less events evenly, always summing
    to ``total_bytes()``; the two ``ValueError``s; the batched path records
    each step's lanes."""
    sims = [JSim("nano", seed=0), TSim("nano", seed=0)]
    for sim in sims:
        sim.measure_from_estimate(1e-3, nbytes=10.0)
        assert sim.total_bytes_by_shard(1) == (sim.total_bytes(),)
        sim.measure_from_estimate(1e-3, nbytes=100.0, shard_bytes=(60.0, 40.0))
        assert sim.total_bytes_by_shard(2) == (65.0, 45.0)
        sim.measure_from_estimate_batch(np.array([1e-3, 0.0, 2e-3]), nbytes=np.array([8., 0., 4.]),
                                        shard_bytes=np.array([[6., 2.], [0., 0.], [1., 3.]]))
    j, t = sims
    assert t.total_bytes_by_shard(2) == j.total_bytes_by_shard(2) == (72.0, 50.0)
    assert [e.shard_bytes for e in t.log] == [e.shard_bytes for e in j.log]
    assert [e.latency_s for e in t.log] == [e.latency_s for e in j.log]
    assert _err(t.total_bytes_by_shard, 3) == _err(j.total_bytes_by_shard, 3)
    assert _err(t.total_bytes_by_shard, 0) == _err(j.total_bytes_by_shard, 0)


@pytest.mark.parametrize("arch", ["granite-3-2b", "olmoe-1b-7b", "starcoder2-3b", "xlstm-125m"])
def test_kv_replication_configs_equal_reference(arch):
    for tp in (1, 2, 16):
        jc, tc = jget(arch).with_kv_replication(tp), tget(arch).with_kv_replication(tp)
        assert (tc.kv_replicate, tc.n_cache_kv_heads) == (jc.kv_replicate, jc.n_cache_kv_heads)
        jo, to = jget(arch).optimized_for(tp), tget(arch).optimized_for(tp)
        assert (to.kv_replicate, to.moe_dispatch) == (jo.kv_replicate, jo.moe_dispatch)
    assert tget(arch).fsdp is jget(arch).fsdp is False


@pytest.fixture(scope="module")
def kv_pair():
    """Reduced TinyLlama with n_heads 4, n_kv_heads 2 (GQA, so replication
    2 divides the heads), as the reference's test builds it, and its
    kv_replicate 2 twin, in both packages, on the reference's weights."""
    base = dict(n_heads=4, n_kv_heads=2)
    jcfg = dataclasses.replace(jget("tinyllama-1.1b").reduced(), **base)
    tcfg = dataclasses.replace(tget("tinyllama-1.1b").reduced(), **base)
    jp = jbuild(jcfg).init(jax.random.key(0))
    tp = params_from_reference(jax.device_get(jp), tcfg, "cpu")
    jb = jbatch(jcfg, JShape("smoke", 12, 2, "train"))
    tb = tbatch(tcfg, TShape("smoke", 12, 2, "train"), device="cpu")
    return jcfg, tcfg, jp, tp, jb, tb


def test_kv_replicated_decode_equals_reference_and_unreplicated(kv_pair):
    jcfg, tcfg, jp, tp, jb, tb = kv_pair
    jr = jbuild(dataclasses.replace(jcfg, kv_replicate=2))
    t1, tr = tbuild(tcfg), tbuild(dataclasses.replace(tcfg, kv_replicate=2))
    jl, jc = jr.prefill(jp, jb, 32)
    l1, c1 = t1.prefill(tp, tb, 32)
    lr, cr = tr.prefill(tp, tb, 32)
    np.testing.assert_allclose(lr.float().numpy(), np.asarray(jl, np.float32), **BF16_TOL)
    assert torch.equal(lr, l1)
    assert cr["k"].shape[3] == 2 * c1["k"].shape[3] == jc["k"].shape[3]
    assert torch.equal(cr["k"][:, :, :, ::2], c1["k"]) and torch.equal(cr["v"][:, :, :, 1::2],
                                                                       c1["v"])
    tok = jb["tokens"][:, :1]
    jd, _, _ = jr.decode_step(jp, tok, jc)
    d1, _ = t1.decode_step(tp, torch.from_numpy(np.asarray(tok)), c1)
    dr, _ = tr.decode_step(tp, torch.from_numpy(np.asarray(tok)), cr)
    np.testing.assert_allclose(dr.numpy(), np.asarray(jd, np.float32), **BF16_TOL)
    assert torch.equal(dr, d1)
    assert torch.equal(cr["k"][:, :, 12, ::2], c1["k"][:, :, 12])
