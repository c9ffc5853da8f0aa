"""The rest of ``core/`` in the port against the JAX reference, on the CPU:
the device profiles' knee, saturation and throughput, ``mask_latency_np``,
``table_from_measurements`` and its refusals, the simulator's pattern
measurements (``estimate``, ``measure``, ``measure_full_load``, the log and
its totals), the pipeline timeline's totals and ``serial_timeline``, and
the compute lane's per-layer scale, through the engine too. Also the
matching cases of the reference's own suites (``tests/test_latency_model.py``,
``tests/test_core_misc.py``, ``tests/test_pipeline.py``,
``tests/test_chunking.py``, ``tests/test_dma_kernels.py``).

Tolerances: everything here is numpy float64 (or one f32 table, built from
the same float64 values in both packages) and equal inputs give equal
bits, so the comparisons are exact — the simulator's measurements
included, since both packages draw their jitter from the same numpy
stream.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import latency_model as jlm
from repro.core.contiguity import Chunk as JChunk
from repro.core.faults import FaultModel as JFaultModel
from repro.core.offload import ComputeModel as JCompute
from repro.core.offload import FlashOffloadSimulator as JSim
from repro.core.pipeline import PipelineModel as JPipeline
from repro.models import build_model as jbuild
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape as TShape
from repro_torch.core import JETSON_AGX, JETSON_NANO, ComputeModel, PipelineModel, \
    table_from_measurements
from repro_torch.core import latency_model as tlm
from repro_torch.core.contiguity import Chunk
from repro_torch.core.faults import FaultModel
from repro_torch.core.offload import FlashOffloadSimulator
from repro_torch.models import build_model as tbuild
from repro_torch.models.inputs import make_dummy_batch as tbatch
from repro_torch.serving import ServeEngine as TEngine
from torch_threads import one_thread  # noqa: F401

KB = 1024.0


def _masks(seed, n=257):
    """Random masks of every shape of run: scattered, clustered, empty,
    full."""
    rng = np.random.default_rng(seed)
    return [rng.random(n) < 0.3, np.repeat(rng.random(n // 8 + 1) < 0.5, 8)[:n],
            np.zeros(n, bool), np.ones(n, bool)]


@pytest.mark.parametrize("name", ["nano", "agx"])
def test_profile_knee_saturation_throughput(name):
    """knee_bytes, saturation_bytes(frac) and throughput_bytes equal the
    reference's, value for value."""
    t, j = tlm.get_profile(name), jlm.get_profile(name)
    assert t.knee_bytes == j.knee_bytes == t.peak_bw / t.iops
    for frac in (0.5, 0.9, 0.99):
        assert t.saturation_bytes(frac) == j.saturation_bytes(frac)
    sizes = np.logspace(3, 7, 40)
    np.testing.assert_array_equal(t.throughput_bytes(sizes), j.throughput_bytes(sizes))
    thr = t.throughput_bytes(sizes)
    assert (np.diff(thr) >= -1e-6).all()  # monotone nondecreasing
    # at the saturation size the throughput is frac of the peak
    assert float(t.throughput_bytes(t.saturation_bytes(0.9))) / t.peak_bw == \
        pytest.approx(0.9, rel=1e-9)


def test_knee_ratio_tracks_chunk_caps():
    """The reference's ``test_chunking`` case: the agx / nano ratio of the
    chunk caps (348 / 236 KB) tracks the ratio of their knees."""
    assert 348.0 / 236.0 == pytest.approx(JETSON_AGX.knee_bytes / JETSON_NANO.knee_bytes,
                                          rel=0.05)


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_latency_np_equals_reference(seed):
    t = tlm.profile_table("nano", 1024.0, max_rows=64, torch_device="cpu")
    j = jlm.profile_table("nano", 1024.0, max_rows=64)
    for mask in _masks(seed):
        got = t.mask_latency_np(mask)
        assert isinstance(got, float)
        assert got == j.mask_latency_np(mask)
        # the host form agrees with the tensor form
        assert got == pytest.approx(float(t.mask_latency(torch.from_numpy(mask))), rel=1e-5)


def test_table_from_measurements_equals_reference():
    sizes, lats = np.array([1, 4, 16, 64]), np.array([1e-4, 1e-4, 2e-4, 8e-4])
    t = table_from_measurements("custom", 512, sizes, lats, torch_device="cpu")
    j = jlm.table_from_measurements("custom", 512, sizes, lats)
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    assert t.max_rows == j.max_rows == 64
    assert float(t.lookup(torch.tensor(4))) == pytest.approx(1e-4, rel=1e-5)
    # linear between (16, 2e-4) and (64, 8e-4) at 32, and past the end on
    # the last slope, as in the reference
    assert float(t.lookup(torch.tensor(32))) == pytest.approx(4e-4, rel=0.01)
    for rows in (32, 100):
        assert float(t.lookup(torch.tensor(rows))) == float(j.lookup(jnp.asarray(rows)))


@pytest.mark.parametrize("sizes,lats,match", [
    ([1, 4, 4, 64], [1e-4, 2e-4, 2.1e-4, 8e-4], "duplicate measurement sizes"),
    ([1, 4, 16, 64], [1e-4, 3e-4, 2e-4, 8e-4], "reading more can't be faster"),
    ([1, 4, 16], [1e-4, 2e-4], "matching 1-D arrays"),
])
def test_table_from_measurements_refuses_what_the_reference_refuses(sizes, lats, match):
    for build in (jlm.table_from_measurements,
                  lambda *a: table_from_measurements(*a, torch_device="cpu")):
        with pytest.raises(ValueError, match=match):
            build("custom", 512, np.array(sizes), np.array(lats))


def test_table_from_measurements_takes_unsorted_and_plateaus():
    """Validation runs on the size-sorted view: an unsorted but monotone log
    and an IOPS-bound plateau (equal latencies) are fine."""
    t = table_from_measurements("custom", 512, np.array([64, 1, 16, 4]),
                                np.array([8e-4, 1e-4, 1e-4, 1e-4]), torch_device="cpu")
    assert float(t.lookup(torch.tensor(16))) == pytest.approx(1e-4, rel=1e-5)


def _event_fields(log):
    return [(e.name, e.nbytes, e.n_chunks, e.latency_s, e.hit_rate, e.retries, e.fault_s,
             e.integrity_s) for e in log]


@pytest.mark.parametrize("fault_profile", [None, "tail_spikes", "thermal_throttle"])
def test_simulator_pattern_measurements_equal_reference(fault_profile):
    """estimate / estimate_chunks / measure / measure_chunks /
    measure_full_load on the same seed give the same seconds, draw for
    draw (and fault for fault), and the same log, totals and reset."""
    t = FlashOffloadSimulator("agx", seed=3, faults=None if fault_profile is None
                              else FaultModel(fault_profile, seed=5))
    j = JSim("agx", seed=3, faults=None if fault_profile is None
             else JFaultModel(fault_profile, seed=5))
    for i, mask in enumerate(_masks(2, n=1024)):
        assert t.estimate(mask, 2048) == j.estimate(mask, 2048)
        assert t.measure(mask, 2048, name=f"m{i}") == j.measure(mask, 2048, name=f"m{i}")
    chunks = [(0, 7), (9, 1), (40, 33)]
    assert t.estimate_chunks([Chunk(*c) for c in chunks], 512.5) == \
        j.estimate_chunks([JChunk(*c) for c in chunks], 512.5)
    assert t.measure_chunks([Chunk(*c) for c in chunks], 512.5, "c") == \
        j.measure_chunks([JChunk(*c) for c in chunks], 512.5, "c")
    assert t.measure_chunks([], 512.5) == j.measure_chunks([], 512.5)
    assert t.measure_full_load(4096, 1024, "full") == j.measure_full_load(4096, 1024, "full")
    assert _event_fields(t.log) == _event_fields(j.log)
    assert t.total_io_seconds() == j.total_io_seconds() > 0
    assert t.total_bytes() == j.total_bytes() > 0
    assert t.device_time_s == j.device_time_s
    t.reset()
    j.reset()
    assert t.total_io_seconds() == j.total_io_seconds() == 0.0
    # the stream goes on past a reset, in step
    assert t.measure(_masks(3)[0], 64) == j.measure(_masks(3)[0], 64)


def test_simulator_lift_and_fragmentation():
    """The reference's ``test_core_misc`` cases: a proportional lift
    between estimate and measurement (Fig. 5), and a scattered pattern of
    the same bytes far slower than a contiguous one (Fig. 4b)."""
    sim = FlashOffloadSimulator("nano", seed=0, noise=0.02)
    mask = np.zeros(1024, bool)
    mask[:256] = mask[512:768] = True
    lift = np.mean([sim.measure(mask, 2048) for _ in range(50)]) / sim.estimate(mask, 2048)
    assert 1.0 < lift < 1.8
    contig, scattered = np.zeros(2048, bool), np.zeros(2048, bool)
    contig[:1024] = True
    scattered[::2] = True
    assert sim.estimate(scattered, 4096) > 5 * sim.estimate(contig, 4096)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_timeline_totals_equal_reference(depth):
    rng = np.random.default_rng(depth)
    io = rng.random((8, 6)) * rng.choice([0.0, 1.0, 10.0], size=(8, 1))
    comp = rng.random((8, 6))
    t = PipelineModel(prefetch_depth=depth).timeline(io, comp)
    j = JPipeline(prefetch_depth=depth).timeline(io, comp)
    for name in ("serial_total_s", "overlap_total_s", "hidden_s", "hideable_s"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.overlap_efficiency() == j.overlap_efficiency()
    assert t.overlap_total_s <= t.serial_total_s + 1e-12
    assert 0.0 <= t.hidden_s <= t.serial_total_s
    assert 0.0 <= t.overlap_efficiency() <= 1.0
    st, sj = PipelineModel(prefetch_depth=depth).serial_timeline(io, comp), \
        JPipeline(prefetch_depth=depth).serial_timeline(io, comp)
    np.testing.assert_array_equal(st.overlap_s, sj.overlap_s)
    np.testing.assert_allclose(st.overlap_s, st.serial_s, rtol=1e-12)
    assert st.hidden_s == pytest.approx(0.0, abs=1e-12)


def test_timeline_efficiency_edges():
    """Nothing hideable (zero compute) → efficiency 1 and overlapped =
    serial; compute-dominant → every fetch hidden but the cold first one."""
    io = np.random.default_rng(0).random((6, 5))
    tl = PipelineModel().timeline(io, np.zeros(5))
    assert tl.overlap_efficiency() == 1.0 and tl.hideable_s == 0.0
    n, n_layers = 5, 4
    tl = PipelineModel().timeline(np.full((n, n_layers), 1e-4), np.full(n_layers, 1.0))
    np.testing.assert_allclose(tl.overlap_efficiency(), (n * n_layers - 1) / (n * n_layers),
                               rtol=1e-9)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b", "whisper-small"])
def test_compute_layer_scale_equals_reference(arch):
    """decode_layer_seconds(layer_scale=...) and calibrate_layer_scale equal
    the reference's, and bad scales are refused as there."""
    t_cfg, j_cfg = tget(arch), jget(arch)
    walls = np.random.default_rng(1).random(t_cfg.n_layers) + 0.1
    scale = ComputeModel.calibrate_layer_scale(walls)
    np.testing.assert_array_equal(scale, JCompute.calibrate_layer_scale(walls))
    assert abs(scale.mean() - 1.0) < 1e-12
    got = ComputeModel().decode_layer_seconds(t_cfg, sparsity=0.4, tokens=2, layer_scale=scale)
    np.testing.assert_array_equal(
        got, JCompute().decode_layer_seconds(j_cfg, sparsity=0.4, tokens=2, layer_scale=scale))
    np.testing.assert_allclose(got, ComputeModel().decode_layer_seconds(
        t_cfg, sparsity=0.4, tokens=2) * scale)
    for bad in (np.ones(t_cfg.n_layers + 1), -np.ones(t_cfg.n_layers)):
        with pytest.raises(ValueError):
            ComputeModel().decode_layer_seconds(t_cfg, layer_scale=bad)
    with pytest.raises(ValueError):
        ComputeModel.calibrate_layer_scale(np.array([]))
    np.testing.assert_array_equal(ComputeModel.calibrate_layer_scale(np.zeros(3)), np.ones(3))


@pytest.mark.parametrize("method", ["chunk", "dense_free"])
def test_engine_compute_layer_scale(method):
    """The engine's ``compute_layer_scale`` sets the pipeline's compute lane
    as the reference engine's does (built without weights: neither engine
    reads them before a prefill), and re-times a decode without changing
    its tokens."""
    t_cfg, j_cfg = tget("tinyllama-1.1b").reduced(), jget("tinyllama-1.1b").reduced()
    scale = np.linspace(0.2, 1.8, t_cfg.n_layers)
    t = TEngine(tbuild(t_cfg), None, max_seq=32, batch_size=2, method=method,
                compute_layer_scale=scale, torch_device="cpu")
    j = JEngine(jbuild(j_cfg), None, max_seq=32, batch_size=2, method=method,
                compute_layer_scale=scale)
    np.testing.assert_array_equal(t.compute_layer_s, j.compute_layer_s)
    model = tbuild(t_cfg)
    params = model.init(seed=0, device="cpu")
    batch = tbatch(t_cfg, TShape("t", 12, 2, "train"), device="cpu")
    outs, summaries = [], []
    for kw in ({}, {"compute_layer_scale": scale}):
        eng = TEngine(model, params, max_seq=32, batch_size=2, method=method,
                      torch_device="cpu", **kw)
        last = eng.prefill(batch)
        outs.append(eng.decode(torch.argmax(last, dim=-1)[:, None], 3))
        summaries.append(eng.io_summary())
    assert torch.equal(outs[0], outs[1])
    assert summaries[1]["decode_compute_s"] == pytest.approx(
        summaries[0]["decode_compute_s"] * scale.mean(), rel=1e-9)
    assert summaries[1]["decode_overlap_s"] != summaries[0]["decode_overlap_s"]


def test_unchanged_fields_of_the_profiles():
    """The port's profiles are the reference's, field for field."""
    for name in ("nano", "agx"):
        t, j = dataclasses.asdict(tlm.get_profile(name)), dataclasses.asdict(
            jlm.get_profile(name))
        assert t == j
