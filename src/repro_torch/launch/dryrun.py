"""The dry run (the port's counterpart of ``repro.launch.dryrun``, with
``launch/cost_analysis.py`` for ``repro.launch.hlo_analysis``).

For an (architecture × input shape × mesh) it builds the step the shape
names — ``Trainer.train_step`` with its AdamW state for a train shape,
``Model.prefill`` for a prefill shape, ``Model.decode_step`` (one token
against a ``seq_len`` cache, no sparse context) for a decode shape — with
every input placed by ``MeshRules.for_mesh(mesh, fsdp=cfg.fsdp)``, and runs
it once as rank 0 of a fake mesh, where it answers for one rank what the
reference's ``.lower().compile()`` answers for one device: does the placed
step fit, how many FLOPs does it take, and how many collective bytes does
it move.

Where the reference lowers over ``ShapeDtypeStruct``s on 512 placeholder
host devices, the port runs the step in eager under a ``FakeTensorMode``
(tensors with shapes and no storage) on torch's fake process group
(``launch.mesh.make_dry_mesh``: collectives are issued and move nothing).
The params are this rank's local shards, made empty from
``Model.param_shapes()`` and ``MeshRules.placements`` (``Model.init`` would
draw every weight: InternVL2-76B's are 137 GB of bf16). One process has
one default process group, so a dry run takes a process of its own, as the
reference's does for its ``XLA_FLAGS``; the CLI sweeps its pairs on one
mesh.

The report has the reference's keys where they have a counterpart:
``flops_per_device``, ``bytes_per_device`` (an upper bound: every eager op
materializes), ``collective_bytes_per_device``, ``collective_per_kind`` and
``collectives`` (``per_kind_bytes``, ``counts``, ``total_bytes``), all of
one rank, and ``memory``: ``argument_bytes`` (the local shards of params,
optimizer state, batch and cache), ``output_bytes``, ``peak_bytes`` (the
high-water mark of live storages over the step, arguments included),
``hbm_bytes`` (the card's, or the caller's number without one) and
``fits``; ``trace_s`` is the wall time of the step's one fake call. XLA's
``lower_s``/``compile_s``, temp and code sizes have no counterpart.
Tokens are int64 (the reference's int32). A chunked scan (xLSTM's) runs
one full chunk and counts it for all of them (``models/scan.py``,
``counting_chunks``), as the reference's count multiplies a loop body by
its trip count; its outputs and boundary states are still allocated whole.

Usage (``--device cpu`` for a mesh of CPU ranks; the default is ``cuda``):

  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out-dir results/dryrun --device cpu
  python -m repro_torch.launch.dryrun --all --multi-pod --optimized
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Union

import torch

from ..configs import ARCH_IDS, get_config
from ..configs.base import InputShape, ModelConfig
from ..configs.shapes import SHAPES, get_shape
from ..models import build_model
from ..models.common import tree_unflatten
from ..models.inputs import input_specs
from ..models.model import COMPUTE_DTYPE
from ..models.scan import counting_chunks
from ..sharding.specs import MeshRules, sharded_compute, use_rules
from ..training import AdamWConfig, Trainer
from ..training.optimizer import init_opt_state
from ..training.train_step import BATCH_AXES
from .cost_analysis import CostCounter, local_tensors
from .mesh import make_dry_mesh, production_shape

# an H100's 80 GB, the budget without a card to ask
DEFAULT_HBM_BYTES = 80 * 10**9


def _placed_empty(shape, dtype, axes, rules: MeshRules, device):
    """A DTensor of ``shape`` laid out by its logical ``axes`` whose local
    shard is an empty tensor (under a ``FakeTensorMode``, one that holds no
    storage)."""
    return rules.full(shape, axes, None, dtype, device)


def fake_params(model, rules: MeshRules, device):
    """The param tree as local shards of ``Model.param_shapes()``, placed by
    their logical axes; no weight is drawn."""
    return tree_unflatten(
        (name, _placed_empty(shape, COMPUTE_DTYPE, axes, rules, device))
        for name, (shape, _, axes) in model.param_shapes().items())


def _resolve(arch: Union[str, ModelConfig], shape: Union[str, InputShape]):
    cfg = get_config(arch) if isinstance(arch, str) else arch
    return cfg, get_shape(shape) if isinstance(shape, str) else shape


def build_step(arch: Union[str, ModelConfig], shape_name: Union[str, InputShape], mesh,
               rules: MeshRules, optimized: bool = False, device="cuda"):
    """(fn, args) of the pair: ``fn(*args)`` is the step on placed inputs.
    Call it under a ``FakeTensorMode`` and the installed ``rules``.
    ``optimized`` applies the reference's beyond-paper changes
    (``cfg.optimized_for`` the mesh's model axis). ``arch`` and
    ``shape_name`` may be a config and a shape themselves."""
    cfg, shape = _resolve(arch, shape_name)
    if optimized:
        cfg = cfg.optimized_for(int(rules.axis_size("model")))
    model = build_model(cfg)
    params = fake_params(model, rules, device)
    batch = {k: _placed_empty(v.shape, v.dtype, BATCH_AXES[k], rules, device)
             for k, v in input_specs(cfg, shape, device).items()}
    if shape.kind == "train":
        trainer = Trainer(model, AdamWConfig(), loss_chunk=512)
        return trainer.train_step, (params, init_opt_state(params), batch)
    if shape.kind == "prefill":
        def prefill(params, batch):
            with sharded_compute():
                return model.prefill(params, batch, shape.seq_len)

        return prefill, (params, batch)
    # under the installed rules each rank makes only its block of the cache
    cache = model.init_cache(shape.global_batch, shape.seq_len, torch.device(device))

    def decode(params, token, cache):
        with sharded_compute():
            return model.decode_step(params, token, cache)

    return decode, (params, batch["tokens"], cache)


def run_dryrun(arch: Union[str, ModelConfig], shape_name: Union[str, InputShape],
               multi_pod: bool = False, mesh=None, verbose: bool = True,
               optimized: bool = False, device: str = "cuda",
               hbm_bytes: Optional[int] = None, count_chunks: bool = True) -> Dict[str, Any]:
    """The report of one pair (see the module doc) on ``mesh`` (default: the
    production mesh as a fake one, which initialises this process's
    group). ``count_chunks`` False traces every step of a chunked scan
    instead of one chunk for all (the check of that count)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if mesh is None:
        mesh = make_dry_mesh(*production_shape(multi_pod), device_type=device)
    cfg, shape = _resolve(arch, shape_name)
    rules = MeshRules.for_mesh(mesh, fsdp=cfg.fsdp)
    if optimized:
        rules = dataclasses.replace(rules, seq_shard_attention=True)
    if hbm_bytes is None:
        hbm_bytes = (torch.cuda.get_device_properties(0).total_memory
                     if torch.cuda.is_available() else DEFAULT_HBM_BYTES)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=False), use_rules(rules):
        fn, args = build_step(cfg, shape, mesh, rules, optimized=optimized,
                              device=mesh.device_type)
        counter = CostCounter()
        arg_bytes = counter.track(local_tensors(args))
        with counter, counting_chunks(counter if count_chunks else None):
            out = fn(*args)
        out_bytes = sum(t.untyped_storage().nbytes() for t in local_tensors(out))
    trace_s = time.perf_counter() - t0
    cost = counter.summary()
    report = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": {"axes": {name: int(mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names)},
                 "device_type": mesh.device_type},
        "multi_pod": multi_pod,
        "optimized": optimized,
        "flops_per_device": cost["flops"],
        "bytes_per_device": cost["bytes"],
        "collective_bytes_per_device": cost["collective_bytes"],
        "collective_per_kind": cost["collective_per_kind"],
        "collectives": cost["collectives"],
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "peak_bytes": cost["peak_bytes"], "hbm_bytes": int(hbm_bytes),
                   "fits": cost["peak_bytes"] <= hbm_bytes},
        "trace_s": trace_s,
    }
    if verbose:
        print(json.dumps(report, indent=2, default=str))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="sweep all arch × shape")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the beyond-paper sharding changes (optimized_for, "
                         "sequence-sharded attention)")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the fake mesh's device type (nothing is allocated on it)")
    ap.add_argument("--hbm-bytes", type=int, default=None,
                    help="a device's memory for 'fits' (default: the card's, or 80e9 "
                         "without one)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    mesh = make_dry_mesh(*production_shape(args.multi_pod), device_type=args.device)
    pairs = ([(a, s) for a in ARCH_IDS for s in sorted(SHAPES)] if args.all
             else [(args.arch, args.shape)])
    failures = []
    for arch, shape in pairs:
        tag = f"{arch}__{shape}__{'pod2' if args.multi_pod else 'pod1'}"
        if args.optimized:
            tag += "__opt"
        try:
            rep = run_dryrun(arch, shape, args.multi_pod, mesh=mesh, verbose=not args.all,
                             optimized=args.optimized, hbm_bytes=args.hbm_bytes)
            status = "OK"
        except Exception as e:  # noqa: BLE001 — the sweep reports every failure
            rep = {"arch": arch, "shape": shape, "error": repr(e)[:2000]}
            failures.append(tag)
            status = f"FAIL: {repr(e)[:200]}"
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            with open(os.path.join(args.out_dir, tag + ".json"), "w") as f:
                json.dump(rep, f, indent=2, default=str)
        print(f"[dryrun] {tag}: {status}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
