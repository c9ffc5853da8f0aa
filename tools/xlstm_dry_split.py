#!/usr/bin/env python3
"""xLSTM-125M's per-rank dry-run counts, cut to a few blocks, in the JAX
reference and in the port, on the CPU: where the two sLSTM (or mLSTM)
splits over the (16, 16) mesh agree.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/xlstm_dry_split.py reference \\
        --layers 1 --slstm 0 --shape prefill_32k
    PYTHONPATH=src python3 tools/xlstm_dry_split.py port --layers 1 --slstm 0 --shape prefill_32k

``reference``: the reference dry run's ``build_step`` for ``xlstm-125m`` with
``n_layers`` and ``slstm_layers`` replaced, jitted with its in-shardings on
a (16, 16) mesh of 512 CPU host devices with Auto axes (jax 0.9 makes
Explicit ones by default, which the reference's sharding constraints
refuse), lowered and compiled; prints its trip-count-corrected
``analyze_hlo`` FLOPs and collective bytes a device and its temp bytes,
and, for each loop body that holds a product, the products and
collectives of one trip (shape, replica groups). ``port``: the port's
``run_dryrun`` of the same config on its fake (16, 16) mesh (``--device
cpu``): FLOPs, collective bytes by kind and peak bytes a rank. ``--slstm``
takes the sLSTM blocks' indices, comma-separated (empty: none).
"""
import argparse
import dataclasses
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cut(cfg, layers, slstm):
    return dataclasses.replace(cfg, n_layers=layers, slstm_layers=slstm)


def reference(layers, slstm, shape):
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=512 "
                               + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, ROOT)
    import conftest  # noqa: F401  (the Pallas aliases the reference needs under jax 0.9)
    import jax
    from jax.sharding import AxisType

    from repro.launch import dryrun as rd
    from repro.launch.hlo_analysis import analyze_hlo

    whole = rd.get_config
    rd.get_config = lambda arch: _cut(whole(arch), layers, slstm)
    mesh = jax.make_mesh((16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rules = rd.MeshRules.for_mesh(mesh, fsdp=rd.get_config("xlstm-125m").fsdp)
    with rd.use_rules(rules), mesh:
        fn, args, shardings, donate = rd.build_step("xlstm-125m", shape, mesh, rules)
        compiled = jax.jit(fn, in_shardings=shardings,
                           donate_argnums=donate).lower(*args).compile()
    hlo = compiled.as_text()
    counts = analyze_hlo(hlo)
    print(json.dumps({"flops": counts["flops"], "collective_bytes": counts["collective_bytes"],
                      "collective_per_kind": counts.get("collective_per_kind"),
                      "temp_bytes": compiled.memory_analysis().temp_size_in_bytes}))
    # one trip of every loop body (a computation a while op calls) with a product
    bodies = set(re.findall(r"while\([^)]*\)[^\n]*body=(%[\w.\-]+)", hlo))
    for comp in re.split(r"\n(?=%|ENTRY)", hlo):
        name = comp.split(" ", 1)[0]
        if name not in bodies or " dot(" not in comp:
            continue
        print(f"loop body {name}:")
        for line in comp.splitlines():
            for kind in ("dot", "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                         "collective-permute"):
                if f" {kind}(" in line:
                    result = line.split("=", 1)[1].strip().split(" ", 1)[0]
                    groups = re.search(r"replica_groups=(\S+)", line)
                    print(f"  {kind} {result} {groups.group(1).rstrip(',') if groups else ''}")


def port(layers, slstm, shape):
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_dryrun
    from repro_torch.launch.mesh import make_dry_mesh

    cfg = _cut(get_config("xlstm-125m"), layers, slstm)
    mesh = make_dry_mesh((16, 16), ("data", "model"), "cpu")
    rep = run_dryrun(cfg, shape, mesh=mesh, verbose=False, device="cpu")
    print(json.dumps({"flops": rep["flops_per_device"],
                      "collective_per_kind": rep["collective_per_kind"],
                      "collective_counts": rep["collectives"]["counts"],
                      "peak_bytes": rep["memory"]["peak_bytes"]}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("side", choices=("reference", "port"))
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--slstm", default="0")
    ap.add_argument("--shape", default="prefill_32k")
    args = ap.parse_args()
    slstm = tuple(int(i) for i in args.slstm.split(",") if i)
    (reference if args.side == "reference" else port)(args.layers, slstm, args.shape)


if __name__ == "__main__":
    main()
