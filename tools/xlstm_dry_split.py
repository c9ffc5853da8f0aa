#!/usr/bin/env python3
"""Per-rank dry-run counts of one architecture, cut to a few blocks, in the
JAX reference and in the port, on the CPU: where the two splits over the
(16, 16) mesh agree (made for xLSTM-125M's sLSTM and mLSTM blocks, hence
the name; ``--arch`` takes any).

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/xlstm_dry_split.py reference \\
        --layers 1 --slstm 0 --shape prefill_32k
    PYTHONPATH=src python3 tools/xlstm_dry_split.py port --layers 1 --slstm 0 --shape prefill_32k
    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/xlstm_dry_split.py reference \\
        --arch tinyllama-1.1b --layers 6 --shape train_4k

``reference``: the reference dry run's ``build_step`` for ``--arch`` with
``n_layers`` (and, for xLSTM, ``slstm_layers``) replaced, jitted with its
in-shardings on a (16, 16) mesh of 512 CPU host devices with Auto axes
(jax 0.9 makes Explicit ones by default, which the reference's sharding
constraints refuse), lowered and compiled; prints its trip-count-corrected
``analyze_hlo`` FLOPs and collective bytes a device, the collectives'
counts (each op times its computation's trip multiplier, as
``analyze_hlo`` weighs their bytes) and its temp bytes, and, for each loop
body that holds a product, the products and collectives of one trip
(shape, replica groups). ``port``: the port's ``run_dryrun`` of the same
config on its fake (16, 16) mesh (``--device cpu``): FLOPs, collective
bytes and counts by kind and peak bytes a rank.

``--products``: both sides also print every product's FLOPs a rank summed
by its shapes (the reference: each ``dot`` and ``convolution`` of the
compiled module times its trip multiplier, keyed by result shape, lhs
shape and contracting dims; the port: each product op that the dry run's
counter prices, keyed by op and operand shapes, a chunked scan's skipped
chunks included), largest first. ``--slstm`` takes the sLSTM blocks'
indices, comma-separated (empty: none; only xLSTM has them).
"""
import argparse
import collections
import dataclasses
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cut(cfg, layers, slstm):
    if cfg.name.startswith("xlstm"):
        return dataclasses.replace(cfg, n_layers=layers, slstm_layers=slstm)
    return dataclasses.replace(cfg, n_layers=layers)


def _print_products(products):
    total = sum(products.values())
    print(f"products: {len(products)} kinds, {total:.6e} FLOP a device")
    for key, flops in sorted(products.items(), key=lambda kv: -kv[1]):
        print(f"  {flops:.6e}  {key}")


def _reference_products(hlo):
    """{(kind, result shape, lhs shape, contracting dims): FLOPs} and
    {collective kind: count}, each op weighted by its computation's trip
    multiplier (``analyze_hlo``'s own)."""
    from repro.launch import hlo_analysis as ha

    comps, entry = ha.parse_module(hlo)
    mult = ha._multipliers(comps, entry)
    defs = {op.name: op.result_shape for c in comps.values() for op in c.ops}
    products, counts = collections.Counter(), collections.Counter()
    for name, comp in comps.items():
        m = mult.get(name, 0.0)
        for op in comp.ops:
            if op.kind in ("dot", "convolution"):
                lhs = defs.get(op.operands[0], "") if op.operands else ""
                dims = re.search(r"lhs_contracting_dims={([\d,]*)}", op.line)
                flops = ha._dot_flops(op, defs) if op.kind == "dot" else ha._conv_flops(op, defs)
                products[(op.kind, op.result_shape, lhs, dims.group(1) if dims else "")] += \
                    m * flops
            base = op.kind.replace("-start", "")
            if m and base in ha._COLLECTIVES and not op.kind.endswith("-done"):
                counts[base] += m
    return products, counts


def reference(arch, layers, slstm, shape, products):
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=512 "
                               + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, ROOT)
    import conftest  # noqa: F401  (the Pallas aliases the reference needs under jax 0.9)
    import jax
    from jax.sharding import AxisType

    from repro.launch import dryrun as rd
    from repro.launch.hlo_analysis import analyze_hlo

    whole = rd.get_config
    rd.get_config = lambda name: _cut(whole(name), layers, slstm)
    mesh = jax.make_mesh((16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rules = rd.MeshRules.for_mesh(mesh, fsdp=rd.get_config(arch).fsdp)
    with rd.use_rules(rules), mesh:
        fn, args, shardings, donate = rd.build_step(arch, shape, mesh, rules)
        compiled = jax.jit(fn, in_shardings=shardings,
                           donate_argnums=donate).lower(*args).compile()
    hlo = compiled.as_text()
    counts = analyze_hlo(hlo)
    prods, coll_counts = _reference_products(hlo)
    print(json.dumps({"flops": counts["flops"], "collective_bytes": counts["collective_bytes"],
                      "collective_per_kind": counts.get("collective_per_kind"),
                      "collective_counts": dict(coll_counts),
                      "temp_bytes": compiled.memory_analysis().temp_size_in_bytes}))
    if products:
        _print_products(prods)
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


def _product_counter():
    """The dry run's CostCounter, also keeping each product's FLOPs by op and
    operand shapes (a chunked scan's skipped chunks added as their counts
    are)."""
    import torch
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import flop_registry

    from repro_torch.launch import cost_analysis

    class Products(cost_analysis.CostCounter):
        hist = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = self.flops
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and self.flops != before \
                    and func._overloadpacket in flop_registry:
                shapes = tuple(tuple(t.shape) for t in tree_flatten((args, kwargs))[0]
                               if isinstance(t, torch.Tensor))
                Products.hist[(func._overloadpacket.__name__, shapes)] += self.flops - before
            return out

        def _totals(self):
            return {**super()._totals(), "hist": collections.Counter(Products.hist)}

        def measured(self):
            import contextlib

            @contextlib.contextmanager
            def go():
                before = collections.Counter(Products.hist)
                with super(Products, self).measured() as delta:
                    yield delta
                delta["hist"] = Products.hist - before

            return go()

        def add(self, delta, times):
            super().add(delta, times)
            for key, flops in delta.get("hist", {}).items():
                Products.hist[key] += flops * times

    return Products


def port(arch, layers, slstm, shape, products):
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_mesh

    cfg = _cut(get_config(arch), layers, slstm)
    mesh = make_dry_mesh((16, 16), ("data", "model"), "cpu")
    if products:
        dryrun.CostCounter = _product_counter()
    rep = dryrun.run_dryrun(cfg, shape, mesh=mesh, verbose=False, device="cpu")
    print(json.dumps({"flops": rep["flops_per_device"],
                      "collective_per_kind": rep["collective_per_kind"],
                      "collective_counts": rep["collectives"]["counts"],
                      "peak_bytes": rep["memory"]["peak_bytes"]}))
    if products:
        _print_products(dryrun.CostCounter.hist)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("side", choices=("reference", "port"))
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--slstm", default="0")
    ap.add_argument("--shape", default="prefill_32k")
    ap.add_argument("--products", action="store_true")
    args = ap.parse_args()
    slstm = tuple(int(i) for i in args.slstm.split(",") if i)
    (reference if args.side == "reference" else port)(args.arch, args.layers, slstm,
                                                      args.shape, args.products)


if __name__ == "__main__":
    main()
