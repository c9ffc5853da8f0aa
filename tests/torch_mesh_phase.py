"""The port's 2×2 (data, model) mesh paths on four gloo ranks of this
host's CPU, under the installed torch, held to the equalities that the CPU
tests hold them to (each check is defined once, in the rank modules beside
this one). chip_smoke.py runs it as phase 19 on the card's machine, whose
torch is not the one the CPU tests run under; it imports only the port and
those modules, never JAX or the JAX package.

    PYTHONPATH=src python3 tests/torch_mesh_phase.py OUT_DIR

  (a) serving: TinyLlama-1.1B at full width (d 2048, d_ff 5632), its first
      SERVE_LAYERS layers (2 of 22), random weights from seed
      0, the kernel backend (its plain versions on CPU tensors) at wbits 16
      and 8: greedy tokens, selections and bytes on the 2×2 mesh against
      the unsharded engine (``torch_serve_ranks.hold_tokens``); paged KV on
      the 2×2 mesh against the dense cache and the unsharded engine, and
      the MoE decoders at data 2 against the unsharded engine
      (``torch_serve_ranks._extra``, the test's cases and sizes); and the
      full-width cases of ``tests/test_torch_sharded_full_width.py``
      (``torch_serve_ranks.WIDE_CASES``: frame append, ``dense`` and
      ``dense_free`` decode, the StarCoder2, Zamba2, xLSTM and Whisper
      decodes), each frame's hidden states, each rank's cache rows, every
      step's logits and the tokens bitwise the unsharded engine's
      (``hold_wide``);
  (b) training: one f32 step of every case of ``torch_mesh_ranks.CASES``
      against its 1×1 step (``torch_mesh_ranks.hold``: METRIC_RTOL,
      GRAD_REL, GRAD_COS, M_REL, V_REL);
  (c) the local-block regions: the mLSTM, SSD, conv and sLSTM splits
      bitwise per rank to ``torch_layout_ranks.region_by_rank``; the core
      of attention's ``_seq_split``, direct and blockwise, against one
      process (``hold_core``); TinyLlama's and xLSTM's prefill-then-decode
      tokens (``hold_decode``);
  (d) the MoE: ``_moe_ffn_blocks``' per-rank blocks, forward, drops and
      gradients against one process (``torch_moe_ranks``).

The four ranks (one intra-op thread each, at nice 10) run the groups in
turn; this process runs the 1×1 side meanwhile, then holds each check and
prints one line a check with its largest difference, the torch version,
the CPU count and the wall time, and as its last line ``MESH2X2 {json}``.
A group that raises on a rank is reported with its traceback and the
groups after it still run. Exits 1 if any check failed or a rank died.
"""
import argparse
import dataclasses
import datetime
import json
import os
import pickle
import sys
import tempfile
import time
import traceback
import warnings

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_layout_ranks as layout  # noqa: E402
import torch_mesh_ranks as meshr  # noqa: E402
import torch_moe_ranks as moer  # noqa: E402
import torch_procs as procs  # noqa: E402
import torch_serve_ranks as serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import MeshRules, ServeMesh  # noqa: E402

SERVE_ARCH, SERVE_LAYERS, SERVE_WBITS = "tinyllama-1.1b", 2, (16, 8)
GROUPS = ("serve", "train", "layouts", "moe")
NICE = 10
TIMEOUT_S = 900  # the ranks' whole run
GLOO_TIMEOUT_S = 180  # a collective that a failed peer never joins


def _serve_model():
    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_LAYERS)
    model = build_model(cfg)
    return cfg, model, model.init(seed=0, device="cpu")


def serve_group(mesh_or_none):
    """(a): the full-width model's prefill → decode at each wbits, then the
    paged and MoE cases; ``mesh_or_none`` None is the unsharded engine."""
    cfg, model, params = _serve_model()
    out = {}
    for wbits in SERVE_WBITS:
        res = serve._summary(*serve._run(cfg, model, params, mesh_or_none, "kernel", wbits))
        out[wbits] = {k: res[k] for k in ("tokens", "selection", "io_bytes")}
    del params
    out["extra"] = serve._extra(mesh_or_none)
    out["wide"] = {case: serve._wide_serve(mesh_or_none, case) for case in serve.WIDE_CASES}
    return out


def train_group(mesh, rank):
    """(b): one f32 step of each case on the mesh (rank 0 keeps the moments)."""
    out = {}
    for case, (arch, fsdp, optimized) in meshr.CASES.items():
        rules = MeshRules.for_mesh(mesh, fsdp=fsdp)
        out[case] = meshr._step(meshr._cfg(get_config, arch, optimized), rules, "f32",
                                keep=rank == 0)
    return out


def layouts_group(rules, coords):
    """(c) on the mesh (``rules``) or, with None, in one process (the
    regions by rank, as ``region_by_rank`` builds them)."""
    data = layout.case_inputs()
    out = {"coords": coords, "decode": layout.prefill_decode(rules),
           "xlstm_decode": layout.xlstm_prefill_decode(rules)}
    for region in layout.REGIONS:
        out[region] = (getattr(layout, region)(data[region], rules) if rules is not None
                       else layout.region_by_rank(region, data[region]))
    for path in layout.ATTN_PATHS:
        out[("core", path)] = layout.attention_core(path, data["core"], rules)
    return out


def moe_group(rules, coords):
    """(d) on the mesh (``rules``) or, with None, in one process."""
    out = {"coords": coords}
    for case in moer.CASES:
        out[case] = moer.run(*case[:3], moer.inputs(case[0], case[3]), rules)
    return out


def rank_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    os.nice(NICE)
    warnings.filterwarnings("ignore")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    try:
        res, seconds = {}, {}
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        coords = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
        rules = MeshRules.for_mesh(mesh)
        for group in GROUPS:
            t0 = time.perf_counter()
            try:
                if group == "serve":
                    res[group] = serve_group(ServeMesh.create(2, 2, "cpu"))
                elif group == "train":
                    res[group] = train_group(mesh, rank)
                elif group == "layouts":
                    res[group] = layouts_group(rules, coords)
                else:
                    res[group] = moe_group(rules, coords)
            except Exception:  # reported by the parent process, which fails the phase
                res[group] = {"error": traceback.format_exc()}
            seconds[group] = time.perf_counter() - t0
            print(f"{group}: {seconds[group]:.1f} s", flush=True)
        res["seconds"], res["coords"] = seconds, coords
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        procs.drain()
    finally:
        dist.destroy_process_group()


def one_process():
    """The 1×1 side of every group, and each group's seconds."""
    out, seconds = {}, {}
    for group in GROUPS:
        t0 = time.perf_counter()
        if group == "serve":
            out[group] = serve_group(None)
        elif group == "train":
            out[group] = {(arch, optimized): meshr._step(meshr._cfg(get_config, arch, optimized),
                                                         None, "f32")
                          for arch, _, optimized in meshr.CASES.values()}
        elif group == "layouts":
            out[group] = layouts_group(None, None)
        else:
            out[group] = moe_group(None, None)
        seconds[group] = time.perf_counter() - t0
        print(f"[mesh2x2] the 1x1 side of {group}: {seconds[group]:.1f} s", flush=True)
    return out, seconds


class Report:
    """One line a check: its name, its largest differences, ok or the
    failure; the failures kept."""

    def __init__(self):
        self.lines, self.failures = [], []

    def check(self, group, name, fn):
        try:
            worst = fn()
        except Exception as e:  # a check that failed: reported, the phase fails
            msg = f"{type(e).__name__}: {e}"[:600]
            self.failures.append(f"{group} {name}: {msg}")
            self.lines.append({"group": group, "check": name, "ok": False, "error": msg})
            print(f"[mesh2x2] FAIL ({group}) {name}: {msg}", flush=True)
            return
        worst = worst if isinstance(worst, dict) else {"max_diff": worst}
        self.lines.append({"group": group, "check": name, "ok": True, **worst})
        diffs = ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        print(f"[mesh2x2] ({group}) {name}: {diffs}  ok", flush=True)


def hold_serve(rep, ranks, one):
    for wbits in SERVE_WBITS:
        rep.check("a", f"{SERVE_ARCH} full width, wbits {wbits}: 2x2 tokens = unsharded",
                  lambda w=wbits: {"io_bytes_rel": max(serve.hold_tokens(r[w], one[w])
                                                       for r in ranks),
                                   "tokens_max_diff": max(layout.max_abs(r[w]["tokens"],
                                                                         one[w]["tokens"])
                                                          for r in ranks)})
    for key, want in one["extra"].items():
        if key[0] == "paged":
            rep.check("a", f"paged KV {key[1]}-{key[2]}: 2x2 paged = dense = unsharded",
                      lambda key=key, want=want: max(serve.hold_paged(r["extra"][key], want)
                                                     for r in ranks))
        else:
            rep.check("a", f"{key[0]} wbits {key[1]} at data 2: 2x2 tokens = unsharded",
                      lambda key=key, want=want: max(serve.hold_moe(r["extra"][key], want)
                                                     for r in ranks))
    for case, want in one["wide"].items():
        rep.check("a", f"{case} full width: 2x2 frames, cache rows, logits, tokens = unsharded",
                  lambda case=case, want=want: serve.hold_wide([r["wide"][case] for r in ranks],
                                                               want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", help="where the ranks' logs go")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    os.makedirs(args.out_dir, exist_ok=True)
    # the ranks' store and results (hundreds of MB) in a directory of their
    # own, removed at the end; their logs in OUT_DIR
    with tempfile.TemporaryDirectory() as tmp:
        return run(args.out_dir, tmp, t_start)


def run(log_dir, tmp, t_start) -> int:
    torch.set_num_threads(1)
    os.nice(NICE)
    warnings.filterwarnings("ignore")
    print(f"[mesh2x2] torch {torch.__version__}, {os.cpu_count()} CPUs, "
          f"{meshr.WORLD} gloo ranks on a 2x2 (data, model) mesh", flush=True)
    rank_procs = procs.Ranks(rank_main, (meshr.WORLD, os.path.join(tmp, "store"), tmp),
                             meshr.WORLD, log_dir, "mesh2x2")
    rep = Report()
    try:
        one, one_s = one_process()
    except BaseException:
        rank_procs.stop()
        raise
    try:
        rank_procs.wait(TIMEOUT_S)
    except BaseException as e:  # pytest's Failed: a rank died or hung; the phase fails
        print(f"[mesh2x2] FAIL the ranks: {e}"[:6000], flush=True)
        print("MESH2X2 " + json.dumps({"ok": False, "torch": torch.__version__,
                                       "wall_s": time.perf_counter() - t_start}), flush=True)
        return 1
    ranks = []
    for r in range(meshr.WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    for group in GROUPS:
        errors = [(r, res[group]["error"]) for r, res in enumerate(ranks)
                  if isinstance(res[group], dict) and "error" in res[group]]
        for r, tb in errors:
            rep.failures.append(f"{group} on rank {r}: {tb.strip().splitlines()[-1]}")
            print(f"[mesh2x2] FAIL group {group} raised on rank {r}:\n{tb}", flush=True)
        if errors:
            continue
        got = [res[group] for res in ranks]
        if group == "serve":
            hold_serve(rep, got, one[group])
        elif group == "train":
            for case, (arch, _, optimized) in sorted(meshr.CASES.items()):
                rep.check("b", f"train {case} f32: 2x2 step = 1x1 step",
                          lambda case=case, key=(arch, optimized): meshr.hold_mesh_step(
                              [g[case] for g in got], one[group][key]))
        elif group == "layouts":
            want = one[group]
            for region in layout.REGIONS:
                rep.check("c", f"{region} region: bitwise per rank",
                          lambda region=region: max(layout.hold_by_rank(g, region, want[region])
                                                    for g in got))
            for path in layout.ATTN_PATHS:
                rep.check("c", f"attention _seq_split core, {path}",
                          lambda key=("core", path): {"kv_grad_rel": max(
                              layout.hold_core(g[key], want[key]) for g in got)})
            for key in ("decode", "xlstm_decode"):
                rep.check("c", f"{key.replace('_', ' ')}: tokens = one process",
                          lambda key=key: {"logits_rel": max(layout.hold_decode(g[key], want[key])
                                                             for g in got)})
        else:
            for case in moer.CASES:
                name = f"{case[0].split('-')[0]} cf {case[1]} {case[2]} batch {case[3]}"
                rep.check("d", f"moe {name}: blocks bitwise",
                          lambda case=case: moer.hold_blocks(got, case))
                rep.check("d", f"moe {name}: y, aux, drops",
                          lambda case=case: moer.hold_forward(got, case, one[group][case]))
                rep.check("d", f"moe {name}: gradients",
                          lambda case=case: dict(zip(("grad_rel", "grad_cos"), moer.hold_grads(
                              got, case, one[group][case]["grads"]))))
    wall = time.perf_counter() - t_start
    seconds = {"ranks": ranks[0]["seconds"], "one_process": one_s}
    print(f"[mesh2x2] {len(rep.lines)} checks, {len(rep.failures)} failed; wall {wall:.1f} s "
          f"(rank 0: {', '.join(f'{g} {s:.1f} s' for g, s in ranks[0]['seconds'].items())}; "
          f"1x1: {', '.join(f'{g} {s:.1f} s' for g, s in one_s.items())})", flush=True)
    print("MESH2X2 " + json.dumps({"ok": not rep.failures, "torch": torch.__version__,
                                   "cpus": os.cpu_count(), "wall_s": wall, "seconds": seconds,
                                   "checks": rep.lines, "failures": rep.failures}), flush=True)
    return 0 if not rep.failures else 1


if __name__ == "__main__":
    sys.exit(main())
