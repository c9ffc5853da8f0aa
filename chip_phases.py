"""Run chosen phases of ``chip_smoke.py`` on the card, for one checkout or
several, each in its own process and in the order given. Two trees (a
parent and a change) are so compared within one call on one card:

    python3 chip_phases.py --phases 7,10 build/parent . . build/parent

Phase 7 is the InternVL2-76B path (``vlm_path``: prefill, frames, decode
at wbits 16 and 8); phase 10 is TinyLlama-1.1B's continuous batching
(``slot_path``: 8 slots at full width and depth); phase 15 is sharded
serving on a one-rank mesh (``mesh_path``: the operand gathers' device
time a step is on its ``[mesh]`` lines); phase 16 is training on a
one-rank mesh (``mesh_train_path``: TinyLlama-1.1B's mesh steps against
the unsharded ones on its ``[mesh-train]`` lines, OLMoE's expert-parallel
step, the sequence-sharded attention); phase 14 is training TinyLlama-1.1B
at full width and depth (``train_path``), and phase 17 the dry run
(``dryrun_path``: its ``[dryrun]`` lines), which needs phase 14 before it
in the same run. Each tree builds its own
kernels from its own sources. Each run prints the card's name and power
limit, the phases' own log (the decode step's wall is on its ``[vlm] ...
served`` and ``[slots] main path`` lines) and, as its last line, one JSON
object with the tree, the card and the phases' seconds; the phases' whole
report goes to ``chiprun_out/phases_<n>.json``.
"""
from __future__ import annotations

import argparse
import ast
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("7", "10", "14", "15", "16", "17")


def run_tree(tree: Path, phases, index: int, settings) -> None:
    """The phases of ``tree``'s own chip_smoke.py, in this process, with
    its module constants in ``settings`` replaced."""
    spec = importlib.util.spec_from_file_location("chip_smoke", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, value in settings.items():
        if not hasattr(smoke, name):
            sys.exit(f"{tree / 'chip_smoke.py'} has no constant {name}")
        setattr(smoke, name, value)
    sys.path.insert(0, str(tree / "src"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"[tree] {tree}  ({card})", flush=True)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    for src in build.build_all():
        build.library(src)
    dev = torch.device("cuda", 0)
    report, seconds = {}, {}
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "7":
            smoke.vlm_path(dev, get_config(smoke.VLM_ARCH), card, report)
        elif phase == "10":
            smoke.slot_path(dev, get_config("tinyllama-1.1b"), card, report)
        elif phase == "14":
            smoke.train_path(dev, card, report)
        elif phase == "15":
            smoke.mesh_path(dev, get_config(smoke.MESH_ARCH), card, report)
        elif phase == "16":
            smoke.mesh_train_path(dev, card, report)
        else:
            if "training" not in report:
                sys.exit("phase 17 compares with phase 14's step: run --phases 14,17")
            smoke.dryrun_path(card, report)
        seconds[phase] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"phases_{index}.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"tree": str(tree), "card": card, "seconds": seconds}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path, help="checkouts, each holding chip_smoke.py")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated phases of {PHASES} (default: all)")
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                    help="replace a module constant of each tree's chip_smoke.py "
                         "(e.g. PROFILE_TOKENS=16, the steps of phase 15's timed calls)")
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    bad = [p for p in phases if p not in PHASES]
    if bad:
        ap.error(f"unknown phases {bad}; choose from {PHASES}")
    settings = {}
    for item in args.set:
        name, sep, value = item.partition("=")
        if not sep:
            ap.error(f"--set takes NAME=VALUE, got {item!r}")
        settings[name] = ast.literal_eval(value)
    if args.one is not None:
        run_tree(args.trees[0].resolve(), phases, args.one, settings)
        return 0
    failed = []
    for i, tree in enumerate(args.trees):
        rc = subprocess.run([sys.executable, __file__, str(tree), "--phases", args.phases,
                             "--one", str(i)] + [f"--set={s}" for s in args.set]).returncode
        if rc != 0:
            failed.append((str(tree), rc))
    if failed:
        print(f"[FAIL] runs that failed: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
