#!/usr/bin/env python3
"""Stress the tests' spawned gloo ranks and their module fixtures on the CPU.

    PYTHONPATH=src python3 tools/stress_fixtures.py ranks --sets 3 --runs 6 [--no-drain]
    PYTHONPATH=src python3 tools/stress_fixtures.py modules --copies 4 \\
        tests/test_torch_dryrun.py
    PYTHONPATH=src python3 tools/stress_fixtures.py cli --sets 3 --runs 6

``ranks``: ``--sets`` sets of the four ranks of
``tests/torch_dryrun_worker.real_2x2`` (reduced TinyLlama's FSDP train step
on a 2×2 gloo mesh) at once, each set ``--runs`` times in a row; prints each
run's outcome and how many ranks died (by exception, by signal, or at exit
after their work). ``--no-drain`` leaves out the barriers a rank passes
before it destroys its process group (``tests/torch_procs.drain``), the
way the ranks left before the repair.

``cli``: ``--sets`` sets of the four ranks of the train CLI run as
torchrun starts them (``tests/test_torch_mesh_cli.py``'s case: reduced
TinyLlama's one step on ``--mesh 2,2``) at once, each set ``--runs`` times
in a row; prints each run's outcome and every rank's exit code (the CLI
drains and destroys the group it joined).

``modules``: ``--copies`` concurrent pytest runs of the given test modules
(one process each, this interpreter, ``-p no:cacheprovider``); prints each
copy's summary line and exits 1 if any copy failed or errored.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")


def ranks_set(runs: int, drain: bool, scratch: str) -> int:
    """One set: ``runs`` spawns of the four ranks in a row; the number that
    failed."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    sys.path.insert(0, TESTS)
    import torch_dryrun_worker as worker

    bad = 0
    for i in range(runs):
        tmp = tempfile.mkdtemp(dir=scratch)
        t0 = time.monotonic()
        ctx = mp.start_processes(worker.real_2x2, args=(4, os.path.join(tmp, "store"), tmp, drain),
                                 nprocs=4, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=2):
                pass
            print(f"run {i}: ok in {time.monotonic() - t0:.1f} s", flush=True)
        except ProcessException as e:
            bad += 1
            codes = [p.exitcode for p in ctx.processes]
            print(f"run {i}: FAILED ({str(e).strip().splitlines()[-1]}; exit codes {codes}; "
                  f"rank 0's result written: {os.path.exists(os.path.join(tmp, 'real2x2.pkl'))})",
                  flush=True)
    return bad


def cli_set(runs: int, scratch: str) -> int:
    """One set: ``runs`` runs of the train CLI's four ranks in a row; the
    number of runs in which a rank did not exit 0."""
    sys.path.insert(0, TESTS)
    import torch_procs as procs
    from test_torch_mesh_cli import CLIS, WAIT_S, WORLD

    module, cli_args = CLIS["train"]
    bad = 0
    for i in range(runs):
        tmp = tempfile.mkdtemp(dir=scratch)
        t0 = time.monotonic()
        ranks = procs.cli_ranks(module, cli_args, WORLD, tmp, "train")
        codes = []
        for rank in ranks:
            try:
                codes.append(rank.proc.wait(timeout=WAIT_S))
            except subprocess.TimeoutExpired:
                rank.stop()
                codes.append("timeout")
        if any(code != 0 for code in codes):
            bad += 1
            print(f"run {i}: FAILED (exit codes {codes}; logs in {tmp})", flush=True)
        else:
            print(f"run {i}: ok in {time.monotonic() - t0:.1f} s", flush=True)
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    r = sub.add_parser("ranks")
    r.add_argument("--sets", type=int, default=3)
    r.add_argument("--runs", type=int, default=6)
    r.add_argument("--no-drain", action="store_true")
    r.add_argument("--set", type=int, help=argparse.SUPPRESS)  # one set, in a child
    r.add_argument("--scratch", help=argparse.SUPPRESS)
    c = sub.add_parser("cli")
    c.add_argument("--sets", type=int, default=3)
    c.add_argument("--runs", type=int, default=6)
    c.add_argument("--set", type=int, help=argparse.SUPPRESS)  # one set, in a child
    c.add_argument("--scratch", help=argparse.SUPPRESS)
    m = sub.add_parser("modules")
    m.add_argument("--copies", type=int, default=4)
    m.add_argument("paths", nargs="+")
    args = ap.parse_args()

    if args.mode == "ranks" and args.set is not None:
        return min(ranks_set(args.runs, not args.no_drain, args.scratch), 100)
    if args.mode == "cli" and args.set is not None:
        return min(cli_set(args.runs, args.scratch), 100)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as scratch:
        if args.mode == "ranks":
            cmds = [[sys.executable, __file__, "ranks", "--set", str(k), "--runs", str(args.runs),
                     "--scratch", scratch] + (["--no-drain"] if args.no_drain else [])
                    for k in range(args.sets)]
        elif args.mode == "cli":
            cmds = [[sys.executable, __file__, "cli", "--set", str(k), "--runs", str(args.runs),
                     "--scratch", scratch] for k in range(args.sets)]
        else:
            cmds = [[sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                     "--basetemp", os.path.join(scratch, f"copy{k}"), *args.paths]
                    for k in range(args.copies)]
        procs = [subprocess.Popen(c, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for c in cmds]
        outs = [p.communicate()[0] for p in procs]
    failed = 0
    for k, (p, out) in enumerate(zip(procs, outs)):
        if args.mode in ("ranks", "cli"):
            lines = [ln for ln in out.splitlines() if ln.startswith("run ")]
            failed += p.returncode
        else:
            lines = out.strip().splitlines()[-1:]
            failed += p.returncode != 0
        for ln in lines:
            print(f"[{k}] {ln}")
    runs = args.mode in ("ranks", "cli")
    total = args.sets * args.runs if runs else args.copies
    print(f"{failed} of {total} {'runs' if runs else 'copies'} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
