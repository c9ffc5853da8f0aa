"""The processes that the port's test modules start beside themselves: a
worker script in a subprocess (``Sub``) and spawned gloo ranks
(``Ranks``). Each writes its output, the C++ side's included, to a log
file of its own, and a failure quotes the tail of every log, so that a
test run's report names the cause. It imports only the port.

A rank that ends its process group first waits for every collective it
issued (``drain``: a barrier on each group), so that none is in flight
when the group goes. Ranks of the real 2×2 step under the dry run's
counter died at their exit, after their work (SIGABRT "terminate called
without an active exception", SIGSEGV, "malloc(): unaligned tcache chunk
detected"): the counter skipped the waits of the step's functional
collectives (169 left unwaited in one reduced TinyLlama FSDP step), so
gloo's threads wrote into outputs the step had freed. It waits them now;
``tools/stress_fixtures.py ranks --no-drain`` reruns that stress without
the barriers.
"""
import os
import socket
import subprocess
import sys
import time

import pytest
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAIL = 3000  # characters of each log a failure quotes
WAIT_S = 600


def _tail(path) -> str:
    try:
        with open(path, errors="replace") as f:
            text = f.read()
    except OSError as e:
        return f"({e})"
    return text[-TAIL:]


def port_env() -> dict:
    """The environment of a worker script: this one, the port's sources on
    ``PYTHONPATH``."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))


class Sub:
    """``python argv...`` started now (``env``: variables added to
    ``port_env()``'s), its output in ``<log_dir>/<name>.log``."""

    def __init__(self, argv, log_dir, name, env=None):
        self.name, self.log = name, os.path.join(str(log_dir), f"{name}.log")
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen([sys.executable, *map(str, argv)],
                                         env={**port_env(), **(env or {})},
                                         stdout=out, stderr=subprocess.STDOUT)

    def wait(self, seconds=WAIT_S):
        """Wait for a clean exit; fail with the log's tail otherwise."""
        try:
            rc = self.proc.wait(timeout=seconds)
        except subprocess.TimeoutExpired:
            self.stop()
            pytest.fail(f"{self.name} did not finish within {seconds} s; its log ends:\n"
                        f"{_tail(self.log)}")
        if rc != 0:
            pytest.fail(f"{self.name} exited with {rc}; its log ends:\n{_tail(self.log)}")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def free_port() -> int:
    """A TCP port of this host's loopback that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_ranks(module, args, world, log_dir, name):
    """``python -m module args...`` in ``world`` processes with the
    environment torchrun gives its ranks (``RANK``, ``LOCAL_RANK``,
    ``WORLD_SIZE``, a loopback ``MASTER_ADDR`` and free ``MASTER_PORT``; one
    intra-op thread), started now: a ``Sub`` a rank, rank r's output in
    ``<log_dir>/<name>-rank<r>.log``."""
    env = {"WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port()), "OMP_NUM_THREADS": "1"}
    return [Sub(["-m", module, *args], log_dir, f"{name}-rank{r}",
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}) for r in range(world)]


def _logged(rank, fn, log_dir, name, args):
    """``fn(rank, *args)`` with this process's stdout and stderr (file
    descriptors 1 and 2) in the rank's log file."""
    fd = os.open(os.path.join(log_dir, f"{name}-rank{rank}.log"),
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    fn(rank, *args)


class Ranks:
    """``fn(rank, *args)`` in ``world`` spawned processes, started now,
    rank r's output in ``<log_dir>/<name>-rank<r>.log``."""

    def __init__(self, fn, args, world, log_dir, name):
        self.name, self.log_dir = name, str(log_dir)
        self.logs = [os.path.join(self.log_dir, f"{name}-rank{r}.log") for r in range(world)]
        self.ctx = mp.start_processes(_logged, args=(fn, self.log_dir, name, tuple(args)),
                                      nprocs=world, join=False, start_method="spawn")

    def _fail(self, what):
        self.stop()
        logs = "\n".join(f"--- rank {r} ---\n{_tail(p)}" for r, p in enumerate(self.logs))
        pytest.fail(f"{self.name}: {what}; the ranks' logs end:\n{logs}")

    def wait(self, seconds=WAIT_S):
        """Wait for every rank to exit cleanly; fail with each rank's log
        tail otherwise (a rank's exception, its signal, or the time)."""
        deadline = time.monotonic() + seconds
        try:
            while not self.ctx.join(timeout=2):
                if time.monotonic() > deadline:
                    self._fail(f"the ranks did not finish within {seconds} s")
        except ProcessException as e:
            self._fail(str(e)[-TAIL:] or repr(e))

    def stop(self):
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def drain():
    """Wait for every collective this rank issued on every group it is in
    (``repro_torch.launch.mesh.drain_process_groups``: one barrier a group,
    in the order the groups were made). Call it before
    ``dist.destroy_process_group()`` on the way out of a rank that finished
    its work (the module doc)."""
    from repro_torch.launch.mesh import drain_process_groups

    drain_process_groups()
