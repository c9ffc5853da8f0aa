"""The mesh CLIs as torchrun starts them: ``python -m
repro_torch.launch.train --mesh 2,2`` (reduced TinyLlama, one step) and
``python -m repro_torch.launch.serve --mesh 2,2`` (reduced InternVL2, two
tokens) in four processes with torchrun's environment (``RANK``,
``WORLD_SIZE``, a loopback ``MASTER_ADDR``/``MASTER_PORT``), each joining
the gloo group from it. Every rank must exit 0: the CLI drains the group it
joined and destroys it (``launch.mesh.leave_process_group``); ranks that
destroyed a group with a collective in flight died at exit under load
(``tests/torch_procs.py``). Rank 0 alone prints the training line; every
serving rank prints the ``[mesh]`` line."""
import pytest

import torch_procs as procs
from torch_threads import one_thread  # noqa: F401

WORLD = 4
CLIS = {
    "train": ("repro_torch.launch.train",
              ["--arch", "tinyllama-1.1b", "--reduced", "--mesh", "2,2", "--torch-device", "cpu",
               "--steps", "1", "--batch", "2", "--seq", "32", "--log-every", "1"]),
    "serve": ("repro_torch.launch.serve",
              ["--arch", "internvl2-76b", "--reduced", "--mesh", "2,2", "--torch-device", "cpu",
               "--batch", "2", "--decode-tokens", "2", "--max-seq", "32", "--prompt-len", "8",
               "--frames", "1"]),
}
WAIT_S = 300


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_mesh_cli_ranks_exit_cleanly(tmp_path, cli):
    module, args = CLIS[cli]
    ranks = procs.cli_ranks(module, args, WORLD, tmp_path, cli)
    try:
        for rank in ranks:
            rank.wait(WAIT_S)  # fails with the rank's log unless it exits 0
    finally:
        for rank in ranks:
            rank.stop()
    logs = [open(rank.log).read() for rank in ranks]
    if cli == "train":
        assert "step     0 loss" in logs[0]
        assert all("step " not in text for text in logs[1:])
    else:
        assert all("[mesh] data=2 model=2" in text for text in logs)
