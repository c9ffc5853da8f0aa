"""The port's side of tests/test_torch_xlstm_chunks.py's dry-run check, in
a process of its own (a dry run takes the process's one default process
group, torch's fake one). It imports nothing of the JAX package.

``python tests/torch_xlstm_chunk_worker.py chunks|steps OUT`` writes a
pickle of the dry-run report of reduced xLSTM-125M's train step (batch 4
× 256 positions, four chunks of 64) on a fake 2×2 mesh: ``chunks``
counts one chunk of each scan for all of them, ``steps`` traces every
step.
"""
import pickle
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import run_dryrun
from repro_torch.launch.mesh import make_dry_mesh

SHAPE = InputShape("train_256", 256, 4, "train")


def main(mode: str, out_path: str) -> None:
    torch.set_num_threads(1)
    mesh = make_dry_mesh((2, 2), ("data", "model"), "cpu")
    rep = run_dryrun(get_config("xlstm-125m").reduced(), SHAPE, mesh=mesh, verbose=False,
                     device="cpu", count_chunks=mode == "chunks")
    with open(out_path, "wb") as f:
        pickle.dump(rep, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
