"""The port's training CLIs: ``python -m repro_torch.launch.train`` prints
the reference CLI's log line (beside the reference's own run with the same
flags: the same steps and learning rates), refuses ``--mesh`` (not ported
yet) and writes a checkpoint that loads; ``launch.train_smol`` trains its
``smol-10m`` config on the CPU."""
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest

from repro.launch import train as j_train
from repro_torch.launch import train, train_smol
from repro_torch.models import build_model
from repro_torch.training import load_checkpoint

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "tinyllama-1.1b", "--reduced", "--steps", "2", "--batch", "2", "--seq", "32",
        "--log-every", "1"]
# the reference's line: f"step {i:5d} loss {:.4f} ce {:.4f} gnorm {:.2f} lr {:.2e} {:.2f}s/step"
LINE = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) ce (\d+\.\d{4}) gnorm (\d+\.\d{2}) "
                  r"lr (\d\.\d{2}e[-+]\d{2}) \d+\.\d{2}s/step$")


def _lines(text):
    return [m.groups() for m in map(LINE.match, text.splitlines()) if m]


def test_train_cli_prints_the_reference_line(monkeypatch, capsys, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *ARGS,
                          "--torch-device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    got = _lines(res.stdout)
    assert [g[0] for g in got] == ["0", "1"], res.stdout
    assert f"saved checkpoint to {tmp_path / 'ckpt'}" in res.stdout

    monkeypatch.setattr(sys, "argv", ["train", *ARGS])
    j_train.main()
    want = _lines(capsys.readouterr().out)
    assert [w[0] for w in want] == ["0", "1"]
    # the weights come from each package's own seeded init, so only the
    # schedule is equal; the losses start near ln(vocab) in both
    for g, w in zip(got, want):
        assert g[4] == w[4]
        for loss in (float(g[1]), float(w[1])):
            assert abs(loss - math.log(512)) < 0.5

    cfg = train.get_config("tinyllama-1.1b").reduced()
    like = build_model(cfg).init(seed=1, device="cpu")
    _, step = load_checkpoint(str(tmp_path / "ckpt"), like)
    assert step == 2


def test_train_cli_refuses_mesh(capsys):
    with pytest.raises(SystemExit) as err:
        train.parse_args(["--reduced", "--mesh", "2,2"])
    assert err.value.code == 2
    msg = capsys.readouterr().err
    assert "--mesh is not ported" in msg and "ROADMAP.md, queue 1, item 4" in msg
    with pytest.raises(SystemExit):
        train.parse_args(["--reduced", "--no-such-flag"])


def test_train_smol_cpu(capsys):
    losses = train_smol.main(["--steps", "3", "--torch-device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("model smol-10m: ")
    assert len(losses) == 2 and all(x == x and x < 10 for x in losses)
    cfg, batch, seq = train_smol.smol_config(full=True)
    assert (cfg.name, cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size, batch, seq) == (
        "smol-100m", 12, 768, 2048, 32000, 16, 512)
