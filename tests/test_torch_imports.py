"""The port stands alone: importing it loads neither jax nor the reference
package, its sources import neither, and its default-device entry points
refuse to run without a card instead of falling back to the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro(\.|\s))",
                       re.M)


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sharding_modules_stand_alone():
    """The serve mesh's modules load neither jax nor the reference package,
    and importing them starts no process group (a mesh joins one only when
    it is made)."""
    mods = ["repro_torch.sharding", "repro_torch.sharding.serve", "repro_torch.sharding.specs",
            "repro_torch.launch.mesh"]
    code = (
        "import importlib, sys\n"
        "import torch.distributed as dist\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad, dist.is_initialized())\n"
        "sys.exit(1 if bad or dist.is_initialized() else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    for m in mods:
        path = PORT.parent / (m.replace(".", "/") + ".py")
        if not path.exists():
            path = path.with_suffix("") / "__init__.py"
        assert not FORBIDDEN.search(path.read_text()), m


def test_dryrun_modules_stand_alone():
    """The dry-run tools load neither jax nor the reference package, and
    importing them starts no process group and registers no fake backend
    (``make_dry_mesh`` does both, only when it is called)."""
    mods = ["repro_torch.configs.shapes", "repro_torch.models.inputs",
            "repro_torch.launch.cost_analysis", "repro_torch.launch.dryrun"]
    code = (
        "import importlib, sys\n"
        "import torch.distributed as dist\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "fake = 'torch.testing._internal.distributed.fake_pg' in sys.modules\n"
        "print(bad, dist.is_initialized(), fake)\n"
        "sys.exit(1 if bad or dist.is_initialized() or fake else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py", ROOT / "chip_phases.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_repro(path):
    assert not FORBIDDEN.search(path.read_text())


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.training import Trainer

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    model = build_model(get_config("tinyllama-1.1b").reduced())
    params = model.init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, params, max_seq=32, batch_size=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model).init_state(seed=0)
    assert resolve_device("cpu").type == "cpu"


def test_cli_default_device_raises_without_cuda(no_cuda):
    from repro_torch.launch import serve, train, train_smol

    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_smol.main([])


def _run_chip_smoke(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, str(cwd / "chip_smoke.py")], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    res = _run_chip_smoke(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    res = _run_chip_smoke(tmp_path, {"CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
