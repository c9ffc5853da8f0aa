"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Each ``csrc/*.cu`` has a plain C interface and is compiled by ``nvcc`` into
its own shared library (one ``nvcc`` process per source, all started
together), then loaded with ``ctypes``. Nothing includes PyTorch's headers,
so a build takes seconds; the chunk-gather body (``chunk_gather.cuh``) is
split over two sources, without and with the checksum lane, so that its
instantiations build in parallel. Libraries land in ``build/kernels`` at the
root of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a
hash of the source, the headers and the flags, so an edited source is
rebuilt and never mistaken for a stale one.

Numerics flags: ``-fmad=false`` keeps every ``a*b+c`` as two IEEE roundings
(the plain PyTorch versions round each product on its own), and there is no
``--use_fast_math``: ``expf`` and the divide stay IEEE.

Nothing here runs at import time; the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("chunk_gather.cu", "chunk_gather_ck.cu", "greedy_select.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: every pointer and the stream as c_void_p, ints as c_int;
# each returns cudaGetLastError() (0 = launched)
SIGNATURES = {
    "chunk_gather.cu": {
        "k1_chunk_gather_matmul": [_P, _I, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "k2_gate_up": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "k3_chunk_gather_matmul": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "k1_smem_bytes": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I],
        "k4_chunk_gather_swiglu": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _P],
    },
    "chunk_gather_ck.cu": {
        "k1_chunk_gather_matmul_ck": [_P, _I, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "k2_gate_up_ck": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "greedy_select.cu": {
        "k5_greedy_select": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # source → nvcc's stderr (ptxas -v report)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py → the checkout root
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use "
                       "and need the CUDA toolkit (set NVCC or CUDA_HOME)")


def _lib_path(src: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha1((CSRC / src).read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{Path(src).stem}-{h.hexdigest()[:12]}.so"


def build_all(sources=SOURCES) -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel.
    Returns {source: library path}; raises with nvcc's output on failure."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    paths = {src: _lib_path(src) for src in sources}
    for src, lib in paths.items():
        if lib.exists():
            continue
        nvcc = nvcc or find_nvcc()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ), tmp)
    for src, (proc, tmp) in procs.items():
        so, se = proc.communicate()
        BUILD_LOG[src] = (so or "") + (se or "")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{BUILD_LOG[src]}")
        os.replace(tmp, paths[src])
    return paths


def library(src: str) -> ctypes.CDLL:
    """The loaded shared library of one source, built on first use."""
    lib = _LIBS.get(src)
    if lib is None:
        path = build_all((src,))[src]
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES[src].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[src] = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


_SM_COUNT: Dict[int, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached per device)."""
    import torch

    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def stream_ptr(device) -> Optional[int]:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
