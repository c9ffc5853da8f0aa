#!/usr/bin/env python3
"""Compare the machine code (SASS) of two builds of a kernel source.

    git show <rev>:src/repro_torch/kernels/csrc/chunk_gather.cu > build/old_chunk_gather.cu
    python3 tools/compare_sass.py build/old_chunk_gather.cu \\
        src/repro_torch/kernels/csrc/chunk_gather.cu

Builds both with the port's nvcc flags (``kernels/build.py``; the CUDA
toolkit is needed, so run it on the machine with the card) and compares
every kernel the two share, by name and template arguments: their SASS,
instruction by instruction, with the constant-bank offsets of kernel
parameters masked (an added parameter shifts the later ones) and a trailing
``false`` template flag dropped from the names (a kernel built with a flag
off). Exits 1 if a kernel of the old build is missing or differs.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def build(src: str, out: str) -> None:
    from repro_torch.kernels import build as kb

    res = subprocess.run([kb.find_nvcc(), *kb.NVCC_FLAGS, "-o", out, src], capture_output=True,
                         text=True)
    if res.returncode:
        sys.exit(f"nvcc failed on {src}:\n{res.stderr[-4000:]}")


def kernels(lib: str, cuda_bin: str) -> dict:
    """{kernel name with its template arguments: [instructions]}."""
    sass = subprocess.run([f"{cuda_bin}/cuobjdump", "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    found, name, body = {}, None, []
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            if name:
                found[name] = body
            name, body = m.group(1), []
        elif name and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0]).strip()
            ins = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]", ins)
            if ins:
                body.append(ins)
    if name:
        found[name] = body
    names = subprocess.run([f"{cuda_bin}/cu++filt"], input="\n".join(found),
                           capture_output=True, text=True, check=True).stdout.splitlines()
    return {re.sub(r", (?:false|\(bool\)0)>", ">", d.split(">(")[0] + ">"): found[m]
            for m, d in zip(found, names)}


def main(old: str, new: str) -> int:
    from repro_torch.kernels import build as kb

    out = ROOT / "build" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    libs = [str(out / "old.so"), str(out / "new.so")]
    for src, lib in zip((old, new), libs):
        build(src, lib)
    cuda_bin = os.path.dirname(kb.find_nvcc())
    a, b = (kernels(lib, cuda_bin) for lib in libs)
    bad = [k for k in sorted(a) if b.get(k) != a[k]]
    for k in bad:
        print(("DIFFERS: " if k in b else "MISSING: ") + k)
    print(f"{len(a) - len(bad)} of {len(a)} kernels of the old build have identical SASS in the "
          f"new one ({len(b)} kernels)")
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
