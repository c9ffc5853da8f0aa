#!/usr/bin/env python3
"""Compare the single-stream decode of two trees of the port: tokens and
launch counts at ``chip_smoke.py``'s phase 4 and phase 7 settings.

    git archive <rev> | tar -x -C build/old
    python3 tools/single_stream_tokens.py build/old/src src

Each tree runs in a process of its own (both packages are ``repro_torch``)
on the card: full-width tinyllama-1.1b (22 layers, batch 2, prompt 32, 16
decode tokens, chunk at sparsity 0.4, kernel backend, wbits 16 and 8) and
internvl2-76b at 8 layers (prefill of 16 vision + 16 text tokens, 4 frames,
16 decode tokens, wbits 16), weights and inputs from seed 0. Prints each
run's tokens and launches as one JSON line per tree, then whether they
agree; exits 1 if they do not.
"""
import json
import subprocess
import sys

RUN = r'''
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import chunking
from repro_torch.kernels import chunk_gather_dma as cg
from repro_torch.models import build_model
from repro_torch.models.inputs import FRONT_DTYPE, make_dummy_batch
from repro_torch.serving import ServeEngine

dev = torch.device("cuda")
out = {}

def launches():
    return {**cg.LAUNCHES, **chunking.LAUNCHES}

def zero():
    for c in (cg.LAUNCHES, chunking.LAUNCHES):
        for k in c:
            c[k] = 0

cfg = get_config("tinyllama-1.1b")
model = build_model(cfg)
params = model.init(seed=0, device=dev)
batch = make_dummy_batch(cfg, InputShape("smoke", 32, 2, "train"), seed=0, device=dev)
for wbits in (16, 8):
    eng = ServeEngine(model, params, max_seq=64, batch_size=2, method="chunk",
                      backend="kernel", wbits=wbits, torch_device=dev)
    tok = torch.argmax(eng.prefill(batch), dim=-1)[:, None]
    zero()
    out[f"tinyllama w{wbits}"] = [eng.decode(tok, 16).tolist(), launches()]
del model, params, eng
torch.cuda.empty_cache()
cfg = dataclasses.replace(get_config("internvl2-76b"), n_layers=8)
model = build_model(cfg)
params = model.init(seed=0, device=dev)
batch = make_dummy_batch(cfg, InputShape("vlm", 32, 2, "train"), seed=0, device=dev)
rng = np.random.default_rng(0)
n_tok = max(cfg.frontend_tokens // 4, 4)
frames = [torch.from_numpy(rng.normal(0, 1, (2, n_tok, cfg.d_frontend))).to(FRONT_DTYPE).to(dev)
          for _ in range(4)]
eng = ServeEngine(model, params, max_seq=512, batch_size=2, method="chunk", backend="kernel",
                  wbits=16, torch_device=dev)
zero()
last = eng.prefill(batch)
for frame in frames:
    eng.append_frame(frame)
out["internvl2 w16"] = [eng.decode(torch.argmax(last, dim=-1)[:, None], 16).tolist(), launches()]
print(json.dumps(out))
'''


def main(old_src: str, new_src: str) -> int:
    runs = []
    for src in (old_src, new_src):
        res = subprocess.run([sys.executable, "-c", RUN, src], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line)
        runs.append(json.loads(line))
    for key in runs[0]:
        (t0, l0), (t1, l1) = runs[0][key], runs[1].get(key, (None, None))
        print(f"{key}: tokens {'equal' if t0 == t1 else 'DIFFER'}, launches {l0} / {l1}")
    return 0 if runs[0] == runs[1] else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
