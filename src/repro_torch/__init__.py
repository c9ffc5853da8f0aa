"""repro_torch: the PyTorch / CUDA (H100) port of ``repro``.

Same layout and names as ``repro`` so every module's counterpart is easy
to find; inside, PyTorch idiom (plain functions on tensors, explicit
``device``, seeded ``torch.Generator``s). This package imports neither
``jax`` nor anything of ``repro``.

The first slice serves a dense decoder LM's offloaded sparse decode
(``serving.ServeEngine``) through hand-written CUDA chunk-gather kernels
(``kernels/csrc``). Entry points run on ``cuda`` unless the caller passes a
CPU device.
"""
import torch

# fp32 products stay fp32 on the card: TF32 would change the bits the
# kernels are compared against (the bitwise kernel == twin invariant)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. There is no silent fallback to the CPU — a missing
    card raises here."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (CLI: --torch-device cpu) to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev
