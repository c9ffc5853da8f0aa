"""Architecture registry of the port: only the archs it serves.

The reference registers ten architectures; the port adds each one with the
slice that serves it (ROADMAP.md, queue 1). Asking for any other arch
raises with that pointer.
"""
from typing import Dict, List

from .base import InputShape, ModelConfig
from .internvl2_76b import CONFIG as _internvl2
from .tinyllama_1_1b import CONFIG as _tinyllama

CONFIGS: Dict[str, ModelConfig] = {c.name: c for c in (_tinyllama, _internvl2)}

ARCH_IDS: List[str] = sorted(CONFIGS)


def get_config(name: str) -> ModelConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(
            f"arch {name!r} is not served by repro_torch yet (have {ARCH_IDS}); "
            "the remaining families land in later slices — see ROADMAP.md, "
            "queue 1"
        ) from None


__all__ = ["ARCH_IDS", "CONFIGS", "InputShape", "ModelConfig", "get_config"]
