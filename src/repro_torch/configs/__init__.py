"""Architecture registry of the port: the reference's ten architectures —
the dense decoders (TinyLlama, StarCoder2-3B/7B, Granite-3-2B), the
early-fusion VLM (InternVL2-76B), the mixture-of-experts decoders
(OLMoE-1B-7B, Llama-4-Scout-17B-16E), the hybrid Zamba2-7B, the recurrent
xLSTM-125M and the encoder-decoder Whisper-small.
"""
from typing import Dict, List

from .base import InputShape, ModelConfig
from .granite_3_2b import CONFIG as _granite
from .internvl2_76b import CONFIG as _internvl2
from .llama4_scout_17b_a16e import CONFIG as _scout
from .olmoe_1b_7b import CONFIG as _olmoe
from .starcoder2_3b import CONFIG as _starcoder2_3b
from .starcoder2_7b import CONFIG as _starcoder2_7b
from .tinyllama_1_1b import CONFIG as _tinyllama
from .whisper_small import CONFIG as _whisper
from .xlstm_125m import CONFIG as _xlstm
from .zamba2_7b import CONFIG as _zamba2

CONFIGS: Dict[str, ModelConfig] = {
    c.name: c for c in (_tinyllama, _starcoder2_3b, _starcoder2_7b, _granite, _internvl2,
                        _olmoe, _scout, _zamba2, _xlstm, _whisper)}

ARCH_IDS: List[str] = sorted(CONFIGS)


def get_config(name: str) -> ModelConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}") from None


__all__ = ["ARCH_IDS", "CONFIGS", "InputShape", "ModelConfig", "get_config"]
