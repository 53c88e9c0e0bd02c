"""Model configurations: the paper's DLRM (``configs.dlrm``) and the LM
registry, ``get_config("<arch-id>")`` / ``get_smoke_config``.

``ARCH_IDS`` is the reference's list of architectures, and the port
serves every one of them (``PORTED_ARCH_IDS``): the dense family
(granite-8b, starcoder2-15b, yi-34b, nemotron-4-340b), the GQA MoE
moonshot-v1-16b-a3b, the MLA MoE deepseek-v3-671b, the hybrid hymba-1.5b
(attention and mamba heads), the ssm rwkv6-1.6b, the audio whisper-base
(encoder-decoder) and the vlm internvl2-2b (patch prefix); any other
name raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    MLAConfig,
    ModelConfig,
    TrainConfig,
)

ARCH_IDS = [
    "moonshot-v1-16b-a3b",
    "deepseek-v3-671b",
    "hymba-1.5b",
    "starcoder2-15b",
    "yi-34b",
    "granite-8b",
    "nemotron-4-340b",
    "whisper-base",
    "internvl2-2b",
    "rwkv6-1.6b",
]

# the dense family: what the port's LM path first ran
DENSE_ARCH_IDS = ["starcoder2-15b", "yi-34b", "granite-8b", "nemotron-4-340b"]
# every arch the port's LM path runs: the dense family, the MoE family
# (GQA and MLA attention), the hybrid, ssm, audio and vlm families
PORTED_ARCH_IDS = DENSE_ARCH_IDS + ["moonshot-v1-16b-a3b", "deepseek-v3-671b",
                                    "hymba-1.5b", "rwkv6-1.6b",
                                    "whisper-base", "internvl2-2b"]


def _module(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()
