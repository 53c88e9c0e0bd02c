"""Model configurations: the paper's DLRM (``configs.dlrm``) and the LM
registry, ``get_config("<arch-id>")`` / ``get_smoke_config``.

``ARCH_IDS`` is the reference's list of architectures.  The port serves
the dense family (granite-8b, starcoder2-15b, yi-34b, nemotron-4-340b);
asking for any other raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import MLAConfig, ModelConfig  # noqa: F401

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

# the dense family: what the port's LM path runs
DENSE_ARCH_IDS = ["starcoder2-15b", "yi-34b", "granite-8b", "nemotron-4-340b"]


def _module(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
    if name not in DENSE_ARCH_IDS:
        raise NotImplementedError(
            f"{name}: only the dense family ({', '.join(DENSE_ARCH_IDS)}) "
            f"is ported; MoE, MLA, hybrid, ssm, audio and vlm wait in "
            f"ROADMAP Queue 1 item 13")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()
