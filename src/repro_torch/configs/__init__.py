"""Model configurations: the paper's DLRM (``configs.dlrm``) and the LM
registry, ``get_config("<arch-id>")`` / ``get_smoke_config``.

``ARCH_IDS`` is the reference's list of architectures.  The port serves
``PORTED_ARCH_IDS``: the dense family (granite-8b, starcoder2-15b, yi-34b,
nemotron-4-340b), the GQA MoE moonshot-v1-16b-a3b, the MLA MoE
deepseek-v3-671b, the hybrid hymba-1.5b (attention and mamba heads) and
the ssm rwkv6-1.6b; asking for any other raises ``NotImplementedError``
naming its ROADMAP item.
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
# every arch the port's LM path runs: the dense family, the MoE family
# (GQA and MLA attention), the hybrid and the ssm family
PORTED_ARCH_IDS = DENSE_ARCH_IDS + ["moonshot-v1-16b-a3b", "deepseek-v3-671b",
                                    "hymba-1.5b", "rwkv6-1.6b"]
# every arch not yet ported: its family and the ROADMAP Queue 1 item it
# waits for
WAITING = {"whisper-base": ("audio", "13.4"), "internvl2-2b": ("vlm", "13.5")}


def waiting_item(family: str) -> str:
    """The Queue 1 item an unported family waits for ("13" if none)."""
    return next((item for fam, item in WAITING.values() if fam == family),
                "13")


def _module(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
    if name not in PORTED_ARCH_IDS:
        raise NotImplementedError(
            f"{name}: only {', '.join(PORTED_ARCH_IDS)} are ported; the "
            f"{WAITING[name][0]} family waits for ROADMAP Queue 1 item "
            f"{WAITING[name][1]}")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()
