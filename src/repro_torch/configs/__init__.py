"""Architecture config registry: ``--arch <id>`` resolution
(``repro/configs/__init__.py``): the dense, vlm and mixture-of-experts
transformers, whisper (the audio family), RWKV-6 and Griffin, the
reference's ten archs.

Each module defines CONFIG (the architecture at its published widths) and
SMOKE (a reduced same-family config for CPU tests), each equal to the
reference's field by field, in the reference's order.
"""
from __future__ import annotations

import importlib

from repro_torch.models.arch import ArchConfig

_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "granite-34b": "granite_34b",
    "llama3-405b": "llama3_405b",
    "minicpm-2b": "minicpm_2b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "whisper-large-v3": "whisper_large_v3",
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_NAMES = tuple(_MODULES)


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port runs {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _load(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _load(name).SMOKE


def all_configs() -> dict[str, ArchConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}
