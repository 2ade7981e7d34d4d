"""Architecture config registry: ``--arch <id>`` resolution
(``repro/configs/__init__.py``), holding only the archs the port can run.

Each module defines CONFIG (the architecture at its published widths) and
SMOKE (a reduced same-family config for CPU tests). The other archs of the
reference wait for their model families (``ROADMAP.md``).
"""
from __future__ import annotations

import importlib

from repro_torch.models.arch import ArchConfig

_MODULES = {
    "rwkv6-7b": "rwkv6_7b",
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
