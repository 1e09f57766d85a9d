"""Architecture registry (port of ``repro.configs``): ``gemma2-2b`` so
far; the reference's other architectures need block kinds that are not
ported yet (ROADMAP.md A8)."""
from __future__ import annotations

import importlib

from ..models.common import ModelConfig

__all__ = ["get_config"]

_MODULES = {"gemma2-2b": "gemma2_2b"}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown or unported arch {arch_id!r}; "
                       f"ported: {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch_id]}",
                                   __package__).CONFIG
