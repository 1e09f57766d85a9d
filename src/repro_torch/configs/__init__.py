"""Architecture registry (port of ``repro.configs``): ``gemma2-2b`` so
far; the reference's other architectures need block kinds that are not
ported yet (ROADMAP.md A8)."""
from __future__ import annotations

import importlib

from ..models.common import ModelConfig

__all__ = ["get_config", "train_grad_accum"]

_MODULES = {"gemma2-2b": "gemma2_2b"}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown or unported arch {arch_id!r}; "
                       f"ported: {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def train_grad_accum(arch_id: str) -> int:
    """Microbatches a training step of ``arch_id`` splits its batch into
    (the config module's ``TRAIN_GRAD_ACCUM``, default 1)."""
    return getattr(_module(arch_id), "TRAIN_GRAD_ACCUM", 1)
