"""Architecture registry (port of ``repro.configs``): every config of the
reference — dense attention, MLA, MoE, RG-LRU, Mamba-2, and the
prefix-embedding models ``internvl2-26b`` (a VLM decoder after a patch
prefix) and ``hubert-xlarge`` (an encoder over frame embeddings)."""
from __future__ import annotations

import importlib

from ..models.common import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "train_grad_accum"]

_MODULES = {
    "gemma2-2b": "gemma2_2b",
    "qwen3-4b": "qwen3_4b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "command-r-35b": "command_r_35b",
    "command-r-plus-104b": "command_r_plus_104b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-780m": "mamba2_780m",
    "internvl2-26b": "internvl2_26b",
    "hubert-xlarge": "hubert_xlarge",
}
ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def train_grad_accum(arch_id: str) -> int:
    """Microbatches a training step of ``arch_id`` splits its batch into
    (the config module's ``TRAIN_GRAD_ACCUM``, default 1)."""
    return getattr(_module(arch_id), "TRAIN_GRAD_ACCUM", 1)
