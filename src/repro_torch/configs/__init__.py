"""Architecture registry (port of ``repro.configs``): every config of the
reference — dense attention, MLA, MoE, RG-LRU, Mamba-2, and the
prefix-embedding models ``internvl2-26b`` (a VLM decoder after a patch
prefix) and ``hubert-xlarge`` (an encoder over frame embeddings) — and
the reference's four input shapes, with the inputs of each (arch ×
shape) as meta tensors (no memory) and their partition specs:

  train_4k     → train step      seq 4096,   global batch 256
  prefill_32k  → prefill         seq 32768,  global batch 32
  decode_32k   → decode step     1 new token, 32768-slot caches, batch 128
  long_500k    → decode step     1 new token, 524288-slot caches, batch 1
                 (sub-quadratic mixing only: ``shape_plan``)
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.common import Axes, ModelConfig, PSpec, pspec_map

__all__ = ["ARCH_IDS", "SWEEP_IDS", "get_config", "train_grad_accum",
           "InputShape", "SHAPES", "shape_plan", "input_specs",
           "input_pspecs"]

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
# the reference's ``ARCH_IDS``, in its order: the configs its sweep
# loops over (``gemma2-2b``, the paper's own model, is an extra there)
SWEEP_IDS = ("recurrentgemma-9b", "deepseek-v3-671b", "mamba2-780m",
             "command-r-35b", "qwen3-4b", "codeqwen1.5-7b",
             "command-r-plus-104b", "hubert-xlarge", "internvl2-26b",
             "llama4-scout-17b-a16e")


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


@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}

_SWA_WINDOW = 4096


def shape_plan(cfg: ModelConfig, shape_name: str
               ) -> Tuple[Optional[ModelConfig], str]:
    """(possibly-variant config, note) for running ``shape_name``, or
    (None, reason) when the combination is skipped: an encoder-only
    model has no decode step; ``long_500k`` on a model with full
    attention runs its sliding-window variant (window 4096), noted
    ``variant=swa4096``."""
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        if not cfg.is_decoder:
            return None, "skip: encoder-only (no autoregressive step)"
        if shape_name == "long_500k" and not cfg.supports_long_context:
            return cfg.with_sliding_window(_SWA_WINDOW), "variant=swa4096"
    if shape.kind == "prefill" and not cfg.is_decoder:
        return cfg, "encoder forward (no cache)"
    return cfg, ""


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """Meta tensors for every input of this combination (shapes and
    dtypes, no memory):

    train   → {"batch": {tokens, labels[, prefix_embeds]}}
    prefill → {"batch": {tokens[, prefix_embeds]}}
    decode  → {"tokens", "caches", "pos"}
    """
    from ..models.transformer import init_caches
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {}
        if cfg.prefix_only:
            batch["prefix_embeds"] = meta((b, s, cfg.d_model), cfg.dtype)
        else:
            batch["tokens"] = meta((b, s), torch.int32)
            if cfg.prefix_len > 0:
                batch["prefix_embeds"] = meta((b, cfg.prefix_len,
                                               cfg.d_model), cfg.dtype)
        if shape.kind == "train":
            batch["labels"] = meta((b, s), torch.int32)
        return {"batch": batch}
    # decode: one new token against a seq_len-deep cache
    return {"tokens": meta((b, 1), torch.int32),
            "caches": init_caches(cfg, b, s, device="meta"),
            "pos": meta((), torch.int32)}


def input_pspecs(cfg: ModelConfig, shape_name: str, axes: Axes
                 ) -> Dict[str, Any]:
    """Partition specs of ``input_specs``' leaves: batch on the data
    axes when the global batch divides by 16, else replicated (batch 1
    of ``long_500k``: the caches' batch dim, dim 1 after the layer
    axis, replicated)."""
    from ..models.transformer import cache_pspec
    shape = SHAPES[shape_name]
    dp = axes.data_axes if shape.global_batch % 16 == 0 else None
    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {}
        if cfg.prefix_only:
            batch["prefix_embeds"] = PSpec(dp, None, None)
        else:
            batch["tokens"] = PSpec(dp, None)
            if cfg.prefix_len > 0:
                batch["prefix_embeds"] = PSpec(dp, None, None)
        if shape.kind == "train":
            batch["labels"] = PSpec(dp, None)
        return {"batch": batch}
    cspec = cache_pspec(cfg, axes)
    if not dp:
        cspec = pspec_map(lambda p: PSpec(*(p[:1] + (None,) + p[2:]))
                          if len(p) > 1 else p, cspec)
    return {"tokens": PSpec(dp, None) if dp else PSpec(), "caches": cspec,
            "pos": PSpec()}
