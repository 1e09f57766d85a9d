"""Model assembly (port of ``repro.models.transformer``): init, the
full-sequence forward, prefill and one-token decode.

Parameters and caches keep the reference's tree: ``{"embed",
"groups", "final_norm"}`` with one tuple of stacked sub-block trees per
``BlockGroup`` (leading ``(repeats,)`` axis); the layers run as a Python
loop over that axis.  Caches stack the same way, and ``decode_step``
updates them in place.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..device import resolve_device
from .blocks import (block_apply, block_cache_init, block_decode, block_init,
                     block_prefill)
from .common import ModelConfig, tree_index, tree_map, tree_stack
from .layers import (embed_apply, embed_init, rmsnorm_apply, rmsnorm_init,
                     unembed_apply)

__all__ = ["model_init", "forward", "init_caches", "prefill", "decode_step",
           "param_count"]


def model_init(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters with the reference's shapes and scales, drawn
    from ``generator`` (which must live on ``device``; CUDA unless
    named)."""
    dev = resolve_device(device)
    groups = []
    for bg in cfg.blocks:
        subs = tuple(tree_stack([block_init(kind, cfg, generator, dev)
                                 for _ in range(bg.repeats)])
                     for kind in bg.pattern)
        groups.append(subs)
    return {"embed": embed_init(cfg, generator, dev), "groups": tuple(groups),
            "final_norm": rmsnorm_init(cfg, dev)}


def param_count(params) -> int:
    sizes = []
    tree_map(lambda a: sizes.append(a.numel()), params)
    return sum(sizes)


def _layers(cfg: ModelConfig, params):
    """(group index, sub index, repeat, kind, layer params) in order."""
    for gi, (bg, subs) in enumerate(zip(cfg.blocks, params["groups"])):
        for r in range(bg.repeats):
            for si, kind in enumerate(bg.pattern):
                yield gi, si, r, kind, tree_index(subs[si], r)


def _tokens(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if set(batch) != {"tokens"}:
        raise NotImplementedError(
            "only token inputs are ported (prefix embeddings wait for the "
            "VLM/audio configs, ROADMAP.md A8)")
    return batch["tokens"]


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Full-sequence forward: tokens (B, S) → logits (B, S, vocab)."""
    x = embed_apply(params["embed"], _tokens(batch), cfg)
    for _, _, _, kind, p in _layers(cfg, params):
        x = block_apply(kind, p, x, cfg)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return unembed_apply(params["embed"], x, cfg)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, device=None,
                dtype=None):
    """Empty caches (pos = -1), stacked per group-sub like the params."""
    dev = resolve_device(device)
    return tuple(
        tuple(tree_stack([block_cache_init(kind, cfg, batch, cache_len, dev,
                                           dtype)
                          for _ in range(bg.repeats)])
              for kind in bg.pattern)
        for bg in cfg.blocks)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache_len: int):
    """Full-sequence forward that materializes every block's cache."""
    x = embed_apply(params["embed"], _tokens(batch), cfg)
    per = [[[] for _ in bg.pattern] for bg in cfg.blocks]
    for gi, si, _, kind, p in _layers(cfg, params):
        x, c = block_prefill(kind, p, x, cfg, cache_len)
        per[gi][si].append(c)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    caches = tuple(tuple(tree_stack(cs) for cs in g) for g in per)
    return unembed_apply(params["embed"], x, cfg), caches


def decode_step(params, tokens: torch.Tensor, caches, pos: int,
                cfg: ModelConfig):
    """One autoregressive step: tokens (B, 1) at absolute position ``pos``.
    Returns (logits (B, 1, vocab), caches), the caches updated in place."""
    x = embed_apply(params["embed"], tokens, cfg)
    for gi, si, r, kind, p in _layers(cfg, params):
        x, _ = block_decode(kind, p, x, tree_index(caches[gi][si], r), pos,
                            cfg)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return unembed_apply(params["embed"], x, cfg), caches
