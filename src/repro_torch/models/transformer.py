"""Model assembly (port of ``repro.models.transformer``): init, the
full-sequence forward (with autograd and per-block remat for training:
``forward_train``), prefill and one-token decode.

Parameters and caches keep the reference's tree: ``{"embed",
"groups", "final_norm"}`` with one tuple of stacked sub-block trees per
``BlockGroup`` (leading ``(repeats,)`` axis); the layers run as a Python
loop over that axis.  Caches stack the same way, and ``decode_step``
updates them in place.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .blocks import (block_apply, block_cache_init, block_decode, block_init,
                     block_prefill)
from .common import (ModelConfig, tree_index, tree_leaves, tree_map,
                     tree_stack, tree_unflatten)
from .layers import (embed_apply, embed_init, rmsnorm_apply, rmsnorm_init,
                     unembed_apply)

__all__ = ["model_init", "forward", "forward_train", "init_caches",
           "prefill", "decode_step", "param_count"]


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


def forward_train(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  *, with_stats: bool = False):
    """Full-sequence forward for training: tokens (B, S) → (logits
    (B, S, vocab), aux), differentiable by autograd.  Other batch keys
    (``labels``, ``loss_mask``) are the loss's.

    Each layer's parameters are ``unbind`` views of its group's stacked
    leaves, so the backward writes each stacked gradient once (one
    ``stack``), not once a layer.  ``cfg.remat`` "block" (and
    "save_mixer_ffn", the same here: a block holds no collective)
    recomputes each block in the backward
    (``torch.utils.checkpoint``).  ``aux`` (the MoE balance loss) and
    ``with_stats``' ``moe_wire_coded_bits`` are float32 zeros on the
    dense blocks.
    """
    if "prefix_embeds" in batch:
        raise NotImplementedError(
            "prefix embeddings are not ported yet (the VLM/audio configs, "
            "ROADMAP.md A8)")
    if cfg.remat not in ("none", "block", "save_mixer_ffn"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    x = embed_apply(params["embed"], batch["tokens"], cfg)
    for bg, subs in zip(cfg.blocks, params["groups"]):
        layers = [[a.unbind(0) for a in tree_leaves(sub)] for sub in subs]
        for r in range(bg.repeats):
            for si, kind in enumerate(bg.pattern):
                p = tree_unflatten(subs[si], [u[r] for u in layers[si]])
                if cfg.remat == "none":
                    x = block_apply(kind, p, x, cfg)
                else:
                    x = checkpoint(block_apply, kind, p, x, cfg,
                                   use_reentrant=False)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = unembed_apply(params["embed"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    if with_stats:
        return logits, aux, {"moe_wire_coded_bits": torch.zeros_like(aux)}
    return logits, aux


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
