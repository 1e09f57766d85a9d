"""Model assembly (port of ``repro.models.transformer``): init, the
full-sequence forward (with autograd and per-block remat for training:
``forward_train``), prefill and one-token decode.

Parameters and caches keep the reference's tree: ``{"embed",
"groups", "final_norm"}`` with one tuple of stacked sub-block trees per
``BlockGroup`` (leading ``(repeats,)`` axis); the layers run as a Python
loop over that axis.  Caches stack the same way (an MoE block's with
its routing counts; a recurrent block's fixed-size state and conv tail,
with no positions), and ``decode_step`` updates them in place.

Inputs are the reference's batch keys: ``tokens`` (B, S) and/or
``prefix_embeds`` (B, P, d), precomputed patch or frame embeddings (the
vision tower and the audio front end are not models here).  The input
sequence is [prefix] + [tokens]; with both keys, the logits cover the
token positions only.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .blocks import (block_apply, block_cache_init, block_cache_pspec,
                     block_decode, block_init, block_prefill, block_pspec)
from .common import (Axes, ModelConfig, PSpec, pspec_map, tree_index,
                     tree_leaves, tree_map, tree_stack, tree_unflatten)
from .layers import (decode_pos, embed_apply, embed_init, embed_pspec,
                     rmsnorm_apply, rmsnorm_init, rmsnorm_pspec,
                     unembed_apply)
from .moe import current_mesh

__all__ = ["model_init", "model_pspec", "fsdp_pspec", "forward",
           "forward_train", "init_caches", "cache_pspec", "prefill",
           "decode_step", "param_count"]


def model_init(cfg: ModelConfig, generator: Optional[torch.Generator],
               device=None):
    """Random parameters with the reference's shapes and scales, drawn
    from ``generator`` (which must live on ``device``; CUDA unless
    named).  On ``device="meta"`` nothing is drawn or allocated (the
    shapes alone, for the sharding plan and the roofline), and
    ``generator`` may be None there only."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        raise ValueError("model_init draws its parameters from a generator;"
                         " only device='meta' takes generator=None")
    groups = []
    for bg in cfg.blocks:
        subs = tuple(_stacked_init(kind, bg.repeats, cfg, generator, dev)
                     for kind in bg.pattern)
        groups.append(subs)
    return {"embed": embed_init(cfg, generator, dev), "groups": tuple(groups),
            "final_norm": rmsnorm_init(cfg, dev)}


def _stacked_init(kind: str, repeats: int, cfg: ModelConfig, generator,
                  device):
    """``repeats`` blocks of ``kind`` drawn in order, each written into a
    stack allocated at the first draw: the peak is the stack and one
    block, where stacking a list of blocks would hold the stack twice
    (internvl2-26b's three FFN stacks are 9.66 GB each).  On the meta
    device the stack is the first block's shapes, with nothing drawn."""
    first = block_init(kind, cfg, generator, device)
    if repeats == 1:
        return tree_stack([first])
    stack = tree_map(lambda a: a.new_empty((repeats,) + tuple(a.shape)),
                     first)
    if device.type == "meta":
        return stack
    for r in range(repeats):
        block = first if r == 0 else block_init(kind, cfg, generator, device)
        for dst, src in zip(tree_leaves(stack), tree_leaves(block)):
            dst[r].copy_(src)
        del block
    return stack


def _prepend_axis(tree):
    return pspec_map(lambda s: PSpec(None, *s), tree)


def model_pspec(cfg: ModelConfig, axes: Optional[Axes] = None):
    """Partition specs of ``model_init``'s tree: Megatron tensor
    parallelism on the model axis (the reference's ``model_pspec``);
    each stacked leaf's layer axis is replicated."""
    axes = axes or Axes()
    return {"embed": embed_pspec(cfg, axes),
            "groups": tuple(tuple(_prepend_axis(block_pspec(k, cfg, axes))
                                  for k in bg.pattern) for bg in cfg.blocks),
            "final_norm": rmsnorm_pspec(cfg, axes)}


def fsdp_pspec(cfg: ModelConfig, axes: Optional[Axes] = None,
               data_degree: int = 16):
    """Fully sharded (ZeRO-3) specs (the reference's ``fsdp_pspec``): on
    top of ``model_pspec``, each leaf's first dim that is unsharded,
    divisible by ``data_degree`` and at least ``data_degree`` goes on
    the data axes.  The shapes come from the model built on the meta
    device."""
    axes = axes or Axes()
    shapes = model_init(cfg, None, device="meta")
    data_axes = axes.extra_data + (axes.data,)
    tag = data_axes if len(data_axes) > 1 else data_axes[0]

    def shard_leaf(spec, leaf):
        parts = list(spec) + [None] * (leaf.dim() - len(spec))
        for i, (p, d) in enumerate(zip(parts, leaf.shape)):
            if p is None and d % data_degree == 0 and d >= data_degree:
                parts[i] = tag
                break
        return PSpec(*parts)

    return pspec_map(shard_leaf, model_pspec(cfg, axes), shapes)


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


def _embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """The input sequence (reference ``_embed_inputs``): [prefix
    embeddings] + [token embeddings], times sqrt(d)."""
    return embed_apply(params["embed"], batch.get("tokens"), cfg,
                       batch.get("prefix_embeds"))


def _logits(params, x, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Final norm and unembed, over the token positions only when the
    batch has both a prefix and tokens."""
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if "prefix_embeds" in batch and "tokens" in batch:
        x = x[:, batch["prefix_embeds"].shape[1]:]
    return unembed_apply(params["embed"], x, cfg)


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Full-sequence forward: the batch's inputs → logits (B, S, vocab),
    S the token positions (every position of a prefix-only batch)."""
    x = _embed_inputs(params, batch, cfg)
    mesh = current_mesh()
    for _, _, _, kind, p in _layers(cfg, params):
        x, _, _ = block_apply(kind, p, x, cfg, mesh)
    return _logits(params, x, batch, cfg)


def forward_train(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  *, with_stats: bool = False):
    """Full-sequence forward for training: the batch's inputs → (logits
    (B, S, vocab) over the token positions, aux), differentiable by
    autograd.  Other batch keys (``labels``, ``loss_mask``) are the
    loss's.

    Each layer's parameters are ``unbind`` views of its group's stacked
    leaves, so the backward writes each stacked gradient once (one
    ``stack``), not once a layer.  ``cfg.remat`` "block" (and
    "save_mixer_ffn", the same here: a block's only collectives, the a2a
    MoE wire and the eshard MoE's loopback psum, are exact and in a
    fixed order, so their re-run gives the same values)
    recomputes each block in the backward
    (``torch.utils.checkpoint``).  ``aux`` is the layers' summed MoE
    balance loss (float32); ``with_stats`` appends
    ``{"moe_wire_coded_bits"}``, the measured coded bits of every
    layer's compressed MoE dispatch and combine (float64; non-zero only
    under ``moe_impl="a2a"`` on a mesh).  The mesh is read once, here,
    so a block's re-run in the backward sees the forward's.
    """
    if cfg.remat not in ("none", "block", "save_mixer_ffn"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    x = _embed_inputs(params, batch, cfg)
    mesh = current_mesh() or {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    wire = torch.zeros((), dtype=torch.float64, device=x.device)
    for bg, subs in zip(cfg.blocks, params["groups"]):
        layers = [[a.unbind(0) for a in tree_leaves(sub)] for sub in subs]
        for r in range(bg.repeats):
            for si, kind in enumerate(bg.pattern):
                p = tree_unflatten(subs[si], [u[r] for u in layers[si]])
                if cfg.remat == "none":
                    x, a, w = block_apply(kind, p, x, cfg, mesh)
                else:
                    x, a, w = checkpoint(block_apply, kind, p, x, cfg, mesh,
                                         use_reentrant=False)
                aux = aux + a
                wire = wire + w
    logits = _logits(params, x, batch, cfg)
    if with_stats:
        return logits, aux, {"moe_wire_coded_bits": wire}
    return logits, aux


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, device=None,
                dtype=None):
    """Empty caches (KV slots at pos = -1, recurrent states at 0),
    stacked per group-sub like the params."""
    dev = resolve_device(device)
    return tuple(
        tuple(tree_stack([block_cache_init(kind, cfg, batch, cache_len, dev,
                                           dtype)
                          for _ in range(bg.repeats)])
              for kind in bg.pattern)
        for bg in cfg.blocks)


def cache_pspec(cfg: ModelConfig, axes: Optional[Axes] = None):
    """Partition specs of ``init_caches``'s tree: batch on the data
    axes, heads (or the recurrent width) on the model axis."""
    axes = axes or Axes()
    return tuple(tuple(_prepend_axis(block_cache_pspec(k, cfg, axes))
                       for k in bg.pattern) for bg in cfg.blocks)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache_len: int):
    """Full-sequence forward that materializes every block's cache (of
    every position, prefix included); the logits cover the token
    positions."""
    x = _embed_inputs(params, batch, cfg)
    per = [[[] for _ in bg.pattern] for bg in cfg.blocks]
    for gi, si, _, kind, p in _layers(cfg, params):
        x, c = block_prefill(kind, p, x, cfg, cache_len)
        per[gi][si].append(c)
    caches = tuple(tuple(tree_stack(cs) for cs in g) for g in per)
    return _logits(params, x, batch, cfg), caches


def decode_step(params, tokens: torch.Tensor, caches, pos,
                cfg: ModelConfig):
    """One autoregressive step: tokens (B, 1) at absolute position ``pos``.
    Returns (logits (B, 1, vocab), caches), the caches updated in place.

    ``pos`` is a 0-d int32 tensor on the tokens' device (the reference's
    traced ``jnp.int32``) or an int, which becomes that tensor here; no
    op of the step reads it, or any other value, back to the host, so
    ``serve.Engine`` captures the step once as a CUDA graph and replays
    it with ``pos`` in a device buffer.  Both forms give the same bits.
    """
    pos = decode_pos(pos, tokens.device)
    x = embed_apply(params["embed"], tokens, cfg)
    for gi, si, r, kind, p in _layers(cfg, params):
        x, _ = block_decode(kind, p, x, tree_index(caches[gi][si], r), pos,
                            cfg)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return unembed_apply(params["embed"], x, cfg), caches
