"""Model configuration and parameter helpers (port of
``repro.models.common``, the fields dense attention models read).

A config's layer stack is a tuple of ``BlockGroup``s — (pattern of block
kinds, repeat count).  Parameters keep the reference's layout: every
leaf of a group's sub-block is stacked with a leading ``(repeats,)``
axis, so ``models.convert.from_jax_params`` maps leaf to leaf.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, List, Optional, Tuple

import torch

__all__ = ["BlockGroup", "ModelConfig", "truncated_normal_init",
           "tree_map", "tree_leaves", "tree_unflatten", "tree_stack",
           "tree_index"]


@dataclass(frozen=True)
class BlockGroup:
    """``pattern`` applied ``repeats`` times in sequence."""
    pattern: Tuple[str, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense (the kinds ported so far)
    d_model: int
    vocab_size: int
    blocks: Tuple[BlockGroup, ...]
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # >0 → windowed attention for "local"
    causal: bool = True
    d_ff: int = 0
    ffn_activation: str = "silu"   # silu (gated) | gelu (gated, tanh form)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    kv_cache_dtype: Optional[Any] = None
    # remat policy of ``forward_train``:
    #   "none"           — save everything
    #   "block"          — recompute each block in the backward
    #   "save_mixer_ffn" — the reference's per-block remat that keeps the
    #                      post-collective outputs; with no tensor-parallel
    #                      collective in a block here, it is "block"
    remat: str = "block"
    source: str = ""

    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.blocks)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        kinds: Tuple[str, ...] = ()
        for g in self.blocks:
            kinds = kinds + g.pattern * g.repeats
        return kinds

    def reduced(self, **overrides) -> "ModelConfig":
        """The ≤2-layer, d_model≤256 smoke variant of the same family,
        with the reference's cuts (``repro.models.common.ModelConfig
        .reduced``) of the fields a dense attention model has."""
        short = []
        for g in self.blocks:
            if sum(b.n_layers for b in short) >= 2:
                break
            short.append(BlockGroup(g.pattern[:2] if g.repeats == 1
                                    else g.pattern, 1))
        d = min(self.d_model, 256)
        nh = max(d // 64, 2)
        nkv = max(min(self.n_kv_heads, nh) if self.n_kv_heads else nh, 1)
        if self.n_kv_heads == 1:
            nkv = 1
        defaults = dict(
            name=self.name + "-smoke", blocks=tuple(short), d_model=d,
            n_heads=nh if self.n_heads else 0,
            n_kv_heads=nkv if self.n_kv_heads else 0,
            head_dim=32 if self.head_dim else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            remat="none",
        )
        defaults.update(overrides)
        return replace(self, **defaults)


def truncated_normal_init(shape, dtype, scale: float,
                          generator: torch.Generator, device) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``scale``, drawn in float32
    and cast — the reference's shapes and scales (its draws come from
    ``jax.random`` and differ)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * scale).to(dtype)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of nested dicts/tuples/lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts/tuples/lists in the reference's order
    (``jax.tree.leaves``: dict keys sorted, sequences in order), which
    is not ``tree_map``'s insertion order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """The tree shaped as ``like`` (keys in its own order) whose leaves,
    in ``tree_leaves`` order, are ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_stack(trees):
    """Stack a list of same-structured trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree (views: writes go to the stack)."""
    return tree_map(lambda a: a[i], tree)
