"""Model configuration and parameter helpers (port of
``repro.models.common``, the fields dense attention models read).

A config's layer stack is a tuple of ``BlockGroup``s — (pattern of block
kinds, repeat count).  Parameters keep the reference's layout: every
leaf of a group's sub-block is stacked with a leading ``(repeats,)``
axis, so ``models.convert.from_jax_params`` maps leaf to leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

__all__ = ["BlockGroup", "ModelConfig", "truncated_normal_init",
           "tree_map", "tree_stack", "tree_index"]


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


def tree_stack(trees):
    """Stack a list of same-structured trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree (views: writes go to the stack)."""
    return tree_map(lambda a: a[i], tree)
