"""Model configuration and parameter helpers (port of
``repro.models.common``: every field of the reference's config, for
dense attention, MLA, MoE, Mamba-2, RG-LRU and the prefix-embedding
front ends of the VLM and audio configs).

A config's layer stack is a tuple of ``BlockGroup``s — (pattern of block
kinds, repeat count).  Parameters keep the reference's layout: every
leaf of a group's sub-block is stacked with a leading ``(repeats,)``
axis, so ``models.convert.from_jax_params`` maps leaf to leaf.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, List, Optional, Tuple

import torch

__all__ = ["BlockGroup", "ModelConfig", "Axes", "PSpec",
           "shard_or_replicate", "pspec_map", "pspec_leaves",
           "truncated_normal_init", "tree_map", "tree_leaves",
           "tree_unflatten", "tree_stack", "tree_index"]


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
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
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
    causal: bool = True            # False → encoder-only (hubert)
    d_ff: int = 0
    ffn_activation: str = "silu"   # silu (gated) | gelu (gated, tanh form)
    # ---- moe ----
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # "scatter": every expert over per-sequence capacity buffers on one
    #   device (``models.moe.moe_apply``).
    # "a2a": expert-parallel dispatch over the compressed ring all_to_all
    #   (``models.moe.moe_apply_a2a_block``) — the scatter path's numbers,
    #   the dispatch wire coded and measured a round; needs a mesh with a
    #   "model" axis (``models.moe.use_mesh``), "scatter" without one.
    # "eshard": expert-sharded compute (``models.moe.moe_apply_eshard``):
    #   every "model" rank runs its local experts over its data shard's
    #   tokens and one psum over "model" combines; needs a mesh with a
    #   "model" axis, "scatter" without one.
    moe_impl: str = "scatter"
    # ---- mla (deepseek) ----
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # ---- ssm (mamba2) ----
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 128           # SSD chunk length
    # ---- rg-lru (recurrentgemma) ----
    lru_width: int = 0
    conv_width: int = 4
    # ---- prefix-embedding front ends (their towers are not models here)
    prefix_len: int = 0            # VLM patch slots before the tokens
    prefix_only: bool = False      # True → inputs are frame embeddings
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

    @property
    def is_decoder(self) -> bool:
        return self.causal

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing for every layer kind?"""
        full_attn = {"attn", "attn_moe", "mla", "mla_moe"}
        return all(k not in full_attn for k in self.layer_kinds)

    def with_sliding_window(self, window: int) -> "ModelConfig":
        """The long-context variant: every full-attention kind becomes
        its windowed twin, as the reference's does."""
        swa = {"attn": "local", "attn_moe": "local_moe", "mla": "mla_local",
               "mla_moe": "mla_local_moe"}
        blocks = tuple(BlockGroup(tuple(swa.get(k, k) for k in g.pattern),
                                  g.repeats) for g in self.blocks)
        return replace(self, blocks=blocks, sliding_window=window,
                       name=self.name + "+swa")

    def reduced(self, **overrides) -> "ModelConfig":
        """The ≤2-layer, d_model≤256 smoke variant of the same family,
        with the reference's cuts (``repro.models.common.ModelConfig
        .reduced``) of the fields the ported kinds have."""
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
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            moe_d_ff=min(self.moe_d_ff, 256) if self.moe_d_ff else 0,
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 32)
            if self.kv_lora_rank else 0,
            qk_nope_head_dim=32 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=16 if self.qk_rope_head_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            lru_width=d if self.lru_width else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            prefix_len=min(self.prefix_len, 16) if self.prefix_len else 0,
            remat="none",
        )
        defaults.update(overrides)
        return replace(self, **defaults)


@dataclass(frozen=True)
class Axes:
    """Mesh axis names and sizes the ``*_pspec`` functions read (the
    reference's ``Axes``)."""
    data: str = "data"
    model: str = "model"
    model_size: int = 1
    extra_data: Tuple[str, ...] = ()   # ("pod",) in the multi-pod mesh

    @property
    def data_axes(self):
        return self.extra_data + (self.data,)


class PSpec(tuple):
    """A partition spec: one entry a tensor dim, each ``None``
    (replicated), a mesh-axis name or a tuple of names (sharded over
    their product), as ``jax.sharding.PartitionSpec`` holds them: a
    one-name tuple is stored as the name, an empty one as ``None``."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


def shard_or_replicate(n: int, axes: Axes) -> Optional[str]:
    """Model-axis name if ``n`` divides it, else None (replicate)."""
    return axes.model if axes.model_size and n % axes.model_size == 0 else None


def pspec_map(fn, tree, *rest):
    """``fn`` over the ``PSpec`` leaves of a pspec tree (and the same
    places of the trees in ``rest``, which follow its structure), where
    ``tree_map`` would walk into a spec, which is a tuple."""
    if isinstance(tree, PSpec):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: pspec_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [pspec_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(
            out)
    raise TypeError(f"not a pspec tree leaf: {tree!r}")


def pspec_leaves(tree) -> List[PSpec]:
    """The ``PSpec`` leaves in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, PSpec):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in pspec_leaves(tree[k])]
    return [x for v in tree for x in pspec_leaves(v)]


def truncated_normal_init(shape, dtype, scale: float,
                          generator: torch.Generator, device) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``scale``, drawn in float32
    and cast — the reference's shapes and scales (its draws come from
    ``jax.random`` and differ).  On the meta device: the shape alone."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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
    """Stack a list of same-structured trees along a new leading axis
    (one tree: a view with a leading axis of 1, no copy)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if len(trees) == 1:
        return first.unsqueeze(0)
    return torch.stack(trees)


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree (views: writes go to the stack)."""
    return tree_map(lambda a: a[i], tree)
