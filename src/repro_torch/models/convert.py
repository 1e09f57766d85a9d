"""Reference parameter trees → the port's parameters.

``from_jax_params`` takes the JAX package's parameter pytree with its
leaves given as NumPy arrays (for example through ``jax.device_get``)
and returns the same tree of torch tensors, which is exactly the port's
parameter layout (stacked ``(repeats, ...)`` leaves and all).  bfloat16
leaves arrive as ``ml_dtypes`` arrays; they are recognised by dtype name
and reinterpreted bit for bit through int16, so this module imports
neither jax nor ml_dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .common import ModelConfig, tree_map

__all__ = ["from_jax_params", "tensor_from_numpy"]


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """One leaf, bit-exact: bfloat16 by its dtype name via int16, the
    rest through ``torch.from_numpy``."""
    a = np.array(a)                      # an owned, writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax_params(np_tree, cfg: ModelConfig, device=None):
    """The reference's ``model_init`` tree (NumPy leaves) as the port's
    parameters on ``device`` (CUDA unless named), MoE leaves (the float32
    router, the stacked experts, the shared expert), MLA leaves (the
    low-rank projections and their norms) and the recurrent blocks'
    leaves (a ``mamba`` block holds no FFN) included.  Checks the
    embedding, the groups, each MoE block's expert count, each MLA
    block's latent width (``wkv_a``: kv_lora + rope), each ``rec``
    block's width (``w_in``: (d, ``lru_width`` or d)) and each ``mamba``
    block's heads (``wx``: (d, H, P)) against ``cfg``."""
    dev = resolve_device(device)
    params = tree_map(lambda a: tensor_from_numpy(a, dev), np_tree)
    table = params["embed"]["table"]
    if tuple(table.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embedding {tuple(table.shape)} does not match "
                         f"config ({cfg.vocab_size}, {cfg.d_model})")
    if len(params["groups"]) != len(cfg.blocks):
        raise ValueError(f"{len(params['groups'])} groups for "
                         f"{len(cfg.blocks)} block groups")
    for bg, subs in zip(cfg.blocks, params["groups"]):
        for kind, sub in zip(bg.pattern, subs):
            if kind.startswith("mla"):
                w = sub["mixer"]["wkv_a"].shape[-1]
                want = cfg.kv_lora_rank + cfg.qk_rope_head_dim
                if w != want:
                    raise ValueError(f"{kind} block's wkv_a is {w} wide, "
                                     f"config has kv_lora + rope = {want}")
            if kind == "rec":
                got = tuple(sub["mixer"]["w_in"].shape[-2:])
                want = (cfg.d_model, cfg.lru_width or cfg.d_model)
                if got != want:
                    raise ValueError(f"rec block's w_in is {got}, config "
                                     f"has (d, lru_width) = {want}")
            if kind == "mamba":
                got = tuple(sub["mixer"]["wx"].shape[-3:])
                want = (cfg.d_model, cfg.ssm_expand * cfg.d_model
                        // cfg.ssm_head_dim, cfg.ssm_head_dim)
                if got != want:
                    raise ValueError(f"mamba block's wx is {got}, config "
                                     f"has (d, heads, head_dim) = {want}")
            if "moe" in kind:
                e = sub["ffn"]["router"].shape[-1]
                if e != cfg.n_experts:
                    raise ValueError(f"{kind} block routes to {e} experts, "
                                     f"config has {cfg.n_experts}")
    return params
