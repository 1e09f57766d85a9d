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
    router, the stacked experts, the shared expert) and MLA leaves (the
    low-rank projections and their norms) included.  Checks the
    embedding, the groups, each MoE block's expert count and each MLA
    block's latent width (``wkv_a``: kv_lora + rope) against ``cfg``."""
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
            if "moe" in kind:
                e = sub["ffn"]["router"].shape[-1]
                if e != cfg.n_experts:
                    raise ValueError(f"{kind} block routes to {e} experts, "
                                     f"config has {cfg.n_experts}")
    return params
