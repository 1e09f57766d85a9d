"""The served model's weights, made by the benchmark from the seed.

One flat buffer of every bf16 weight is drawn on the device from a
``torch.Generator`` in a few calls of at most 2^30 normals, in bf16;
each weight is a view of it, scaled in place by 1/√fan-in, and the
projections that write into the residual stream (``out_proj``, ``wo``,
``w_down``) by 1/√(2 · layers) besides, the GPT-2 / Megatron scaling of
a deep stack: at 1/√fan-in alone the random 48-layer stacks amplify
rounding so far that a bf16 forward lies ~40 % from a float32 one (a
CPU check at width 256: 1.6 % at 4 layers, 7.9 % at 16, 40.7 % at 48;
1.8 % at 48 with the scaling).  The float32
leaves are fixed: RMSNorm scales 0 (the norms scale by 1 + scale),
``dt_bias`` 0, ``D`` 1 and ``A_log`` = log(1 … 16) over the heads.  The
tree has the layout the program takes (``model_init``'s on the meta
device gives the shapes alone); both the program and the reference read
these tensors.
"""
from __future__ import annotations

import math

import torch

_DRAW = 1 << 30
_FIXED = ("scale", "dt_bias", "D", "A_log")
_RESIDUAL = ("out_proj", "wo", "w_down")


def _fan_in(name: str, shape) -> int:
    if name == "table":
        return shape[1]
    if name == "head":
        return shape[0]
    if name in ("out_proj", "wo"):
        return math.prod(shape[1:-1])
    return shape[1]                     # stacked: (layers, in, ...)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, made, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, made, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, made, path + (i,))
                          for i, v in enumerate(tree))
    return made[path]


def _fixed(name: str, meta: torch.Tensor, device) -> torch.Tensor:
    if name in ("scale", "dt_bias"):
        return torch.zeros(meta.shape, dtype=meta.dtype, device=device)
    if name == "D":
        return torch.ones(meta.shape, dtype=meta.dtype, device=device)
    if name == "A_log":
        h = meta.shape[-1]
        row = torch.log(torch.linspace(1.0, 16.0, h, device=device))
        return row.expand(meta.shape).to(meta.dtype).contiguous()
    raise ValueError(f"no rule for the float leaf {name!r}")


def make_params(cfg, seed: int, device):
    """The parameter tree of ``cfg`` drawn from ``seed`` on ``device``."""
    from repro_torch.models.transformer import model_init
    meta = model_init(cfg, None, device="meta")
    leaves = list(_leaves(meta))
    drawn = [(p, t) for p, t in leaves if p[-1] not in _FIXED]
    total = sum(t.numel() for _, t in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.empty(total, dtype=cfg.dtype, device=device)
    if any(t.dtype != cfg.dtype for _, t in drawn):
        raise ValueError("a drawn weight is not of the model's dtype")
    for i in range(0, total, _DRAW):
        flat[i:i + _DRAW].normal_(generator=gen)
    made, at = {}, 0
    for path, t in drawn:
        n = t.numel()
        view = flat[at:at + n].view(t.shape)
        scale = _fan_in(path[-1], t.shape) ** -0.5
        if path[-1] in _RESIDUAL:
            scale *= (2 * cfg.n_layers) ** -0.5
        view.mul_(scale)
        made[path] = view
        at += n
    for path, t in leaves:
        if path not in made:
            made[path] = _fixed(path[-1], t, device)
    return _rebuild(meta, made)
