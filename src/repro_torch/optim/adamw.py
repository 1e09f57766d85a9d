"""AdamW on parameter trees (port of ``repro.optim.adamw``).

State mirrors the param tree (``m``, ``v`` in float32, ``step`` int32),
and the update is the reference's float32 arithmetic, operation for
operation: the clip ``min(1, clip / (‖g‖ + 1e-9))``, the bias
corrections ``1 − b ** step`` on a float32 step, the learning rate
``lr × schedule(step)``.  Every such scalar is a float32 tensor on the
params' device, never a Python float, and no division is by a Python
scalar (CUDA turns that into a multiply by the reciprocal), so the CPU
and the card round as the reference does up to the last bits of its
``pow`` and ``cos``.

``adamw_state_pspec`` and ``zero1_state_pspec`` give the state's
partition specs (the reference's rules, for ``launch.dryrun``'s plan).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from ..models.common import (PSpec, pspec_map, tree_leaves, tree_map,
                             tree_unflatten)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "cosine_schedule", "adamw_state_pspec",
           "zero1_state_pspec"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor           # () int32
    m: Any
    v: Any


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device, made by a fill: a copy from
    a host value would wait for the device's queue first."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def adamw_init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    first = tree_leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=zeros, v=tree_map(torch.clone, zeros))


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ leaves Σ x²) in float32 (float32 tensor, 0-d)."""
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 lr_scale=1.0):
    """One AdamW step.  Returns (new_params, new_state, metrics).

    **Consumes ``state``**: the moments are updated in place, and the
    new state holds ``state``'s ``m`` and ``v`` tensors (a functional
    update would hold two copies of them, 20 GB each at ``gemma2-2b``'s
    width).  After the call ``state.m``/``state.v`` are the new moments
    while ``state.step`` is the old count, so ``state`` must not be used
    again — nor after an exception inside the call, which may leave the
    moments partly moved.  A caller that needs the old state clones its
    moments first.  Params come back as new tensors and ``params`` is
    left as it was."""
    gnorm = global_norm(grads)
    clip = torch.minimum(_f32(1.0, gnorm),
                         _f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9))
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, gnorm), stepf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, gnorm), stepf)
    if not isinstance(lr_scale, torch.Tensor):
        lr_scale = _f32(lr_scale, gnorm)
    lr = _f32(cfg.lr, gnorm) * lr_scale

    def upd(g, m, v, p):
        # the reference's expressions, op for op, with m and v updated
        # in place and the temporaries reused
        g = g.to(torch.float32) * clip
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        t = g * (1 - cfg.b2)
        v.mul_(cfg.b2).add_(t.mul_(g))
        del g, t
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        pf = p.to(torch.float32, copy=True)     # a float32 p stays as is
        delta.add_(pf * cfg.weight_decay)
        return pf.sub_(delta.mul_(lr)).to(p.dtype)

    new_p = tree_unflatten(params, [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
        tree_leaves(params))])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step=step, m=state.m, v=state.v), metrics


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int tensor) → the float32 learning-rate *scale*: linear
    warm-up to 1 over ``warmup`` steps, then a cosine to 0 at ``total``
    (``base_lr`` is the caller's, as in the reference)."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = torch.minimum(s / _f32(max(warmup, 1), s), _f32(1.0, s))
        prog = torch.clamp((s - warmup) / _f32(max(total - warmup, 1), s),
                           0.0, 1.0)
        return warm * (0.5 * (1 + torch.cos(math.pi * prog)))
    return fn


def adamw_state_pspec(param_pspec) -> AdamWState:
    """The moments sharded as their params, the step replicated."""
    return AdamWState(step=PSpec(), m=param_pspec,
                      v=pspec_map(lambda s: s, param_pspec))


def zero1_state_pspec(param_pspec, params_shapes, axes) -> AdamWState:
    """ZeRO-1 (the reference's rule): each moment leaf not already on a
    data axis goes on the data axes at its first dim that is unsharded
    and divisible by 16 — a nominal 16, whatever the data degree, as the
    reference's.  ``params_shapes`` is a tree of tensors (the meta
    device's) in the params' structure."""
    data_axes = axes.extra_data + (axes.data,)

    def has_data_axis(parts) -> bool:
        for p in parts:
            names = p if isinstance(p, tuple) else (p,)
            if any(n in data_axes for n in names if n):
                return True
        return False

    def shard_leaf(spec, leaf):
        parts = list(spec) + [None] * (leaf.dim() - len(spec))
        if has_data_axis(parts):       # already data-sharded (FSDP)
            return PSpec(*parts)
        for i, (p, d) in enumerate(zip(parts, leaf.shape)):
            if p is None and d % 16 == 0:
                parts[i] = data_axes if len(data_axes) > 1 else data_axes[0]
                break
        return PSpec(*parts)

    m = pspec_map(shard_leaf, param_pspec, params_shapes)
    return AdamWState(step=PSpec(), m=m, v=pspec_map(lambda s: s, m))
