"""Block kinds (port of ``repro.models.blocks``): pre-norm sequence
mixer + FFN with residuals.

Kinds (the reference's ``_parse`` table):
  attn        GQA attention + dense gated MLP
  local       sliding-window attention + dense MLP
  attn_moe    GQA attention + MoE
  local_moe   windowed attention + MoE
  mla         MLA attention + dense MLP      mla_moe     MLA + MoE
  mla_local   windowed MLA + dense MLP       mla_local_moe
  rec         RG-LRU recurrent block + dense MLP
  mamba       Mamba-2 mixer (no separate FFN, as in the reference)

``block_apply`` returns (x, aux, wire): aux is the MoE load-balance
loss (0 elsewhere), wire the measured coded bits of the block's
compressed MoE dispatch (non-zero only under ``moe_impl="a2a"`` on a
mesh).  An MoE block's cache is ``{"mixer": ..., "moe_counts": (B, E)
int32}`` (the mixer's: a KV cache, or MLA's latent cache): the counts
carry the streaming-capacity state, so decode drops exactly the slots
the full forward drops.  The recurrent kinds' caches are their fixed-size
states (``{h, conv}``, ``{state, conv_x, conv_B, conv_C}``), with no
positions.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from .common import Axes, ModelConfig, PSpec
from .layers import (attn_apply, attn_cache_init, attn_cache_pspec,
                     attn_decode, attn_init, attn_prefill, attn_pspec,
                     mlp_apply, mlp_init, mlp_pspec, rmsnorm_apply,
                     rmsnorm_init, rmsnorm_pspec)
from .mla import (mla_apply, mla_cache_init, mla_cache_pspec, mla_decode,
                  mla_init, mla_prefill, mla_pspec)
from .moe import (moe_apply, moe_apply_a2a_block, moe_apply_eshard,
                  moe_decode, moe_init, moe_prefill, moe_pspec)
from .rglru import (rglru_apply, rglru_cache_init, rglru_cache_pspec,
                    rglru_decode, rglru_init, rglru_prefill, rglru_pspec)
from .ssm import (mamba_apply, mamba_cache_init, mamba_cache_pspec,
                  mamba_decode, mamba_init, mamba_prefill, mamba_pspec)

__all__ = ["BLOCK_KINDS", "block_init", "block_pspec", "block_apply",
           "block_cache_init", "block_cache_pspec", "block_decode",
           "block_prefill"]

# kind → (mixer, windowed, ffn), the reference's table
_TABLE = {"attn": ("gqa", False, "dense"), "local": ("gqa", True, "dense"),
          "attn_moe": ("gqa", False, "moe"),
          "local_moe": ("gqa", True, "moe"),
          "mla": ("mla", False, "dense"), "mla_moe": ("mla", False, "moe"),
          "mla_local": ("mla", True, "dense"),
          "mla_local_moe": ("mla", True, "moe"),
          "rec": ("rec", False, "dense"),
          "mamba": ("mamba", False, "none")}
BLOCK_KINDS = tuple(_TABLE)


class _Mixer(NamedTuple):
    init: Callable
    apply: Callable
    cache_init: Callable
    decode: Callable
    prefill: Callable
    pspec: Callable
    cache_pspec: Callable
    windowed: bool = False          # takes ``window=`` (the attentions)


_MIXERS = {"gqa": _Mixer(attn_init, attn_apply, attn_cache_init,
                         attn_decode, attn_prefill, attn_pspec,
                         attn_cache_pspec, True),
           "mla": _Mixer(mla_init, mla_apply, mla_cache_init, mla_decode,
                         mla_prefill, mla_pspec, mla_cache_pspec, True),
           "rec": _Mixer(rglru_init, rglru_apply, rglru_cache_init,
                         rglru_decode, rglru_prefill, rglru_pspec,
                         rglru_cache_pspec),
           "mamba": _Mixer(mamba_init, mamba_apply, mamba_cache_init,
                           mamba_decode, mamba_prefill, mamba_pspec,
                           mamba_cache_pspec)}
_MOE_IMPLS = ("scatter", "eshard", "a2a")


def _parse(kind: str) -> Tuple[str, bool, str]:
    if kind not in _TABLE:
        raise ValueError(f"unknown block kind {kind!r}")
    return _TABLE[kind]


def _window(cfg: ModelConfig, mixer: str, windowed: bool) -> Dict[str, int]:
    """The mixer's ``window=`` keyword (none for the recurrent ones)."""
    if not _MIXERS[mixer].windowed:
        return {}
    return {"window": cfg.sliding_window if windowed else 0}


def block_init(kind: str, cfg: ModelConfig, generator, device):
    mixer, _, ffn = _parse(kind)
    p: Dict[str, Any] = {"norm_mix": rmsnorm_init(cfg, device)}
    p["mixer"] = _MIXERS[mixer].init(cfg, generator, device)
    if ffn != "none":
        p["norm_ffn"] = rmsnorm_init(cfg, device)
        p["ffn"] = (moe_init(cfg, generator, device) if ffn == "moe"
                    else mlp_init(cfg, generator, device))
    return p


def block_pspec(kind: str, cfg: ModelConfig, axes: Axes):
    """The partition specs of ``block_init``'s tree (the reference's
    ``block_pspec``)."""
    mixer, _, ffn = _parse(kind)
    p: Dict[str, Any] = {"norm_mix": rmsnorm_pspec(cfg, axes),
                         "mixer": _MIXERS[mixer].pspec(cfg, axes)}
    if ffn != "none":
        p["norm_ffn"] = rmsnorm_pspec(cfg, axes)
        p["ffn"] = (moe_pspec(cfg, axes) if ffn == "moe"
                    else mlp_pspec(cfg, axes))
    return p


def block_apply(kind: str, params, x, cfg: ModelConfig, mesh=None):
    """x → (x, aux, wire).  ``mesh`` is the a2a and eshard MoE's mesh
    (default: ``models.moe.current_mesh()``)."""
    mixer, windowed, ffn = _parse(kind)
    h = rmsnorm_apply(params["norm_mix"], x, cfg.norm_eps)
    x = x + _MIXERS[mixer].apply(params["mixer"], h, cfg,
                                 **_window(cfg, mixer, windowed))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    wire = torch.zeros((), dtype=torch.float64, device=x.device)
    if ffn == "none":
        return x, aux, wire
    h = rmsnorm_apply(params["norm_ffn"], x, cfg.norm_eps)
    if ffn == "moe":
        if cfg.moe_impl not in _MOE_IMPLS:
            raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}; "
                             f"one of {_MOE_IMPLS}")
        if cfg.moe_impl == "a2a":
            h, aux, wire = moe_apply_a2a_block(params["ffn"], h, cfg, mesh)
        elif cfg.moe_impl == "eshard":
            h, aux = moe_apply_eshard(params["ffn"], h, cfg, mesh)
        else:
            h, aux = moe_apply(params["ffn"], h, cfg)
    else:
        h = mlp_apply(params["ffn"], h, cfg)
    return x + h, aux, wire


def block_cache_init(kind: str, cfg: ModelConfig, batch: int, cache_len: int,
                     device, dtype=None):
    mixer, windowed, ffn = _parse(kind)
    cache = _MIXERS[mixer].cache_init(cfg, batch, cache_len, device,
                                      dtype=dtype,
                                      **_window(cfg, mixer, windowed))
    if ffn == "moe":
        return {"mixer": cache,
                "moe_counts": torch.zeros((batch, cfg.n_experts),
                                          dtype=torch.int32, device=device)}
    return cache


def block_cache_pspec(kind: str, cfg: ModelConfig, axes: Axes):
    mixer, _, ffn = _parse(kind)
    pspec = _MIXERS[mixer].cache_pspec(cfg, axes)
    if ffn == "moe":
        return {"mixer": pspec, "moe_counts": PSpec(None, None)}
    return pspec


def block_decode(kind: str, params, x, cache, pos, cfg: ModelConfig):
    """One token through the block at position ``pos`` (a 0-d int32
    tensor on x's device, or an int), passed on to the mixer and the MoE
    as it is; the cache (the KV slots or the recurrent state, and an MoE
    block's counts) is updated in place."""
    mixer, windowed, ffn = _parse(kind)
    mixer_cache = cache["mixer"] if ffn == "moe" else cache
    h = rmsnorm_apply(params["norm_mix"], x, cfg.norm_eps)
    h, _ = _MIXERS[mixer].decode(params["mixer"], h, mixer_cache, pos, cfg,
                                 **_window(cfg, mixer, windowed))
    x = x + h
    if ffn == "none":
        return x, cache
    h = rmsnorm_apply(params["norm_ffn"], x, cfg.norm_eps)
    if ffn == "moe":
        h, _ = moe_decode(params["ffn"], h, cache["moe_counts"], pos, cfg)
    else:
        h = mlp_apply(params["ffn"], h, cfg)
    return x + h, cache


def block_prefill(kind: str, params, x, cfg: ModelConfig, cache_len: int):
    """Full-sequence forward that also materializes the block's cache."""
    mixer, windowed, ffn = _parse(kind)
    h = rmsnorm_apply(params["norm_mix"], x, cfg.norm_eps)
    h, cache = _MIXERS[mixer].prefill(params["mixer"], h, cfg, cache_len,
                                      **_window(cfg, mixer, windowed))
    x = x + h
    if ffn == "none":
        return x, cache
    h = rmsnorm_apply(params["norm_ffn"], x, cfg.norm_eps)
    if ffn == "moe":
        h, _, counts = moe_prefill(params["ffn"], h, cfg)
        return x + h, {"mixer": cache, "moe_counts": counts}
    return x + mlp_apply(params["ffn"], h, cfg), cache
