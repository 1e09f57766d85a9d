"""Block kinds (port of ``repro.models.blocks``): pre-norm attention +
gated MLP with residuals.

Ported kinds: ``attn`` (GQA attention + dense MLP) and ``local``
(sliding-window attention + dense MLP).  The reference's other kinds
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any, Dict

from .common import ModelConfig
from .layers import (attn_apply, attn_cache_init, attn_decode, attn_init,
                     attn_prefill, mlp_apply, mlp_init, rmsnorm_apply,
                     rmsnorm_init)

__all__ = ["BLOCK_KINDS", "block_init", "block_apply", "block_cache_init",
           "block_decode", "block_prefill"]

BLOCK_KINDS = ("attn", "local")
_LATER = ("attn_moe", "local_moe", "mla", "mla_moe", "mla_local",
          "mla_local_moe", "rec", "mamba")


def _window(kind: str, cfg: ModelConfig) -> int:
    if kind in BLOCK_KINDS:
        return cfg.sliding_window if kind == "local" else 0
    if kind in _LATER:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md A8: the "
            f"other block kinds)")
    raise ValueError(f"unknown block kind {kind!r}")


def block_init(kind: str, cfg: ModelConfig, generator, device):
    _window(kind, cfg)
    p: Dict[str, Any] = {"norm_mix": rmsnorm_init(cfg, device)}
    p["mixer"] = attn_init(cfg, generator, device)
    p["norm_ffn"] = rmsnorm_init(cfg, device)
    p["ffn"] = mlp_init(cfg, generator, device)
    return p


def _ffn(params, x, cfg: ModelConfig):
    h = rmsnorm_apply(params["norm_ffn"], x, cfg.norm_eps)
    return x + mlp_apply(params["ffn"], h, cfg)


def block_apply(kind: str, params, x, cfg: ModelConfig):
    w = _window(kind, cfg)
    h = rmsnorm_apply(params["norm_mix"], x, cfg.norm_eps)
    x = x + attn_apply(params["mixer"], h, cfg, window=w)
    return _ffn(params, x, cfg)


def block_cache_init(kind: str, cfg: ModelConfig, batch: int, cache_len: int,
                     device, dtype=None):
    return attn_cache_init(cfg, batch, cache_len, device,
                           window=_window(kind, cfg), dtype=dtype)


def block_decode(kind: str, params, x, cache, pos: int, cfg: ModelConfig):
    """One token through the block; the cache is updated in place."""
    w = _window(kind, cfg)
    h = rmsnorm_apply(params["norm_mix"], x, cfg.norm_eps)
    h, cache = attn_decode(params["mixer"], h, cache, pos, cfg, window=w)
    return _ffn(params, x + h, cfg), cache


def block_prefill(kind: str, params, x, cfg: ModelConfig, cache_len: int):
    """Full-sequence forward that also materializes the block's cache."""
    w = _window(kind, cfg)
    h = rmsnorm_apply(params["norm_mix"], x, cfg.norm_eps)
    h, cache = attn_prefill(params["mixer"], h, cfg, cache_len, window=w)
    return _ffn(params, x + h, cfg), cache
