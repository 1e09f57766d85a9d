"""Shared neural layers (port of ``repro.models.layers``): RMSNorm,
rotary embeddings, GQA attention (full / sliding window, full-sequence,
prefill and cached one-token decode), gated MLP, embeddings (with the
prefix embeddings of the VLM and audio configs).

Tensor layouts are the reference's: ``wq (d, H, hd)``, ``wk/wv
(d, KV, hd)``, ``wo (H, hd, d)``, KV caches ``(B, slots, KV, hd)`` with
``pos (slots,)`` (absolute positions, -1 for empty slots).  Math runs in
``cfg.dtype`` with float32 softmax and norm accumulators.  Attention is
plain torch (einsum and a float32 softmax with optional softcap), as the
reference computes it in plain jnp.

The cached decode updates the KV cache in place (the reference returns
a new cache): the caller's cache tensors are the step's output.  Every
cache write casts through ``cache_cast``, XLA's rule, so a
``float8_e4m3fn`` cache holds the reference's bits (NaN past 464).
Its position ``pos`` is a 0-d int32 tensor on the step's device (the
reference's traced ``jnp.int32``) or a Python int (``decode_pos`` makes
it the tensor): the slot, the cache writes and the mask are tensor ops,
so no op reads the position back to the host and a CUDA graph can
capture the step with ``pos`` in a device buffer.  The prefill writes
its slots the same way (``write_slots``), so a graph captures it too.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.symbols import xla_cast
from .common import (Axes, ModelConfig, PSpec, shard_or_replicate,
                     truncated_normal_init)

_NEG = torch.finfo(torch.float32).min


# ---------------------------------------------------------------- RMSNorm
def rmsnorm_init(cfg: ModelConfig, device, width: Optional[int] = None):
    return {"scale": torch.zeros((width or cfg.d_model,), dtype=torch.float32,
                                 device=device)}


def rmsnorm_pspec(cfg: ModelConfig, axes: Axes):
    return {"scale": PSpec(None)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return y.to(x.dtype)


# ------------------------------------------------------------------ RoPE
def rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) int → (cos, sin) of shape (..., dim/2), float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D) with positions (B, S) or (S,)."""
    cos, sin = rope_angles(positions, x.shape[-1], theta)
    cos = cos[..., None, :].to(x.dtype)
    sin = sin[..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ------------------------------------------------------------ cache writes
# a value written into a KV cache, cast as the reference's ``astype``
# casts it under XLA: to float8_e4m3fn NaN past 464, where torch saturates
cache_cast = xla_cast


def decode_pos(pos, device) -> torch.Tensor:
    """A decode step's position as a 0-d int32 tensor on ``device``: a
    tensor is taken as it is, an int is filled in on the device (a fill,
    not a copy from the host)."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.full((), pos, dtype=torch.int32, device=device)


def decode_slot(pos: torch.Tensor, slots: int, window: int) -> torch.Tensor:
    """The cache slot of position ``pos``, as a one-element int64 index:
    ``pos % slots`` in a ring (``window > 0``), else ``pos`` clamped to
    the last slot."""
    slot = (torch.remainder(pos, slots) if window > 0
            else torch.clamp(pos, max=slots - 1))
    return slot.reshape(1).to(torch.int64)


def write_slots(cache: torch.Tensor, slots: torch.Tensor,
                value: torch.Tensor) -> None:
    """``cache[:, slots] = value`` (slots an int64 index (n,), value
    (B, n, ...), cast by ``cache_cast``) through ``index_copy_``, which
    reads no index back to the host (an assignment at a tensor index
    may: at a 0-d one it calls ``.item()``); a float8 cache is written
    as its uint8 bits (``index_copy_`` has no float8 kernel on the
    CPU)."""
    v = cache_cast(value, cache.dtype)
    if cache.is_floating_point() and cache.element_size() == 1:
        cache, v = cache.view(torch.uint8), v.view(torch.uint8)
    cache.index_copy_(1, slots, v)


def valid_slots(cpos: torch.Tensor, pos: torch.Tensor,
                window: int) -> torch.Tensor:
    """The slots a decode at ``pos`` attends to: filled, not in its
    future and, in a ring, within the window."""
    valid = (cpos >= 0) & (cpos <= pos)
    if window > 0:
        valid = valid & (pos - cpos < window)
    return valid


# ----------------------------------------------------------- GQA attention
def attn_init(cfg: ModelConfig, generator, device):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_in = d ** -0.5
    s_out = (h * hd) ** -0.5

    def w(shape, scale):
        return truncated_normal_init(shape, cfg.dtype, scale, generator,
                                     device)

    p = {"wq": w((d, h, hd), s_in), "wk": w((d, kv, hd), s_in),
         "wv": w((d, kv, hd), s_in), "wo": w((h, hd, d), s_out)}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg, device, hd)
        p["k_norm"] = rmsnorm_init(cfg, device, hd)
    return p


def attn_pspec(cfg: ModelConfig, axes: Axes):
    mh = shard_or_replicate(cfg.n_heads, axes)
    mkv = shard_or_replicate(cfg.n_kv_heads, axes)
    p = {"wq": PSpec(None, mh, None), "wk": PSpec(None, mkv, None),
         "wv": PSpec(None, mkv, None), "wo": PSpec(mh, None, None)}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_pspec(cfg, axes)
        p["k_norm"] = rmsnorm_pspec(cfg, axes)
    return p


def _qkv(params, x, cfg: ModelConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = rmsnorm_apply(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_apply(params["k_norm"], k, cfg.norm_eps)
    q = rope_apply(q, positions, cfg.rope_theta)
    k = rope_apply(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q, k, v, mask, cfg: ModelConfig):
    """q (B,S,H,hd), k/v (B,T,KV,hd), mask broadcastable to
    (B, KV, G, S, T) bool → (B, S, H, hd)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, s, kvh, h // kvh, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32)
    logits = logits * hd ** -0.5
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    logits = torch.where(mask, logits, _NEG)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, hd)


def causal_mask(s: int, window: int, device) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & (i - j < window)
    return m


def _seq_mask(s: int, cfg: ModelConfig, window: int, device):
    if cfg.causal:
        return causal_mask(s, window, device)
    return torch.ones((s, s), dtype=torch.bool, device=device)


def attn_apply(params, x, cfg: ModelConfig, *, window: int = 0):
    """Full-sequence attention (train / prefill).  window>0 → sliding."""
    y, _ = _attn_full(params, x, cfg, window)
    return y


def _attn_full(params, x, cfg: ModelConfig, window: int):
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, positions)
    out = _attend(q, k, v, _seq_mask(s, cfg, window, x.device), cfg)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), (k, v)


def attn_cache_init(cfg: ModelConfig, batch: int, cache_len: int, device,
                    window: int = 0, dtype=None):
    """window>0 → ring buffer of that many slots, else full cache_len."""
    slots = min(window, cache_len) if window > 0 else cache_len
    dt = dtype or cfg.kv_cache_dtype or cfg.dtype
    shape = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.full((slots,), -1, dtype=torch.int32,
                              device=device)}


def attn_cache_pspec(cfg: ModelConfig, axes: Axes):
    mkv = shard_or_replicate(cfg.n_kv_heads, axes)
    return {"k": PSpec(axes.data_axes, None, mkv, None),
            "v": PSpec(axes.data_axes, None, mkv, None),
            "pos": PSpec(None)}


def attn_prefill(params, x, cfg: ModelConfig, cache_len: int, *,
                 window: int = 0):
    """Full-sequence attention that also materializes the KV cache:
    ring caches keep the last ``window`` tokens at slot ``pos % window``,
    full caches are right-padded to ``cache_len`` slots."""
    b, s, _ = x.shape
    y, (k, v) = _attn_full(params, x, cfg, window)
    cache = attn_cache_init(cfg, b, cache_len, x.device, window)
    slots = cache["k"].shape[1]
    take = min(s, slots)
    src = torch.arange(take, device=x.device) + (s - take)
    dst = src % slots if window > 0 else src
    write_slots(cache["k"], dst, k[:, s - take:])
    write_slots(cache["v"], dst, v[:, s - take:])
    cache["pos"].index_copy_(0, dst, src.to(torch.int32))
    return y, cache


def attn_decode(params, x, cache, pos, cfg: ModelConfig, *,
                window: int = 0):
    """x (B, 1, d): the new token at absolute position ``pos`` (a 0-d
    int32 tensor on x's device, or an int).  Writes its K/V and position
    into ``cache`` in place and returns (y, cache)."""
    b = x.shape[0]
    pos = decode_pos(pos, x.device)
    positions = pos.reshape(1, 1).expand(b, 1)
    q, k, v = _qkv(params, x, cfg, positions)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = decode_slot(pos, ck.shape[1], window)
    write_slots(ck, slot, k)
    write_slots(cv, slot, v)
    cpos.index_copy_(0, slot, pos.reshape(1).to(cpos.dtype))
    valid = valid_slots(cpos, pos, window)
    out = _attend(q, ck.to(q.dtype), cv.to(q.dtype),
                  valid[None, None, None, None, :], cfg)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, cache


# ------------------------------------------------------------- gated MLP
def mlp_init(cfg: ModelConfig, generator, device, d_ff: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff

    def w(shape, scale):
        return truncated_normal_init(shape, cfg.dtype, scale, generator,
                                     device)

    return {"w_gate": w((d, ff), d ** -0.5), "w_up": w((d, ff), d ** -0.5),
            "w_down": w((ff, d), ff ** -0.5)}


def mlp_pspec(cfg: ModelConfig, axes: Axes, d_ff: Optional[int] = None):
    m = shard_or_replicate(d_ff or cfg.d_ff, axes)
    return {"w_gate": PSpec(None, m), "w_up": PSpec(None, m),
            "w_down": PSpec(m, None)}


def mlp_apply(params, x, cfg: ModelConfig):
    gate = x @ params["w_gate"]
    # jax.nn.gelu defaults to the tanh approximation
    act = (F.silu(gate) if cfg.ffn_activation == "silu"
           else F.gelu(gate, approximate="tanh"))
    return (act * (x @ params["w_up"])) @ params["w_down"]


# ------------------------------------------- activations, XLA's roundings
def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form) op by op in x's dtype, its
    constants rounded to that dtype first: in bf16 the bits XLA gives the
    reference's formula, where ``F.gelu`` rounds once (and differs in the
    last bit on ~40 % of entries)."""
    c, k = (torch.tensor(v, dtype=x.dtype).item()
            for v in ((2.0 / math.pi) ** 0.5, 0.044715))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as x · 1 / (1 + exp(−x)), op by op in x's dtype:
    XLA's bits in bf16, where ``F.silu`` rounds once."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


# ------------------------------------------------------------ embeddings
def embed_init(cfg: ModelConfig, generator, device):
    # d^-1/2 table: the sqrt(d) embed multiplier gives unit-scale
    # activations and tied-unembed logits stay O(1).
    p = {"table": truncated_normal_init((cfg.vocab_size, cfg.d_model),
                                        cfg.dtype, cfg.d_model ** -0.5,
                                        generator, device)}
    if not cfg.tie_embeddings:
        p["head"] = truncated_normal_init((cfg.d_model, cfg.vocab_size),
                                          cfg.dtype, cfg.d_model ** -0.5,
                                          generator, device)
    return p


def embed_pspec(cfg: ModelConfig, axes: Axes):
    mv = shard_or_replicate(cfg.vocab_size, axes)
    p = {"table": PSpec(mv, None)}
    if not cfg.tie_embeddings:
        p["head"] = PSpec(None, mv)
    return p


def embed_apply(params, tokens: Optional[torch.Tensor], cfg: ModelConfig,
                prefix: Optional[torch.Tensor] = None):
    """The input sequence times sqrt(d), the factor rounded to the model
    dtype first, as the reference does: token embeddings (B, S), after
    ``prefix`` (B, P, d) embeddings when given (cast to the model dtype
    first; a prefix-only input has ``tokens=None``)."""
    parts = [] if prefix is None else [prefix.to(cfg.dtype)]
    if tokens is not None:
        parts.append(params["table"][tokens])
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    scale = torch.full((), cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x * scale


def unembed_apply(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["table"])
    return torch.einsum("bsd,dv->bsv", x, params["head"])
