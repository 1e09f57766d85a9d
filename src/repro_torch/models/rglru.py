"""RG-LRU recurrent block (port of ``repro.models.rglru``; RecurrentGemma
/ Griffin, arXiv:2402.19427).

The Real-Gated Linear Recurrent Unit:
    r_t = σ(W_a x_t)            (recurrence gate, block-diagonal)
    i_t = σ(W_x x_t)            (input gate, block-diagonal)
    a_t = exp(-c · softplus(Λ) · r_t)          with c = 8
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)
inside the Griffin block: x → [linear → causal conv1d → RG-LRU] ⊙
gelu(linear) → linear out.

The full-sequence forward and the prefill evaluate the recurrence with
``_linear_scan``, the reference's ``jax.lax.associative_scan``
odd/even recursion in float32 (log depth, O(L) work); the decode is the
O(1) update.  Layouts are the reference's: ``w_in``/``w_gate`` (d, W),
``conv`` (cw, W), ``wa``/``wx`` (16, W/16, W/16) block-diagonal gates,
``lam`` (W,) float32, ``w_out`` (W, d); the cache is ``{"h" (B, W)
float32, "conv" (B, cw − 1, W)}``, the last cw − 1 raw pre-conv inputs.
Math rounds where the reference's code rounds under XLA: the conv adds
tap by tap in ``cfg.dtype``, the decode's conv window multiplies and
sums in float32 and rounds once, the tanh-form GeLU rounds op by op
(``layers.gelu_tanh``), the gates and ``h`` stay float32 until the
output casts.  The decode writes ``h`` and the conv tail into the given
cache in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (Axes, ModelConfig, PSpec, shard_or_replicate,
                     truncated_normal_init)
from .layers import gelu_tanh

__all__ = ["rglru_init", "rglru_pspec", "rglru_apply", "rglru_cache_init",
           "rglru_cache_pspec", "rglru_decode", "rglru_prefill"]

_C = 8.0
_N_BLOCKS = 16


def _w(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def rglru_init(cfg: ModelConfig, generator, device):
    d, w = cfg.d_model, _w(cfg)
    nb = min(_N_BLOCKS, w)
    bw = w // nb
    cw = cfg.conv_width

    def tn(shape, scale):
        return truncated_normal_init(shape, cfg.dtype, scale, generator,
                                     device)

    # Λ so that a ∈ (0.9, 0.999) at r = 1 (the reference's closed form)
    a = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=device)
    lam = torch.log(torch.expm1(-torch.log(a) / _C))
    return {"w_in": tn((d, w), d ** -0.5), "w_gate": tn((d, w), d ** -0.5),
            "conv": tn((cw, w), cw ** -0.5),
            "wa": tn((nb, bw, bw), bw ** -0.5),
            "wx": tn((nb, bw, bw), bw ** -0.5),
            "lam": lam, "w_out": tn((w, d), w ** -0.5)}


def rglru_pspec(cfg: ModelConfig, axes: Axes):
    w = _w(cfg)
    m = shard_or_replicate(w, axes)
    mb = shard_or_replicate(min(_N_BLOCKS, w), axes)
    return {"w_in": PSpec(None, m), "w_gate": PSpec(None, m),
            "conv": PSpec(None, m), "wa": PSpec(mb, None, None),
            "wx": PSpec(mb, None, None), "lam": PSpec(m),
            "w_out": PSpec(m, None)}


def _block_diag(x, w):
    """x (..., W) through the block-diagonal weight (NB, BW, BW)."""
    nb, bw, _ = w.shape
    xs = x.reshape(x.shape[:-1] + (nb, bw))
    return torch.einsum("...nb,nbc->...nc", xs, w).reshape(x.shape)


def _gates(params, x):
    """(a_t, gated input), both float32, from the conv'd branch x."""
    r = torch.sigmoid(_block_diag(x, params["wa"]).to(torch.float32))
    i = torch.sigmoid(_block_diag(x, params["wx"]).to(torch.float32))
    log_a = -_C * F.softplus(params["lam"]) * r                # ≤ 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i * x.to(torch.float32))
    return a, gated


def _causal_conv1d(x, w):
    """x (B, L, W) through the depthwise causal conv w (CW, W): one
    shifted multiply-add a tap, each rounded in x's dtype."""
    cw, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + l] * w[i]
    return out


def _combine(left, right):
    (al, bl), (ar, br) = left, right
    return al * ar, bl * ar + br


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1, by the
    reference's ``associative_scan`` recursion: combine adjacent pairs,
    scan the half-length sequence, then fill in the even positions.
    Returns (cumulative a, h)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = _linear_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                 (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    out = []
    for e0, ev, od in zip((a, b), even, odd):
        t = e0.new_empty(e0.shape)
        t[:, 0:1] = e0[:, 0:1]
        t[:, 2::2] = ev
        t[:, 1::2] = od
        out.append(t)
    return tuple(out)


def _full(params, u, cfg: ModelConfig):
    """The full-sequence block → (y (B, L, d), h (B, L, W) float32, the
    raw pre-conv input (B, L, W))."""
    x_raw = u @ params["w_in"]
    gate = gelu_tanh(u @ params["w_gate"])
    a, b = _gates(params, _causal_conv1d(x_raw, params["conv"]))
    _, h = _linear_scan(a, b)
    y = h.to(cfg.dtype) * gate
    return y @ params["w_out"], h, x_raw


def rglru_apply(params, u, cfg: ModelConfig):
    """u (B, L, d) → (B, L, d), the full-sequence forward."""
    return _full(params, u, cfg)[0]


def rglru_cache_init(cfg: ModelConfig, batch: int, cache_len: int, device,
                     dtype=None):
    """Zero state: ``h`` float32 and the conv tail (no positions)."""
    w = _w(cfg)
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                dtype=dtype or cfg.dtype, device=device)}


def rglru_cache_pspec(cfg: ModelConfig, axes: Axes):
    m = shard_or_replicate(_w(cfg), axes)
    return {"h": PSpec(axes.data_axes, m),
            "conv": PSpec(axes.data_axes, None, m)}


def rglru_decode(params, u, cache, pos, cfg: ModelConfig):
    """u (B, 1, d): one recurrent step; writes ``h`` and the conv tail
    into ``cache`` in place and returns (y (B, 1, d), cache).  ``pos``
    (a 0-d device tensor or an int, as the attentions take it) is not
    read: the state carries the past."""
    ut = u[:, 0]
    x = ut @ params["w_in"]                                    # (B, W)
    gate = gelu_tanh(ut @ params["w_gate"])
    full = torch.cat([cache["conv"], x[:, None]], 1)
    x = (full.to(torch.float32) * params["conv"].to(torch.float32)).sum(
        1).to(x.dtype)
    a, b = _gates(params, x)
    h = a * cache["h"] + b
    cache["h"].copy_(h)
    cache["conv"].copy_(full[:, 1:])
    y = h.to(cfg.dtype) * gate
    return (y @ params["w_out"])[:, None], cache


def rglru_prefill(params, u, cfg: ModelConfig, cache_len: int = 0):
    """The full-sequence forward and the cache it leaves: the last ``h``
    and the last cw − 1 raw pre-conv inputs, zero-padded on the left for
    a prompt shorter than that."""
    cw, l = cfg.conv_width, u.shape[1]
    y, h, x_raw = _full(params, u, cfg)
    xp = F.pad(x_raw, (0, 0, cw - 1, 0))
    return y, {"h": h[:, -1].clone(),
               "conv": xp[:, l:l + cw - 1].to(cfg.dtype, copy=True)}
