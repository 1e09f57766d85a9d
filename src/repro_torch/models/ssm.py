"""Mamba-2 block via SSD, state-space duality (port of
``repro.models.ssm``; arXiv:2405.21060).

The full-sequence forward and the prefill use the chunked SSD algorithm
(``ssd_chunked``): quadratic attention-like products inside chunks of
``cfg.ssm_chunk`` steps, a short loop over the chunks for the
inter-chunk recurrence of their states, and a decayed readout.  The
decode is the O(1) recurrent update of the (B, H, P, N) state.

Layouts are the reference's (projections un-fused): ``wz``/``wx``
(d, H, P), ``wB``/``wC`` (d, G, N), ``wdt`` (d, H), float32 ``dt_bias``,
``A_log`` and ``D`` (H,), depthwise convs ``conv_x`` (cw, H, P),
``conv_B``/``conv_C`` (cw, G, N), an RMSNorm of width H·P and
``out_proj`` (H, P, d).  The cache is ``{"state" (B, H, P, N) float32,
"conv_x", "conv_B", "conv_C" (B, cw − 1, ...)}``: the last cw − 1 raw
pre-conv inputs.  The SSD products are written as two-operand einsums
in one fixed order (the reference's three- and four-operand einsums
leave the order to the contraction planner), in float32; the convs add
tap by tap in ``cfg.dtype``, the decode's conv window multiplies and
sums in float32 and rounds once (XLA's bits on both), and SiLU rounds
op by op (``layers.silu``).  The decode writes the state and the conv
tails into the given cache in place.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .common import (Axes, ModelConfig, PSpec, shard_or_replicate,
                     truncated_normal_init)
from .layers import rmsnorm_apply, rmsnorm_init, rmsnorm_pspec, silu

__all__ = ["mamba_init", "mamba_pspec", "mamba_apply", "mamba_cache_init",
           "mamba_cache_pspec", "mamba_decode", "mamba_prefill",
           "ssd_chunked"]

_CHUNK = 128


def _hp(cfg: ModelConfig) -> Tuple[int, int]:
    heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    return heads, cfg.ssm_head_dim


def mamba_init(cfg: ModelConfig, generator, device):
    d = cfg.d_model
    h, p_ = _hp(cfg)
    g, n, cw = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_conv
    s = d ** -0.5

    def tn(shape, scale):
        return truncated_normal_init(shape, cfg.dtype, scale, generator,
                                     device)

    f32 = dict(dtype=torch.float32, device=device)
    return {"wz": tn((d, h, p_), s), "wx": tn((d, h, p_), s),
            "wB": tn((d, g, n), s), "wC": tn((d, g, n), s),
            "wdt": tn((d, h), s),
            "dt_bias": torch.zeros((h,), **f32),
            "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
            "D": torch.ones((h,), **f32),
            "conv_x": tn((cw, h, p_), cw ** -0.5),
            "conv_B": tn((cw, g, n), cw ** -0.5),
            "conv_C": tn((cw, g, n), cw ** -0.5),
            "norm": rmsnorm_init(cfg, device, h * p_),
            "out_proj": tn((h, p_, d), (h * p_) ** -0.5)}


def mamba_pspec(cfg: ModelConfig, axes: Axes):
    mh = shard_or_replicate(_hp(cfg)[0], axes)
    return {"wz": PSpec(None, mh, None), "wx": PSpec(None, mh, None),
            "wB": PSpec(None, None, None), "wC": PSpec(None, None, None),
            "wdt": PSpec(None, mh), "dt_bias": PSpec(mh),
            "A_log": PSpec(mh), "D": PSpec(mh),
            "conv_x": PSpec(None, mh, None),
            "conv_B": PSpec(None, None, None),
            "conv_C": PSpec(None, None, None),
            "norm": rmsnorm_pspec(cfg, axes),
            "out_proj": PSpec(mh, None, None)}


def _causal_conv(x, w):
    """Depthwise causal conv along dim 1.  x (B, L, *ch), w (CW, *ch):
    one shifted multiply-add a tap, each rounded in x's dtype."""
    cw, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0) * (x.dim() - 2) + (cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + l] * w[i]
    return out


def _segsum(a):
    """a (..., T) → (..., T, T): Σ_{j<k≤i} a_k below the diagonal, −inf
    above it (a ``where`` before the ``exp``, so the backward of the
    masked entries is 0, not NaN)."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(t, device=a.device)
    return torch.where(i[:, None] >= i[None, :], seg, -torch.inf)


def ssd_chunked(x, dt, a_neg, b, c, chunk: int = _CHUNK,
                return_final_state: bool = False):
    """SSD forward.  x (B, L, H, P), dt (B, L, H) (after softplus),
    a_neg (H,) negative decay rates, b/c (B, L, H, N) (groups already
    broadcast to heads).  Returns y (B, L, H, P) float32, and with
    ``return_final_state`` the final (B, H, P, N) state.  L must divide
    by ``chunk`` (callers pad)."""
    bsz, l, h, p_ = x.shape
    n = b.shape[-1]
    nc = l // chunk
    f32 = torch.float32
    xdt = (x * dt[..., None]).to(f32)                  # dt-premultiplied
    da = (dt * a_neg[None, None, :]).to(f32)           # (B, L, H) ≤ 0
    xc = xdt.reshape(bsz, nc, chunk, h, p_)
    bc = b.to(f32).reshape(bsz, nc, chunk, h, n)
    cc = c.to(f32).reshape(bsz, nc, chunk, h, n)
    dac = da.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)   # (B,H,C,Q)
    da_cum = torch.cumsum(dac, dim=-1)

    # 1. within each chunk: (C Bᵀ ⊙ decay) X
    ldec = torch.exp(_segsum(dac)).permute(0, 2, 1, 3, 4)     # (B,C,H,Q,S)
    scores = torch.einsum("bcqhn,bcshn->bchqs", cc, bc) * ldec
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores, xc)

    # 2. each chunk's own contribution to the state at its end
    decay_states = torch.exp(da_cum[..., -1:] - da_cum)       # (B,H,C,Q)
    xw = xc * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bcshn,bcshp->bchpn", bc, xw)

    # 3. the state entering each chunk, chunk after chunk
    chunk_decay = torch.exp(da_cum[..., -1])                  # (B,H,C)
    carry = x.new_zeros((bsz, h, p_, n), dtype=f32)
    entering = []
    for ci in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[..., ci, None, None] + states[:, ci]
    entering = torch.stack(entering, dim=1)                   # (B,C,H,P,N)

    # 4. the entering state read out with the decay inside the chunk
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", cc, entering) * torch.exp(
        da_cum).permute(0, 2, 3, 1)[..., None]
    y = (y_diag + y_off).reshape(bsz, l, h, p_)
    return (y, carry) if return_final_state else y


def _project(params, u, cfg: ModelConfig):
    """u (B, L, d) → (z, x, B, C raw pre-conv, dt float32 after
    softplus)."""
    z = torch.einsum("bld,dhp->blhp", u, params["wz"])
    x = torch.einsum("bld,dhp->blhp", u, params["wx"])
    b = torch.einsum("bld,dgn->blgn", u, params["wB"])
    c = torch.einsum("bld,dgn->blgn", u, params["wC"])
    dt = F.softplus(torch.einsum("bld,dh->blh", u, params["wdt"]).to(
        torch.float32) + params["dt_bias"])
    return z, x, b, c, dt


def _full(params, u, cfg: ModelConfig):
    """The full-sequence block → (out (B, L, d), final state, raw x, B,
    C)."""
    bsz, l, _ = u.shape
    h, p_ = _hp(cfg)
    z, x_raw, b_raw, c_raw, dt = _project(params, u, cfg)
    x = silu(_causal_conv(x_raw, params["conv_x"]))
    b = silu(_causal_conv(b_raw, params["conv_B"]))
    c = silu(_causal_conv(c_raw, params["conv_C"]))
    rep = h // cfg.ssm_n_groups
    bh = torch.repeat_interleave(b, rep, dim=2)
    ch = torch.repeat_interleave(c, rep, dim=2)

    chunk = cfg.ssm_chunk or _CHUNK
    pad = (-l) % chunk
    if pad:         # dt = 0 on the padding: no decay and no input there
        x, bh, ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, bh, ch))
        dt = F.pad(dt, (0, 0, 0, pad))
    a_neg = -torch.exp(params["A_log"])
    y, state = ssd_chunked(x, dt, a_neg, bh, ch, chunk=chunk,
                           return_final_state=True)
    y = y[:, :l] + params["D"][None, None, :, None] * x[:, :l]
    y = (y.to(cfg.dtype) * silu(z)).reshape(bsz, l, h * p_)
    y = rmsnorm_apply(params["norm"], y, cfg.norm_eps)
    out = torch.einsum("blhp,hpd->bld", y.reshape(bsz, l, h, p_),
                       params["out_proj"])
    return out, state, x_raw, b_raw, c_raw


def mamba_apply(params, u, cfg: ModelConfig):
    """u (B, L, d) → (B, L, d), the full-sequence SSD path (L padded to
    a multiple of the chunk inside)."""
    return _full(params, u, cfg)[0]


def mamba_cache_init(cfg: ModelConfig, batch: int, cache_len: int, device,
                     dtype=None):
    """Zero state (float32) and conv tails (no positions)."""
    h, p_ = _hp(cfg)
    g, n, cw = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_conv
    dt = dict(dtype=dtype or cfg.dtype, device=device)
    return {"state": torch.zeros((batch, h, p_, n), dtype=torch.float32,
                                 device=device),
            "conv_x": torch.zeros((batch, cw - 1, h, p_), **dt),
            "conv_B": torch.zeros((batch, cw - 1, g, n), **dt),
            "conv_C": torch.zeros((batch, cw - 1, g, n), **dt)}


def mamba_cache_pspec(cfg: ModelConfig, axes: Axes):
    mh = shard_or_replicate(_hp(cfg)[0], axes)
    return {"state": PSpec(axes.data_axes, mh, None, None),
            "conv_x": PSpec(axes.data_axes, None, mh, None),
            "conv_B": PSpec(axes.data_axes, None, None, None),
            "conv_C": PSpec(axes.data_axes, None, None, None)}


def _conv_step(tail, xt, w):
    """One conv step: tail (B, CW−1, *ch) and xt (B, *ch) → the window's
    output (B, *ch) (multiplied and summed in float32 and rounded once,
    as XLA fuses the reference's product into its sum); the tail is
    shifted by one in place."""
    full = torch.cat([tail, xt[:, None]], 1)
    out = (full.to(torch.float32) * w.to(torch.float32)).sum(1).to(xt.dtype)
    tail.copy_(full[:, 1:])
    return out


def mamba_decode(params, u, cache, pos, cfg: ModelConfig):
    """u (B, 1, d): one step of the recurrence; writes the state and the
    conv tails into ``cache`` in place and returns (y (B, 1, d),
    cache).  ``pos`` (a 0-d device tensor or an int, as the attentions
    take it) is not read: the state carries the past."""
    bsz = u.shape[0]
    h, p_ = _hp(cfg)
    z, x, b, c, dt = (t[:, 0] for t in _project(params, u, cfg))
    x = silu(_conv_step(cache["conv_x"], x, params["conv_x"]))
    b = silu(_conv_step(cache["conv_B"], b, params["conv_B"]))
    c = silu(_conv_step(cache["conv_C"], c, params["conv_C"]))
    g, n = cfg.ssm_n_groups, cfg.ssm_state
    # each group's B and C repeated for its heads, in repeat_interleave's
    # order
    bh = b[:, :, None].expand(bsz, g, h // g, n).reshape(bsz, h, n).to(
        torch.float32)                                             # (B,H,N)
    ch = c[:, :, None].expand(bsz, g, h // g, n).reshape(bsz, h, n).to(
        torch.float32)

    da = torch.exp(dt * -torch.exp(params["A_log"])[None, :])      # (B,H)
    xf = x.to(torch.float32)
    state = (cache["state"] * da[..., None, None]
             + dt[..., None, None] * xf[..., :, None] * bh[:, :, None, :])
    cache["state"].copy_(state)
    y = (state * ch[:, :, None, :]).sum(-1)                        # (B,H,P)
    y = y + params["D"][None, :, None] * xf
    y = (y.to(cfg.dtype) * silu(z)).reshape(bsz, h * p_)
    y = rmsnorm_apply(params["norm"], y, cfg.norm_eps)
    out = torch.einsum("bhp,hpd->bd", y.reshape(bsz, h, p_),
                       params["out_proj"])
    return out[:, None], cache


def mamba_prefill(params, u, cfg: ModelConfig, cache_len: int = 0):
    """The full-sequence forward and the cache it leaves: the final SSD
    state (the padding past the prompt adds nothing to it) and the last
    cw − 1 raw pre-conv inputs, zero-padded on the left for a prompt
    shorter than that."""
    l, cw = u.shape[1], cfg.ssm_conv
    out, state, x_raw, b_raw, c_raw = _full(params, u, cfg)

    def tail(v):
        vp = F.pad(v, (0, 0) * (v.dim() - 2) + (cw - 1, 0))
        return vp[:, l:l + cw - 1].to(cfg.dtype, copy=True)

    return out, {"state": state, "conv_x": tail(x_raw),
                 "conv_B": tail(b_raw), "conv_C": tail(c_raw)}
