"""Multi-head Latent Attention (port of ``repro.models.mla``; DeepSeek-V3,
arXiv:2412.19437).

Queries and keys/values come through low-rank bottlenecks; the cache
holds only the normalised latent ``c_kv`` (``kv_lora_rank`` wide) and
one rotary key shared by all heads (``qk_rope_head_dim``), not per-head
keys and values.  Training and prefill use the expanded form (per-head
k and v materialised from the latent); the one-token decode uses weight
absorption: ``wk_b`` is folded into the query, the scores are taken
against the cached latent, and ``wv_b`` is applied once after the
attention.

Layouts are the reference's: ``wq_a (d, q_lora)``, ``wq_b (q_lora, H,
nope + rope)``, ``wkv_a (d, kv_lora + rope)``, ``wk_b (kv_lora, H,
nope)``, ``wv_b (kv_lora, H, v)``, ``wo (H, v, d)``; the cache is
``{"ckv" (B, slots, kv_lora), "krope" (B, slots, rope), "pos"
(slots,)}``.  Math runs in ``cfg.dtype`` and rounds where the
reference's einsums round (each einsum's output; the two score terms
added in ``cfg.dtype`` before the float32 softmax).  The decode updates
the cache in place, as ``layers.attn_decode`` does, and every cache
write casts through ``layers.cache_cast`` (XLA's float8 rule).
"""
from __future__ import annotations

import torch

from .common import (Axes, ModelConfig, PSpec, shard_or_replicate,
                     truncated_normal_init)
from .layers import (_NEG, _seq_mask, decode_pos, decode_slot,
                     rmsnorm_apply, rmsnorm_init, rmsnorm_pspec, rope_apply,
                     valid_slots, write_slots)

__all__ = ["mla_init", "mla_pspec", "mla_apply", "mla_cache_init",
           "mla_cache_pspec", "mla_decode", "mla_prefill"]


def _dims(cfg: ModelConfig):
    return (cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank,
            cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim)


def mla_init(cfg: ModelConfig, generator, device):
    h, qr, kvr, dn, dr, dv = _dims(cfg)
    d = cfg.d_model

    def w(shape, scale):
        return truncated_normal_init(shape, cfg.dtype, scale, generator,
                                     device)

    return {"wq_a": w((d, qr), d ** -0.5),
            "q_norm": rmsnorm_init(cfg, device, qr),
            "wq_b": w((qr, h, dn + dr), qr ** -0.5),
            "wkv_a": w((d, kvr + dr), d ** -0.5),
            "kv_norm": rmsnorm_init(cfg, device, kvr),
            "wk_b": w((kvr, h, dn), kvr ** -0.5),
            "wv_b": w((kvr, h, dv), kvr ** -0.5),
            "wo": w((h, dv, d), (h * dv) ** -0.5)}


def mla_pspec(cfg: ModelConfig, axes: Axes):
    mh = shard_or_replicate(cfg.n_heads, axes)
    return {"wq_a": PSpec(None, None), "q_norm": rmsnorm_pspec(cfg, axes),
            "wq_b": PSpec(None, mh, None), "wkv_a": PSpec(None, None),
            "kv_norm": rmsnorm_pspec(cfg, axes),
            "wk_b": PSpec(None, mh, None), "wv_b": PSpec(None, mh, None),
            "wo": PSpec(mh, None, None)}


def _project_q(params, x, cfg: ModelConfig, positions):
    dn = cfg.qk_nope_head_dim
    cq = rmsnorm_apply(params["q_norm"], x @ params["wq_a"], cfg.norm_eps)
    q = torch.einsum("bsq,qhk->bshk", cq, params["wq_b"])
    return q[..., :dn], rope_apply(q[..., dn:], positions, cfg.rope_theta)


def _project_kv_latent(params, x, cfg: ModelConfig, positions):
    """(c_kv (B, S, kv_lora), k_rope (B, S, rope)): the latent and the
    one rotary key all heads share."""
    kvr = cfg.kv_lora_rank
    kv = x @ params["wkv_a"]                                # (B, S, kvr+dr)
    c_kv = rmsnorm_apply(params["kv_norm"], kv[..., :kvr], cfg.norm_eps)
    k_rope = rope_apply(kv[..., None, kvr:], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_full(params, x, cfg: ModelConfig, window: int):
    """The expanded form over a whole sequence → (y, (c_kv, k_rope))."""
    s = x.shape[1]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _project_q(params, x, cfg, positions)
    c_kv, k_rope = _project_kv_latent(params, x, cfg, positions)
    k_nope = torch.einsum("bsc,chk->bshk", c_kv, params["wk_b"])
    v = torch.einsum("bsc,chk->bshk", c_kv, params["wv_b"])
    logits = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
              + torch.einsum("bshk,btk->bhst", q_rope, k_rope)
              ).to(torch.float32) * (dn + dr) ** -0.5
    logits = torch.where(_seq_mask(s, cfg, window, x.device), logits, _NEG)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthk->bshk", w, v)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), (c_kv, k_rope)


def mla_apply(params, x, cfg: ModelConfig, *, window: int = 0):
    """Expanded-form attention for train / prefill; window>0 → sliding."""
    y, _ = _mla_full(params, x, cfg, window)
    return y


def mla_cache_init(cfg: ModelConfig, batch: int, cache_len: int, device,
                   window: int = 0, dtype=None):
    """The latent cache; window>0 → a ring of that many slots."""
    slots = min(window, cache_len) if window > 0 else cache_len
    dt = dtype or cfg.kv_cache_dtype or cfg.dtype
    return {"ckv": torch.zeros((batch, slots, cfg.kv_lora_rank), dtype=dt,
                               device=device),
            "krope": torch.zeros((batch, slots, cfg.qk_rope_head_dim),
                                 dtype=dt, device=device),
            "pos": torch.full((slots,), -1, dtype=torch.int32,
                              device=device)}


def mla_cache_pspec(cfg: ModelConfig, axes: Axes):
    """The latent cache is not head-sharded (MLA's memory win): it is
    replicated over the model axis and sharded on batch."""
    return {"ckv": PSpec(axes.data_axes, None, None),
            "krope": PSpec(axes.data_axes, None, None),
            "pos": PSpec(None)}


def mla_decode(params, x, cache, pos, cfg: ModelConfig, *,
               window: int = 0):
    """Absorbed-form one-token decode at absolute position ``pos`` (a 0-d
    int32 tensor on x's device, or an int; ``layers.attn_decode``'s
    tensor ops, no host read) against the latent cache, which it updates
    in place; returns (y (B, 1, d), cache)."""
    b = x.shape[0]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    pos = decode_pos(pos, x.device)
    positions = pos.reshape(1, 1).expand(b, 1)
    q_nope, q_rope = _project_q(params, x, cfg, positions)    # (B,1,H,·)
    c_kv, k_rope = _project_kv_latent(params, x, cfg, positions)
    ckv, krope, cpos = cache["ckv"], cache["krope"], cache["pos"]
    slot = decode_slot(pos, ckv.shape[1], window)
    write_slots(ckv, slot, c_kv)
    write_slots(krope, slot, k_rope)
    cpos.index_copy_(0, slot, pos.reshape(1).to(cpos.dtype))
    valid = valid_slots(cpos, pos, window)

    # weight absorption: wk_b folded into the query once a step
    q_abs = torch.einsum("bshk,chk->bshc", q_nope, params["wk_b"])
    ckvq = ckv.to(x.dtype)                 # a float8 cache dequantised
    kropeq = krope.to(x.dtype)
    logits = (torch.einsum("bshc,btc->bhst", q_abs, ckvq)
              + torch.einsum("bshk,btk->bhst", q_rope, kropeq)
              ).to(torch.float32) * (dn + dr) ** -0.5
    logits = torch.where(valid[None, None, None, :], logits, _NEG)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    o_c = torch.einsum("bhst,btc->bshc", w, ckvq)             # (B,1,H,kvr)
    out = torch.einsum("bshc,chk->bshk", o_c, params["wv_b"])  # (B,1,H,dv)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache


def mla_prefill(params, x, cfg: ModelConfig, cache_len: int, *,
                window: int = 0):
    """The expanded form over the sequence, and the latent cache it
    leaves: ring caches keep the last ``window`` tokens at slot ``pos %
    window``, full caches are right-padded to ``cache_len`` slots."""
    b, s, _ = x.shape
    y, (c_kv, k_rope) = _mla_full(params, x, cfg, window)
    cache = mla_cache_init(cfg, b, cache_len, x.device, window)
    slots = cache["ckv"].shape[1]
    take = min(s, slots)
    src = torch.arange(take, device=x.device) + (s - take)
    dst = src % slots if window > 0 else src
    write_slots(cache["ckv"], dst, c_kv[:, s - take:])
    write_slots(cache["krope"], dst, k_rope[:, s - take:])
    cache["pos"].index_copy_(0, dst, src.to(torch.int32))
    return y, cache
