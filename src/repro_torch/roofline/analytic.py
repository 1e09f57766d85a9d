"""Analytic (napkin-math) roofline terms per (arch × shape): a copy of
``repro.roofline.analytic`` (with the ``Optional`` import the
reference leaves out), so the port's counts equal the reference's.

The workload's FLOPs and HBM traffic in closed form from the config
and the shape, whatever implements them: the port's only compute and
memory terms (the reference keeps XLA's cost analysis beside them; the
port has none).

Formulas (per device; N_act = active params, T = tokens global):
  matmul FLOPs     fwd = 2·N_act·T;  train = 3×fwd (+1×fwd remat re-fwd)
  attention FLOPs  fwd = 4·B·Σ_layers S·T_eff·H·hd   (qk + av, 2/MAC)
                   T_eff = S/2 causal, min(W, S) windowed, cache at decode
  HBM bytes (train) params 2R + grads W+R + adam m/v R+W (f32) + p update
                   + activations ≈ L·T_dev·d·2B·C_act (C_act ≈ 12, remat)
  HBM bytes (decode) params 1R (batch-shared) + KV cache R+W
  HBM bytes (prefill) params 1R + activations 1W/1R
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..models.common import ModelConfig

__all__ = ["analytic_flops_per_device", "analytic_hbm_bytes_per_device",
           "analytic_terms"]

_C_ACT = 12.0        # activation-traffic coefficient (tensors/layer, remat)


def _attn_layers(cfg: ModelConfig) -> Dict[str, int]:
    full = windowed = 0
    for k in cfg.layer_kinds:
        if k in ("attn", "attn_moe", "mla", "mla_moe"):
            full += 1
        elif k in ("local", "local_moe", "mla_local", "mla_local_moe"):
            windowed += 1
    return {"full": full, "windowed": windowed}


def _attn_dims(cfg: ModelConfig) -> Tuple[int, int]:
    if cfg.use_mla:
        return cfg.n_heads, (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                             + cfg.v_head_dim) // 2
    return cfg.n_heads, cfg.head_dim


def analytic_flops_per_device(cfg: ModelConfig, *, kind: str, seq_len: int,
                              global_batch: int, n_active_params: int,
                              n_devices: int, remat: bool = True) -> float:
    h, hd = _attn_dims(cfg) if cfg.n_heads else (0, 0)
    layers = _attn_layers(cfg)
    w = cfg.sliding_window or seq_len

    if kind == "decode":
        tokens = global_batch                      # one token per request
        t_full, t_win = seq_len, min(w, seq_len)
        s = 1
    else:
        tokens = global_batch * seq_len
        t_full, t_win = seq_len / 2, min(w, seq_len)   # causal average
        s = seq_len

    matmul_fwd = 2.0 * n_active_params * tokens
    attn_fwd = 4.0 * global_batch * s * h * hd * (
        layers["full"] * t_full + layers["windowed"] * t_win)
    fwd = matmul_fwd + attn_fwd
    if kind == "train":
        total = fwd * (4.0 if remat else 3.0)      # +bwd(2×) +remat re-fwd
    else:
        total = fwd
    return total / n_devices


def analytic_hbm_bytes_per_device(cfg: ModelConfig, *, kind: str,
                                  seq_len: int, global_batch: int,
                                  n_params: int, n_devices: int,
                                  model_shards: int, data_shards: int,
                                  cache_bytes_total: float = 0.0,
                                  grad_accum: int = 1,
                                  param_shards: Optional[int] = None,
                                  opt_shards: Optional[int] = None) -> float:
    param_shards = param_shards or model_shards    # fsdp → model×data
    opt_shards = opt_shards or param_shards        # zero1 → model×data
    p_dev = 2.0 * n_params / param_shards          # bf16 params per device
    if kind == "train":
        # fwd read + bwd read (×accum), grad write+read, adam f32 m/v
        # read+write, param f32-ish update write
        param_traffic = p_dev * (2 * grad_accum + 2) + (
            n_params / opt_shards) * (8 + 8 + 8 + 8 + 4)
        toks_dev = global_batch * seq_len / data_shards
        act_traffic = cfg.n_layers * toks_dev * cfg.d_model * 2.0 * _C_ACT
        return param_traffic + act_traffic
    if kind == "prefill":
        toks_dev = global_batch * seq_len / data_shards
        return p_dev + cfg.n_layers * toks_dev * cfg.d_model * 2.0 * 4.0
    # decode: weights stream once (batch amortizes), cache read+write
    return p_dev + 2.0 * cache_bytes_total / n_devices


def analytic_terms(cfg: ModelConfig, *, kind: str, seq_len: int,
                   global_batch: int, n_params: int, n_active_params: int,
                   n_devices: int, model_shards: int, data_shards: int,
                   hw, cache_bytes_total: float = 0.0,
                   grad_accum: int = 1, param_shards: Optional[int] = None,
                   opt_shards: Optional[int] = None) -> Dict[str, float]:
    fl = analytic_flops_per_device(
        cfg, kind=kind, seq_len=seq_len, global_batch=global_batch,
        n_active_params=n_active_params, n_devices=n_devices,
        remat=cfg.remat == "block")
    by = analytic_hbm_bytes_per_device(
        cfg, kind=kind, seq_len=seq_len, global_batch=global_batch,
        n_params=n_params, n_devices=n_devices, model_shards=model_shards,
        data_shards=data_shards, cache_bytes_total=cache_bytes_total,
        grad_accum=grad_accum, param_shards=param_shards,
        opt_shards=opt_shards)
    return {"analytic_flops": fl, "analytic_bytes": by,
            "analytic_compute_s": fl / hw.peak_flops,
            "analytic_memory_s": by / hw.hbm_bw}
