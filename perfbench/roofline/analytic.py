"""Frozen closed-form FLOP and HBM-byte counts of one step on one card.

A copy of the port's ``roofline/analytic.py`` (``analytic_flops_per_device``,
``analytic_hbm_bytes_per_device``) and ``launch/dryrun.py``
``one_card_bound`` at one device, no sharding, written over a cell's
configuration file (a dict of sizes) instead of the program's config
object, so a later change to the program cannot move the yardstick.
``tests/test_perfbench_roofline.py`` pins these numbers to the port's on
every cell's shape.

Formulas (N = parameters, T = tokens, L = layers):
  matmul FLOPs     fwd = 2·N·T; train = 3×fwd (+1×fwd when remat re-runs)
  attention FLOPs  fwd = 4·B·S·H·hd·Σ_layers T_eff
                   T_eff = S/2 causal, the cache's slots at decode
  HBM bytes train  params 2(accum+1)·2N + adam 36·N + L·T·d·2·12
  HBM bytes decode params 2N + 2 × cache bytes
  HBM bytes prefill params 2N + L·T·d·2·4
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

_C_ACT = 12.0
_FULL_ATTN = ("attn",)


def _hp(m: Dict) -> Tuple[int, int]:
    """Mamba heads and head width."""
    return m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"], \
        m["ssm_head_dim"]


def block_leaves(m: Dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(name, shape, bytes an element) of one block of ``m["block"]``."""
    d = m["d_model"]
    out = [("norm_mix.scale", (d,), 4)]
    if m["block"] == "mamba":
        h, p = _hp(m)
        g, n, cw = m["ssm_n_groups"], m["ssm_state"], m["ssm_conv"]
        out += [("wz", (d, h, p), 2), ("wx", (d, h, p), 2),
                ("wB", (d, g, n), 2), ("wC", (d, g, n), 2),
                ("wdt", (d, h), 2), ("dt_bias", (h,), 4),
                ("A_log", (h,), 4), ("D", (h,), 4),
                ("conv_x", (cw, h, p), 2), ("conv_B", (cw, g, n), 2),
                ("conv_C", (cw, g, n), 2), ("norm.scale", (h * p,), 4),
                ("out_proj", (h, p, d), 2)]
        return out
    if m["block"] == "attn":
        hq, kv, hd, ff = (m["n_heads"], m["n_kv_heads"], m["head_dim"],
                          m["d_ff"])
        out += [("wq", (d, hq, hd), 2), ("wk", (d, kv, hd), 2),
                ("wv", (d, kv, hd), 2), ("wo", (hq, hd, d), 2),
                ("norm_ffn.scale", (d,), 4), ("w_gate", (d, ff), 2),
                ("w_up", (d, ff), 2), ("w_down", (ff, d), 2)]
        return out
    raise ValueError(f"no count for block kind {m['block']!r}")


def param_count(m: Dict) -> int:
    per = sum(math.prod(s) for _, s, _ in block_leaves(m))
    embed = m["vocab_size"] * m["d_model"]
    heads = 1 if m["tie_embeddings"] else 2
    return per * m["n_layers"] + heads * embed + m["d_model"]


def param_bytes(m: Dict) -> int:
    """Bytes of every parameter as held (bf16 weights, float32 norms
    and SSM scalars)."""
    per = sum(math.prod(s) * b for _, s, b in block_leaves(m))
    embed = m["vocab_size"] * m["d_model"] * 2
    heads = 1 if m["tie_embeddings"] else 2
    return per * m["n_layers"] + heads * embed + 4 * m["d_model"]


def cache_bytes(m: Dict, batch: int, slots: int) -> float:
    """Bytes of the decode caches: KV slots (k, v bf16, positions
    int32) for attention; the float32 state and bf16 conv tails for
    mamba."""
    if m["block"] == "attn":
        per = 2 * batch * slots * m["n_kv_heads"] * m["head_dim"] * 2 \
            + slots * 4
    else:
        h, p = _hp(m)
        g, n, cw = m["ssm_n_groups"], m["ssm_state"], m["ssm_conv"]
        per = batch * h * p * n * 4 + batch * (cw - 1) * (h * p
                                                          + 2 * g * n) * 2
    return float(per * m["n_layers"])


def analytic_flops(m: Dict, *, kind: str, seq_len: int, global_batch: int,
                   n_active_params: int, remat: bool = True) -> float:
    attn = m["block"] in _FULL_ATTN
    h, hd = (m["n_heads"], m["head_dim"]) if attn else (0, 0)
    full = m["n_layers"] if attn else 0
    if kind == "decode":
        tokens, t_full, s = global_batch, seq_len, 1
    else:
        tokens, t_full, s = global_batch * seq_len, seq_len / 2, seq_len
    matmul_fwd = 2.0 * n_active_params * tokens
    attn_fwd = 4.0 * global_batch * s * h * hd * (full * t_full)
    fwd = matmul_fwd + attn_fwd
    if kind == "train":
        return fwd * (4.0 if remat else 3.0)
    return fwd


def analytic_hbm_bytes(m: Dict, *, kind: str, seq_len: int,
                       global_batch: int, n_params: int,
                       cache_bytes_total: float = 0.0,
                       grad_accum: int = 1) -> float:
    p_dev = 2.0 * n_params
    if kind == "train":
        param_traffic = p_dev * (2 * grad_accum + 2) + n_params * (
            8 + 8 + 8 + 8 + 4)
        act = m["n_layers"] * global_batch * seq_len * m["d_model"] * 2.0 \
            * _C_ACT
        return param_traffic + act
    if kind == "prefill":
        return p_dev + m["n_layers"] * global_batch * seq_len \
            * m["d_model"] * 2.0 * 4.0
    return p_dev + 2.0 * cache_bytes_total


def one_card_bound(m: Dict, *, kind: str, seq_len: int, global_batch: int,
                   grad_accum: int = 1, peak_flops: float = 989e12,
                   hbm_bw: float = 3.35e12) -> Dict[str, float]:
    """``launch/dryrun.py`` ``one_card_bound``'s terms: FLOPs, bytes,
    their times at the peaks and ``bound_s``, the larger."""
    n = param_count(m)
    cb = cache_bytes(m, global_batch, seq_len) if kind == "decode" else 0.0
    fl = analytic_flops(m, kind=kind, seq_len=seq_len,
                        global_batch=global_batch, n_active_params=n,
                        remat=m.get("remat", "block") == "block")
    by = analytic_hbm_bytes(m, kind=kind, seq_len=seq_len,
                            global_batch=global_batch, n_params=n,
                            cache_bytes_total=cb, grad_accum=grad_accum)
    out = {"analytic_flops": fl, "analytic_bytes": by,
           "analytic_compute_s": fl / peak_flops,
           "analytic_memory_s": by / hbm_bw, "n_params": n}
    out["bound_s"] = max(out["analytic_compute_s"], out["analytic_memory_s"])
    return out
