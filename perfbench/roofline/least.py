"""The least work of a served step and a train step, counted from
shapes, whatever implements them.

A served step's bound is the larger of its FLOPs at the bf16 peak and
its least HBM bytes at the HBM peak:

- decode at position ``pos`` (the cache holds ``pos`` earlier slots):
  FLOPs from ``analytic_flops`` with the ``pos + 1`` slots attended;
  bytes: every weight once (an untied input table only for the batch's
  rows), each attention layer's earlier K/V slots read once and the new
  slot written once, each mamba layer's float32 state and conv tails
  read once and written once;
- prefill of ``B × S`` positions, ``S_tok`` of them tokens: FLOPs
  2·(N − tables)·B·S for the body, 2·V·d·B·S_tok for the head over the
  token positions (the input table is a lookup), causal attention
  4·B·S·H·hd·S/2 a layer; bytes: weights once, the caches written once.

The codec's bytes are counted in ``ring.py``.
"""
from __future__ import annotations

from typing import Dict

from .analytic import (analytic_flops, cache_bytes, param_bytes,
                       param_count)
from .peaks import BF16_FLOPS, HBM_BYTES_PER_S


def _table_bytes(m: Dict) -> float:
    return 2.0 * m["vocab_size"] * m["d_model"]


def decode_bytes(m: Dict, batch: int, pos: int) -> float:
    weights = float(param_bytes(m))
    if not m["tie_embeddings"]:        # the input table: a lookup of rows
        weights -= _table_bytes(m) - 2.0 * batch * m["d_model"]
    if m["block"] == "attn":
        slot = 2 * batch * m["n_kv_heads"] * m["head_dim"] * 2
        state = float(slot * (pos + 1) * m["n_layers"])
    else:
        state = 2.0 * cache_bytes(m, batch, 0)
    return weights + state


def decode_flops(m: Dict, batch: int, pos: int) -> float:
    return analytic_flops(m, kind="decode", seq_len=pos + 1,
                          global_batch=batch,
                          n_active_params=param_count(m))


def prefill_flops(m: Dict, batch: int, seq: int, tok: int) -> float:
    vd = m["vocab_size"] * m["d_model"]
    body = param_count(m) - vd * (1 if m["tie_embeddings"] else 2)
    fl = 2.0 * body * batch * seq + 2.0 * vd * batch * tok
    if m["block"] == "attn":
        fl += 4.0 * batch * seq * m["n_heads"] * m["head_dim"] \
            * (seq / 2) * m["n_layers"]
    return fl


def prefill_bytes(m: Dict, batch: int, seq: int, cache_len: int) -> float:
    weights = float(param_bytes(m))
    if not m["tie_embeddings"]:
        weights -= _table_bytes(m) - 2.0 * batch * seq * m["d_model"]
    if m["block"] == "attn":
        written = 2 * batch * seq * m["n_kv_heads"] * m["head_dim"] * 2 \
            * m["n_layers"]
    else:
        written = cache_bytes(m, batch, cache_len)
    return weights + written


def decode_bound_s(m: Dict, batch: int, pos: int) -> float:
    return max(decode_flops(m, batch, pos) / BF16_FLOPS,
               decode_bytes(m, batch, pos) / HBM_BYTES_PER_S)


def prefill_bound_s(m: Dict, batch: int, seq: int, tok: int,
                    cache_len: int) -> float:
    return max(prefill_flops(m, batch, seq, tok) / BF16_FLOPS,
               prefill_bytes(m, batch, seq, cache_len) / HBM_BYTES_PER_S)


def train_flops(m: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of a train step, forward and backward, no
    recomputation counted: 3 × the analytic forward."""
    return analytic_flops(m, kind="train", seq_len=seq, global_batch=batch,
                          n_active_params=param_count(m), remat=False)

