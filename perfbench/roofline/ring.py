"""The least bytes of a coded ring all-reduce over ``n`` ranks on one
card, from its shapes and the coded bits each hop ships (a rank's mean,
``hop_bits[bucket][hop]``), whatever implements it.

- codec: every hop decodes what it receives (each coded bit read once,
  one byte written a symbol) and every shipped stream was encoded once
  (one byte read a symbol, each coded bit written once): n ranks × the
  segment's 2 byte planes a hop;
- the whole sync: a hop reads its coded segment once and writes the
  coded segment it ships once, for every rank; the n − 1 reduce hops
  read the local bf16 addend once; the gathered bf16 output is written
  once.
"""
from __future__ import annotations

from typing import List, Sequence


def _seg(k: int, n: int) -> int:
    return -(-k // n)


def codec_bytes(buckets: Sequence[int], hop_bits: List[List[float]],
                n: int) -> float:
    """Bytes of all the decodes of one sync (the encodes' are equal)."""
    total = 0.0
    for k, hops in zip(buckets, hop_bits):
        sym = n * _seg(k, n) * 2
        total += sum(n * b / 8.0 + sym for b in hops)
    return total


def sync_bytes(buckets: Sequence[int], hop_bits: List[List[float]],
               n: int) -> float:
    total = 0.0
    for k, hops in zip(buckets, hop_bits):
        coded = sum(2.0 * n * b / 8.0 for b in hops)
        addend = (n - 1) * n * _seg(k, n) * 2.0
        total += coded + addend + n * k * 2.0
    return total
