"""Plane encode/decode plumbing and wire factors (the part of
``repro.comm.transport`` that serving needs).

``encode_planes`` splits a tensor into its symbol planes and chunk-codes
each (kernels B1 → B2 on the card); ``decode_blocks`` is the one
codec- and backend-dispatched chunked decode every consumer goes through
(B4 or B3 on the card).  The transports themselves (monolithic, chunked,
ring, and the hierarchical ring) need process groups and wait for
ROADMAP A4.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.codebook import Codebook
from ..core.codec import codec_for_book
from ..core.encoder import DEFAULT_CHUNK
from ..core.symbols import SCHEMES

__all__ = ["RING_FACTORS", "wire_factor", "encode_planes", "decode_blocks"]

# Analytic ring-algorithm egress factors per device (× payload).
RING_FACTORS = {
    "all_reduce": lambda n: 2.0 * (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_gather": lambda n: float(n - 1),
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
}


def wire_factor(op: str, n: int) -> float:
    """Analytic per-device egress factor for ``op`` on an n-ring (the
    reference's ``Transport.wire_factor``, the same for every transport)."""
    return RING_FACTORS[op](n)


def encode_planes(x: torch.Tensor, books: Dict[str, Codebook],
                  scheme_name: str, *, chunk: int = DEFAULT_CHUNK):
    """Split ``x`` into symbol planes and chunk-encode each on ``x``'s
    device.  Returns plane → (words (NB, cap) int32, bits (NB,) int32,
    symbols (n,) uint8)."""
    from ..kernels.ops import encode_with_book
    enc = {}
    for plane, sym in SCHEMES[scheme_name].to_symbols(x).items():
        words, bits = encode_with_book(sym, books[plane], chunk=chunk)
        enc[plane] = (words, bits, sym)
    return enc


def decode_blocks(words: torch.Tensor, counts: torch.Tensor, book: Codebook,
                  chunk: int, backend: str) -> torch.Tensor:
    """(NB, cap) words + (NB,) counts → (NB, chunk) symbol blocks through
    the book's codec, which resolves and validates ``backend``."""
    return codec_for_book(book).decode_blocks(words, counts, book, chunk,
                                              backend)
