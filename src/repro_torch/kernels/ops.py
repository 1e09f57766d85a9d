"""Book-level entry points over the four kernels (port of
``repro.kernels.ops`` for the wire's path).

Each takes a ``Codebook`` and fetches its cached device tables, so a
caller never handles the LUT layouts.  On CUDA tensors they launch the
kernels (B1 → B2 to encode, B3 or B4 to decode); on CPU tensors the
wrappers run their plain versions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.encoder import DEFAULT_CHUNK
from .bitpack import pack_blocks
from .decode import decode_chunks_canonical
from .decode import decode_chunks_multisym as _decode_multisym
from .encode import encode_lookup

__all__ = ["encode_with_book", "decode_chunks", "decode_chunks_multisym"]


def encode_with_book(symbols: torch.Tensor, book, *,
                     chunk: int = DEFAULT_CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,) uint8 symbols → chunked (words (NB, cap) int32, bits (NB,)
    int32) on the symbols' device: B1 then B2."""
    (lut,) = book.device_tables("lut", symbols.device)
    codes, lens, _ = encode_lookup(symbols, lut)
    return pack_blocks(codes, lens, chunk=chunk, max_len=book.max_len)


def decode_chunks(block_words: torch.Tensor, chunk_counts: torch.Tensor,
                  book, *, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Chunked canonical decode (B3): (NB, cap) words → (NB, chunk)."""
    return decode_chunks_canonical(
        block_words, chunk_counts,
        *book.device_tables("canonical", block_words.device),
        chunk=chunk, max_len=book.max_len)


def decode_chunks_multisym(block_words: torch.Tensor,
                           chunk_counts: torch.Tensor, book, *,
                           chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Chunked multi-symbol decode (B4): (NB, cap) words → (NB, chunk)."""
    dev = block_words.device
    return _decode_multisym(block_words, chunk_counts,
                            *book.device_tables("multisym", dev),
                            *book.device_tables("canonical", dev),
                            chunk=chunk, max_len=book.max_len)
