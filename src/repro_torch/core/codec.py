"""Codec registry (port of ``repro.core.codec``): Huffman and QLC.

A ``Codec`` is one entropy-coding strategy for the 256-symbol planes:
how a histogram becomes a book, how a book is rebuilt from its
wire-portable lengths vector, and which decode backends read its
streams.

Backend names are the reference's, so a spec written for the JAX
package carries over unchanged.  The **name** picks the algorithm and
the **device** of the words picks plain torch or the CUDA kernel:

  name              CPU (plain torch)                     CUDA
  multisym,         the K-bit LUT walk                    kernel B4
  multisym_pallas   (``encoder.decode_chunks_multisym``)
  scan, pallas      canonical walk                        kernel B3
                    (``encoder.decode_chunks``)

and for QLC (``core.qlc``):

  scan, pallas      the table-free QLC walk               kernel B6
                    (``qlc.decode_chunks_qlc``)

On the card every name runs a kernel; there is no fallback to the
plain versions there.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .huffman import MAX_CODE_LEN

__all__ = ["Codec", "HuffmanCodec", "QLCCodec", "CODECS", "register_codec",
           "get_codec", "codec_for_book", "default_codec",
           "set_default_codec"]


class Codec:
    """One entropy-coding strategy (book build + decode dispatch)."""

    name: str = "?"
    backends: Tuple[str, ...] = ()
    default_backend: str = "?"

    def resolve_backend(self, backend: str) -> str:
        """Map ``"auto"`` to this codec's default; validate the rest."""
        if backend == "auto":
            return self.default_backend
        if backend not in self.backends:
            raise ValueError(
                f"decode backend {backend!r} not supported by codec "
                f"{self.name!r}; one of {('auto',) + self.backends}")
        return backend

    def build_book(self, counts, *, book_id: int = -1,
                   key: Tuple[str, str, str] = ("", "", ""),
                   max_len: int = MAX_CODE_LEN, floor: int = 1,
                   n_symbols: Optional[int] = None):
        raise NotImplementedError

    def book_from_lengths(self, lengths, *, book_id: int = -1,
                          key: Tuple[str, str, str] = ("", "", ""),
                          max_len: int = MAX_CODE_LEN):
        raise NotImplementedError

    def decode_blocks(self, words, counts, book, chunk: int, backend: str):
        """(NB, cap) int32 words + (NB,) int32 counts → (NB, chunk) int32."""
        raise NotImplementedError

    def decode_plane(self, words, book, n_symbols: int):
        """Monolithic decode: a whole-plane stream of n symbols is one
        chunk of size n (``chunk_capacity_words(n)`` words).  ``words``
        may carry leading dims, (..., cap) → (..., n): every stream is a
        chunk of one launch."""
        lead = words.shape[:-1]
        rows = words.reshape(-1, words.shape[-1])
        counts = torch.full((rows.shape[0],), n_symbols, dtype=torch.int32,
                            device=words.device)
        out = self.decode_blocks(rows, counts, book, n_symbols,
                                 self.default_backend)
        return out.reshape(*lead, n_symbols)


CODECS: Dict[str, Codec] = {}


def register_codec(cls):
    """Class decorator: instantiate and register under ``cls.name``."""
    CODECS[cls.name] = cls()
    return cls


def get_codec(name: str) -> Codec:
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(f"unknown codec {name!r}; "
                         f"registered: {sorted(CODECS)}") from None


def codec_for_book(book) -> Codec:
    """The codec that produced ``book`` (via its ``codec_name`` tag)."""
    return get_codec(getattr(book, "codec_name", "huffman"))


_DEFAULT_CODEC = "huffman"


def default_codec() -> str:
    """The codec name that ``"auto"`` / ``None`` selections resolve to."""
    return _DEFAULT_CODEC


def set_default_codec(name: str) -> str:
    """Retarget the process-wide default codec; returns the previous one.

    Production code selects a codec explicitly (``CompressionSpec.codec``,
    ``codec=`` arguments); this is how a whole run is retargeted."""
    global _DEFAULT_CODEC
    get_codec(name)                      # validate before swapping
    prev = _DEFAULT_CODEC
    _DEFAULT_CODEC = name
    return prev


@register_codec
class HuffmanCodec(Codec):
    """The paper's canonical Huffman code (package-merge lengths,
    canonical codes); ``multisym`` is the default backend, as in the
    reference."""

    name = "huffman"
    backends = ("multisym", "scan", "pallas", "multisym_pallas")
    default_backend = "multisym"

    def build_book(self, counts, *, book_id=-1, key=("", "", ""),
                   max_len=MAX_CODE_LEN, floor=1, n_symbols=None):
        from .codebook import build_codebook
        return build_codebook(counts, book_id=book_id, key=key,
                              max_len=max_len, floor=floor,
                              n_symbols=n_symbols, codec="huffman")

    def book_from_lengths(self, lengths, *, book_id=-1, key=("", "", ""),
                          max_len=MAX_CODE_LEN):
        from .codebook import Codebook
        from .huffman import canonical_codes, canonical_decode_tables
        lv = np.asarray(lengths, dtype=np.int32)
        return Codebook(book_id=book_id, key=tuple(key), lengths=lv,
                        codes=canonical_codes(lv),
                        tables=canonical_decode_tables(lv),
                        source_counts=np.zeros(lv.shape[0], np.int64),
                        max_len=max_len)

    def decode_blocks(self, words, counts, book, chunk, backend):
        from ..kernels import ops
        if self.resolve_backend(backend) in ("scan", "pallas"):
            return ops.decode_chunks(words, counts, book, chunk=chunk)
        return ops.decode_chunks_multisym(words, counts, book, chunk=chunk)


@register_codec
class QLCCodec(Codec):
    """Quad Length Codes: four lengths, 2-leading-bit class, no tables.

    Length assignment is the exhaustive search over the feasible
    non-decreasing 4-tuples (``core.qlc.build_qlc_book``); both backend
    names decode by the table-free walk (kernel B6 on the card)."""

    name = "qlc"
    backends = ("scan", "pallas")
    default_backend = "scan"

    def build_book(self, counts, *, book_id=-1, key=("", "", ""),
                   max_len=MAX_CODE_LEN, floor=1, n_symbols=None):
        from .qlc import build_qlc_book
        return build_qlc_book(counts, book_id=book_id, key=tuple(key),
                              max_len=max_len, floor=floor,
                              n_symbols=n_symbols)

    def book_from_lengths(self, lengths, *, book_id=-1, key=("", "", ""),
                          max_len=MAX_CODE_LEN):
        from .qlc import qlc_book_from_lengths
        return qlc_book_from_lengths(lengths, book_id=book_id,
                                     key=tuple(key), max_len=max_len)

    def decode_blocks(self, words, counts, book, chunk, backend):
        from ..kernels import ops
        self.resolve_backend(backend)
        return ops.decode_chunks_qlc(words, counts, book, chunk=chunk)
