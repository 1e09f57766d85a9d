"""Book-level entry points over the kernels (port of
``repro.kernels.ops``).

Each takes a book (``Codebook`` or ``QLCBook``) and fetches its cached
device tables, so a caller never handles the table layouts.  On CUDA
tensors they launch the kernels (B1 → B2 to encode; B3, B4 or B6 to
decode; B5 to count; B7 or B8 for the fused decode + matmul); on CPU
tensors the wrappers run their plain versions.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch

from ..core.encoder import DEFAULT_CHUNK
from ..core.qlc import qlc_kernel_args
from .bitpack import pack_blocks
from .decode import decode_chunks_canonical
from .decode import decode_chunks_multisym as _decode_multisym
from .decode import decode_chunks_qlc as _decode_qlc
from .decode_matmul import decode_matmul as _decode_matmul
from .decode_matmul import decode_matmul_qlc as _decode_matmul_qlc
from .encode import encode_lookup
from .histogram import histogram256

__all__ = ["histogram256", "message_bits", "encode_with_book",
           "decode_chunks", "decode_chunks_multisym", "decode_chunks_qlc",
           "decode_matmul", "decode_matmul_prefix", "decode_matmul_tables"]


def message_bits(symbols: torch.Tensor, lengths) -> torch.Tensor:
    """Ledger probe: the exact coded size of ``symbols`` under a book's
    code ``lengths`` (256,), as B5's histogram · lengths — a 0-d int64
    tensor on the symbols' device (the reference returns float32)."""
    hist = histogram256(symbols)
    lens = torch.as_tensor(lengths).to(device=hist.device,
                                       dtype=torch.int64)
    return (hist * lens).sum()


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
    dev = block_words.device
    prefix = (book.device_tables("prefix", dev)[0] if dev.type == "cuda"
              else None)
    return decode_chunks_canonical(
        block_words, chunk_counts, *book.device_tables("canonical", dev),
        chunk=chunk, max_len=book.max_len, prefix=prefix)


def decode_chunks_multisym(block_words: torch.Tensor,
                           chunk_counts: torch.Tensor, book, *,
                           chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Chunked multi-symbol decode (B4): (NB, cap) words → (NB, chunk)."""
    dev = block_words.device
    return _decode_multisym(block_words, chunk_counts,
                            *book.device_tables("multisym", dev),
                            *book.device_tables("canonical", dev),
                            chunk=chunk, max_len=book.max_len)


def decode_chunks_qlc(block_words: torch.Tensor, chunk_counts: torch.Tensor,
                      book, *, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Chunked QLC decode (B6): (NB, cap) words → (NB, chunk)."""
    return _decode_qlc(block_words, chunk_counts,
                       *qlc_kernel_args(book, block_words.device),
                       chunk=chunk, max_len=book.max_len)


def decode_matmul(x: torch.Tensor, lo_words: torch.Tensor,
                  hi_words: torch.Tensor, chunk_counts: torch.Tensor,
                  books: Mapping[str, object], *, chunk: int, n_cols: int,
                  tiles: bool = False):
    """Fused coded-weight matmul: x @ W from W's coded byte planes.

    lo/hi_words are (NB, cap) chunked streams of W (K, N) flattened
    row-major; books = {"lo": book, "hi": book}, both of one codec and
    one ``max_len``.  Dispatches on the books' ``codec_name`` to B7
    (Huffman) or B8 (QLC).  Returns (M, n_cols) float32 (and, with
    ``tiles=True``, the decoded weight (NB, chunk) bf16).
    """
    lo_b, hi_b = books["lo"], books["hi"]
    name = getattr(lo_b, "codec_name", "huffman")
    if getattr(hi_b, "codec_name", "huffman") != name:
        raise ValueError("decode_matmul: lo/hi books use different codecs")
    if lo_b.max_len != hi_b.max_len:
        raise ValueError("decode_matmul: lo/hi books disagree on max_len")
    if chunk % n_cols != 0:
        raise ValueError(f"chunk {chunk} not a multiple of n_cols {n_cols}")
    dev = lo_words.device
    fn, kw = _decode_matmul_qlc, {}
    if name != "qlc":
        fn = _decode_matmul
        if dev.type == "cuda":
            kw["prefix"] = decode_matmul_prefix(books, dev)
    return fn(x, lo_words, hi_words, chunk_counts,
              *decode_matmul_tables(books, dev), chunk=chunk, n_cols=n_cols,
              max_len=lo_b.max_len, tiles=tiles, **kw)


def decode_matmul_prefix(books: Mapping[str, object], device) -> Tuple:
    """B7's (lo, hi) one-lookup tables, each book's cached copy on
    ``device``."""
    return tuple(books[p].device_tables("prefix", device)[0]
                 for p in ("lo", "hi"))


def decode_matmul_tables(books: Mapping[str, object], device) -> Tuple:
    """The two books' tables as B7 / B8 take them, on ``device``:
    Huffman — first_code, base_index, num_codes (2, max_len + 1) and
    sorted_symbols (2, 256) int32; QLC — [lo, hi] len_packs and
    base_packs and sym_tabs (2, 256) int32."""
    lo_b, hi_b = books["lo"], books["hi"]
    if getattr(lo_b, "codec_name", "huffman") == "qlc":
        (lo_lp, lo_bp, lo_st), (hi_lp, hi_bp, hi_st) = (
            qlc_kernel_args(b, device) for b in (lo_b, hi_b))
        return [lo_lp, hi_lp], [lo_bp, hi_bp], torch.stack([lo_st, hi_st])
    tabs = [b.device_tables("canonical", device) for b in (lo_b, hi_b)]
    ss = torch.zeros((2, 256), dtype=torch.int32, device=device)
    for p, t in enumerate(tabs):
        ss[p, :t[3].numel()] = t[3]
    return (*(torch.stack([tabs[0][i], tabs[1][i]]) for i in range(3)), ss)
