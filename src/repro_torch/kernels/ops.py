"""Book-level entry points over the kernels (port of
``repro.kernels.ops``).

Each takes a book (``Codebook`` or ``QLCBook``) and fetches its cached
device tables, so a caller never handles the table layouts.  On CUDA
tensors they launch the kernels (B1 → B2 to encode; B3, B4 or B6 to
decode; B5 to count; B7 or B8 for the fused decode + matmul); on CPU
tensors the wrappers run their plain versions.

The monolithic stream is the reference's kernel path too
(``pack_with_book``): B1, B2 in ``BLOCK``-symbol blocks, and the blocks
merged into one stream by ``merge_block_streams`` — one barrel shift a
block, as torch ops on the stream's device (the reference's merge is a
host loop, not a kernel).  ``recode_with_book`` is a ring hop's encode:
B1 and B2 over blocked symbols, with each segment's padded tail given no
bits.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch

from ..core.encoder import (DEFAULT_CHUNK, _to_int32_bits, chunk_counts_for,
                            concat_chunks, packed_words_capacity, u32_values)
from ..core.qlc import qlc_kernel_args
from .bitpack import pack_blocks
from .decode import decode_chunks_canonical
from .decode import decode_chunks_multisym as _decode_multisym
from .decode import decode_chunks_qlc as _decode_qlc
from .decode_matmul import decode_matmul as _decode_matmul
from .decode_matmul import decode_matmul_qlc as _decode_matmul_qlc
from .encode import encode_lookup
from .histogram import histogram256

__all__ = ["histogram256", "message_bits", "encode_with_book", "BLOCK",
           "recode_with_book", "encode_rows", "encode_monolithic",
           "merge_block_streams", "pack_with_book", "decode_with_book_kernel",
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
    return encode_rows(symbols.reshape(1, -1), lut, chunk=chunk,
                       max_len=book.max_len)


def recode_with_book(sym_blocks: torch.Tensor, n: int, book
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A hop's encode (reference ``recode_chunks_jit``): (R * NB, chunk)
    symbol blocks on one device, each row of NB = ceil(n / chunk) blocks
    holding an ``n``-symbol segment padded to whole chunks → (words
    (R * NB, cap) int32, bits (R * NB,) int32).  B1 then B2 over every
    block at once; the padded tail of each row ships no bits
    (``_zero_tails``), bit-identical to a fresh encode of the unpadded
    segments."""
    chunk = sym_blocks.shape[1]
    (lut,) = book.device_tables("lut", sym_blocks.device)
    codes, lens, _ = encode_lookup(sym_blocks.reshape(-1), lut)
    _zero_tails(codes, lens, -(-n // chunk) * chunk, n)
    return pack_blocks(codes, lens, chunk=chunk, max_len=book.max_len)


def _zero_tails(codes: torch.Tensor, lens: torch.Tensor, width: int,
                n: int) -> None:
    """Give the slots past the first ``n`` of every ``width``-slot row of
    B1's (R * width,) output code and length 0, in place: a padded tail
    then ships no bits.  Only each row's last chunk holds such slots."""
    if n < width:
        codes.view(-1, width)[:, n:] = 0
        lens.view(-1, width)[:, n:] = 0


# Symbols a block of the monolithic kernel path (the reference's
# ``bitpack.BLOCK``).
BLOCK = DEFAULT_CHUNK


def _merge_rows(block_words: torch.Tensor, block_bits: torch.Tensor,
                n_words: int) -> torch.Tensor:
    """(R, NB, cap) block words + (R, NB) bits → (R, n_words) int32: each
    row's blocks stitched into one MSB-first stream.  Block b lands at
    the bit offset of the blocks before it: its words shifted right by
    the offset's bit position, each word's spill into the next; words
    past a block's bits are zero, so the fields are disjoint and add is
    or.  ``n_words`` must hold every row's bits."""
    r, nb, cap = block_words.shape
    dev = block_words.device
    w = u32_values(block_words)
    bits = block_bits.to(torch.int64)
    off = torch.cumsum(bits, dim=1) - bits
    s = (off & 31)[..., None]
    cur = torch.nn.functional.pad(w, (0, 1))          # w[j], w[cap] = 0
    prev = torch.nn.functional.pad(w, (1, 0))         # w[j - 1], w[-1] = 0
    part = ((cur >> s) | (prev << (32 - s))) & 0xFFFFFFFF
    idx = (off >> 5)[..., None] + torch.arange(cap + 1, device=dev)
    out = torch.zeros((r, n_words + 1), dtype=torch.int64, device=dev)
    out.scatter_add_(1, idx.clamp(max=n_words).reshape(r, -1),
                     part.reshape(r, -1))
    return _to_int32_bits(out[:, :n_words])


def merge_block_streams(block_words: torch.Tensor, block_bits: torch.Tensor
                        ) -> Tuple[torch.Tensor, int]:
    """Stitch per-block streams (B2's output) into one contiguous
    MSB-first stream (reference ``merge_block_streams``): returns
    (words (total // 32 + 2,) int32, total bits).  Reads the total back
    to the host to size the stream."""
    total = int(block_bits.to(torch.int64).sum())
    words = _merge_rows(block_words[None], block_bits[None], total // 32 + 2)
    return words[0], total


def pack_with_book(symbols: torch.Tensor, book) -> Tuple[torch.Tensor, int]:
    """The monolithic kernel path (reference ``pack_with_book``): B1 →
    B2 in ``BLOCK``-symbol blocks → merge; returns ``merge_block_streams``'
    (words, total bits), whose words equal ``encode_jit``'s up to its
    capacity."""
    (lut,) = book.device_tables("lut", symbols.device)
    codes, lens, _ = encode_lookup(symbols.reshape(-1), lut)
    words, bits = pack_blocks(codes, lens, chunk=BLOCK, max_len=book.max_len)
    return merge_block_streams(words, bits)


def encode_rows(symbols: torch.Tensor, lut: torch.Tensor, *, chunk: int,
                max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked encode of every row on its own: (R, n) symbols, a (256, 2)
    int32 LUT → (words (R * NB, cap) int32, bits (R * NB,) int32), NB =
    ceil(n / chunk) chunks a row.  One B1 over all rows and one B2; rows
    are padded to whole chunks, and the pad ships no bits."""
    r, n = symbols.shape
    width = max(-(-n // chunk), 1) * chunk
    if r > 1 and width != n:
        symbols = torch.nn.functional.pad(symbols, (0, width - n))
    codes, lens, _ = encode_lookup(symbols.reshape(-1), lut)
    if r > 1:
        _zero_tails(codes, lens, width, n)
    return pack_blocks(codes, lens, chunk=chunk, max_len=max_len)


def encode_monolithic(symbols: torch.Tensor, lut: torch.Tensor, *,
                      max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monolithic encode of every row: (R, n) symbols, a (256, 2) int32
    LUT → (words (R, packed_words_capacity(n)) int32, bits (R,) int32).
    ``encode_rows`` in ``BLOCK``-symbol blocks, then each row's blocks
    merged into one stream; no host sync."""
    r, n = symbols.shape
    words, bits = encode_rows(symbols, lut, chunk=BLOCK, max_len=max_len)
    bits = bits.reshape(r, -1)
    return (_merge_rows(words.reshape(r, bits.shape[1], -1), bits,
                        packed_words_capacity(n, max_len)),
            bits.sum(dim=1, dtype=torch.int32))


def decode_with_book_kernel(stream, book, n_symbols: int, *,
                            chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Decode a kernel-path chunked stream, the (block_words, block_bits)
    pair of B2, back to (n_symbols,) uint8 by the canonical walk (B3);
    the bits are the wire's per-chunk header, unused by the walk."""
    block_words, _ = stream
    counts = chunk_counts_for(n_symbols, chunk)
    out = decode_chunks(block_words, torch.from_numpy(counts).to(
        block_words.device), book, chunk=chunk)
    return concat_chunks(out, counts)


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
