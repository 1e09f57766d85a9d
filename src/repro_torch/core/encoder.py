"""Chunked wire format, plain-torch codecs and the encode/decode entry
points (port of ``repro.core.encoder``).

Wire format (the contract with the reference, bit for bit): a plane of
n uint8 symbols is cut into chunks of ``chunk`` symbols (the last may be
short); each chunk packs its canonical codewords MSB-first into
big-endian 32-bit words, ``chunk_capacity_words(chunk)`` words per
chunk with the slack zeroed, plus the chunk's bit count as its header.

Words are held as **int32 bit patterns** (CPU torch has no uint32
arithmetic); packing works in int64, and a consumer that needs the
unsigned words converts at the boundary with
``words.numpy().view(np.uint32)``.

The functions here are the plain-torch formulations — the CPU path and
the oracles the CUDA kernels are held to on the card:

  encode_jit / decode_jit — the monolithic path: one stream a plane,
      ``packed_words_capacity(n)`` words (B1 → B2 → merge and a
      one-chunk walk on the card, ``pack_rows`` on one row and the
      canonical walk on the CPU);
  pack_rows / encode_chunked_rows / recode_chunks — the ``_pack_rows``
      bit-pack core (reference ``encode_chunked_jit``,
      ``recode_chunks_jit``);
  decode_chunks           — the canonical walk (``decode_chunks_jit``);
  decode_chunks_multisym  — the K-bit window-LUT multisym decode
      (``decode_chunks_multisym_jit``, by B4's algorithm).

Both decoders take each step's code from the window at its cursor, as
the kernels do.  They first resolve every 16-bit window once (a 2^16
table) and find the code length at every bit position of a chunk, all
at once, and then walk the chain of code starts with one gather a step
(``_walk_positions``, which jumps on long chunks), where a step of a loop
that searched at the cursor took some thirty tensor operations.
The entry points ``encode_chunked`` / ``decode_chunked`` /
``decode_dispatch`` go through ``repro_torch.kernels``, whose wrappers
launch the CUDA kernels for tensors on the card and run these plain
versions for tensors on the CPU.  ``three_stage_encode`` (scan, build,
encode) and ``single_stage_encode`` (a fixed book, one pass) are the two
encoders the paper compares, and ``encoded_size_bits`` the ledger's
size.  ``encode_np`` / ``decode_np`` are the pure-Python oracles.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .huffman import MAX_CODE_LEN

__all__ = [
    "DEFAULT_CHUNK", "ChunkedStream", "EncodeResult",
    "packed_words_capacity", "encode_jit", "decode_jit", "decode_with_book",
    "chunk_capacity_words", "chunk_counts_for", "concat_chunks",
    "u32_values", "walk_symbols", "canonical_first_code",
    "canonical_window_tables",
    "pack_rows", "encode_chunked_rows", "recode_chunks",
    "decode_chunks", "decode_chunks_multisym",
    "encode_chunked", "decode_chunked", "decode_dispatch",
    "encode_np", "decode_np",
    "three_stage_encode", "single_stage_encode", "encoded_size_bits",
]

# Symbols per chunk of the chunked wire format (reference DEFAULT_CHUNK,
# and the reference Pallas pack kernel's BLOCK).
DEFAULT_CHUNK = 2048

_U32 = 0xFFFFFFFF


def chunk_capacity_words(chunk: int, max_len: int = MAX_CODE_LEN) -> int:
    """Worst-case uint32 words per chunk (+1 pad word for window reads).

    Ceiling division, as in the reference: an odd chunk keeps a true
    pad word, so a decoder clamping its two-word window fetch to
    ``cap - 2`` never misreads the final codewords.  1025 at chunk 2048.
    """
    return (chunk * max_len + 31) // 32 + 1


def packed_words_capacity(n_symbols: int, max_len: int = MAX_CODE_LEN) -> int:
    """Worst-case uint32 words of a monolithic n-symbol stream (+1 pad
    word for window reads): ``chunk_capacity_words(n_symbols)``, so a
    monolithic stream is one chunk of n symbols to every decoder."""
    return (n_symbols * max_len + 31) // 32 + 1


def chunk_counts_for(n_symbols: int, chunk: int) -> np.ndarray:
    """Symbols per chunk for an n-symbol stream: all full except the tail."""
    nb = max((n_symbols + chunk - 1) // chunk, 1)
    counts = np.full(nb, chunk, dtype=np.int32)
    counts[-1] = n_symbols - (nb - 1) * chunk
    return counts


def concat_chunks(blocks: torch.Tensor, chunk_counts: np.ndarray
                  ) -> torch.Tensor:
    """(NB, chunk) padded symbol blocks → flat (Σcounts,) uint8."""
    counts = np.asarray(chunk_counts)
    if int(counts[-1]) == blocks.shape[1]:
        return blocks.reshape(-1).to(torch.uint8)
    head = blocks[:-1].reshape(-1)
    tail = blocks[-1, : int(counts[-1])]
    return torch.cat([head, tail]).to(torch.uint8)


def _to_int32_bits(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → the int32 tensor with the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def u32_values(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → their unsigned values, as int64."""
    return words.to(torch.int64) & _U32


# --------------------------------------------------------------------------
# Bit packing
# --------------------------------------------------------------------------
def pack_rows(v: torch.Tensor, l: torch.Tensor, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared bit-pack core: per-row MSB-first packing via two masked shifts.

    v: (NB, C) right-aligned codewords, l: (NB, C) lengths (0 ⇒ the slot
    contributes no bits), both integer.  Returns (words (NB, cap) int32
    bit patterns, bits (NB,) int32).  A codeword of length ≤ 16 starting
    at bit offset o spans at most two words; the high and low parts are
    scatter-added, and since the fields are disjoint, add ≡ or.
    """
    nb = v.shape[0]
    dev = v.device
    if v.shape[1] == 0:
        return (torch.zeros((nb, cap), dtype=torch.int32, device=dev),
                torch.zeros((nb,), dtype=torch.int32, device=dev))
    v = v.to(torch.int64)
    l = l.to(torch.int64)
    ends = torch.cumsum(l, dim=1)
    offs = ends - l                                  # exclusive prefix sum
    bits = ends[:, -1].to(torch.int32)
    pos = offs & 31                                  # bit position in word
    idx = offs >> 5                                  # word index in row
    # sh = 32 - pos - l: the left shift that puts the code's end at the
    # word's end.  Negative sh: the low |sh| bits spill into word + 1.
    sh = 32 - pos - l
    hi = torch.where(sh >= 0, v << sh.clamp(0, 31), v >> (-sh).clamp(0, 31))
    lo = torch.where(sh < 0, (v << (32 + sh).clamp(0, 31)) & _U32,
                     torch.zeros_like(v))
    flat = (torch.arange(nb, device=dev)[:, None] * cap + idx).reshape(-1)
    # One spare slot: a zero-length tail entry after a chunk filled to
    # its last payload word indexes word cap of the last row.
    words = torch.zeros(nb * cap + 1, dtype=torch.int64, device=dev)
    words.scatter_add_(0, flat, hi.reshape(-1))
    words.scatter_add_(0, flat + 1, lo.reshape(-1))
    return _to_int32_bits(words[: nb * cap].reshape(nb, cap)), bits


def encode_chunked_rows(symbols: torch.Tensor, codes: torch.Tensor,
                        lengths: torch.Tensor, chunk: int = DEFAULT_CHUNK,
                        max_len: int = MAX_CODE_LEN
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain chunked encode (reference ``encode_chunked_jit``).

    symbols (N,) uint8/int, codes/lengths (256,) integer tables →
    (block_words (NB, cap) int32, block_bits (NB,) int32).  Tail
    positions past N get length 0 and contribute no bits.
    """
    n = symbols.shape[0]
    nb = max((n + chunk - 1) // chunk, 1)
    sym = torch.zeros(nb * chunk, dtype=torch.int64, device=symbols.device)
    sym[:n] = symbols.reshape(-1).to(torch.int64)
    sym = sym.reshape(nb, chunk)
    valid = (torch.arange(nb * chunk, device=symbols.device) < n
             ).reshape(nb, chunk)
    v = codes.to(torch.int64)[sym] * valid
    l = lengths.to(torch.int64)[sym] * valid
    return pack_rows(v, l, chunk_capacity_words(chunk, max_len))


def recode_chunks(sym_blocks: torch.Tensor, chunk_counts: torch.Tensor,
                  codes: torch.Tensor, lengths: torch.Tensor,
                  max_len: int = MAX_CODE_LEN
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-encode already-blocked symbols (reference ``recode_chunks_jit``):
    (NB, chunk) symbols + (NB,) counts → the chunked stream, bit-identical
    to ``encode_chunked_rows`` on the equivalent flat stream."""
    nb, chunk = sym_blocks.shape
    sym = sym_blocks.to(torch.int64)
    valid = (torch.arange(chunk, device=sym.device)[None, :]
             < chunk_counts.to(torch.int64)[:, None])
    v = codes.to(torch.int64)[sym] * valid
    l = lengths.to(torch.int64)[sym] * valid
    return pack_rows(v, l, chunk_capacity_words(chunk, max_len))


# --------------------------------------------------------------------------
# Decoders: the walk of each chunk, one gather a step
# --------------------------------------------------------------------------
# Bit positions of a chunk at which a code may start: every payload bit
# lies below chunk * max_len <= 32 * (cap - 1), and a window read there
# never reaches the ``cap - 2`` clamp of the reference's two-word fetch.
# Rows are walked in batches of at most this many positions, and a walk
# takes at most this many dependent steps (longer chunks jump).
_WALK_POSITIONS = 1 << 24
_WALK_STEPS = 4096


def _windows_at_every_bit(w: torch.Tensor) -> torch.Tensor:
    """(NB, cap) unsigned words as int64 → (NB, 32 * (cap - 1)): the 16
    stream bits starting at every bit position a code may start at.
    Each half-word h of a row, with the half after it, holds 32 stream
    bits; the window at bit 16 h + j is their top 16 bits after j."""
    halves = torch.stack([w >> 16, w & 0xFFFF], dim=2).reshape(
        w.shape[0], -1)                                   # (NB, 2 cap)
    pairs = (halves[:, :-2] << 16) | halves[:, 1:-1]      # (NB, 2 cap - 2)
    shift = 16 - torch.arange(16, device=w.device)
    return ((pairs[:, :, None] >> shift) & 0xFFFF).reshape(w.shape[0], -1)


def _walk_positions(advance: torch.Tensor, steps: int) -> torch.Tensor:
    """The start positions of the first ``steps`` codes of every row,
    given each bit position's code length ``advance`` (NB, P) int64:
    s_0 = 0, s_{k+1} = s_k + advance[s_k], every row in lockstep, one
    gather a step.  A walk longer than ``_WALK_STEPS`` first squares the
    jump table (J_2 = J ∘ J, …) until 2^d-code jumps bring it under, takes
    those, then fills in the codes between them all at once: 2^d − 1
    gathers over every jump's start.  Jumps clamp at P - 1: only
    positions past a row's last code reach it."""
    nb, n_pos = advance.shape
    nxt = torch.clamp(torch.arange(n_pos, device=advance.device)[None, :]
                      + advance, max=n_pos - 1)
    jump, span = nxt, 1
    while -(-steps // span) > _WALK_STEPS:
        jump, span = jump.gather(1, jump), 2 * span
    n_jumps = -(-steps // span)
    pos = torch.zeros((nb, span, n_jumps), dtype=torch.int64,
                      device=advance.device)
    for m in range(1, n_jumps):
        pos[:, 0, m:m + 1] = jump.gather(1, pos[:, 0, m - 1:m])
    for j in range(1, span):
        pos[:, j] = nxt.gather(1, pos[:, j - 1])
    return pos.transpose(1, 2).reshape(nb, -1)[:, :steps]


def _row_batches(nb: int, cap: int):
    per = max(1, _WALK_POSITIONS // (32 * max(cap - 1, 1)))
    return [(r, min(r + per, nb)) for r in range(0, nb, per)]


def _walk_windows(block_words: torch.Tensor, chunk: int,
                  advance16: torch.Tensor):
    """Walk every chunk: yields (first row, last row + 1, the 16-bit
    windows at each row's first ``chunk`` code starts) per batch of rows.
    ``advance16`` (2^16,) int64 maps a window to the bits its step
    consumes."""
    nb, cap = block_words.shape
    for a, b in _row_batches(nb, cap):
        win = _windows_at_every_bit(u32_values(block_words[a:b]))
        pos = _walk_positions(advance16[win], chunk)
        yield a, b, win.gather(1, pos)


def walk_symbols(block_words: torch.Tensor, chunk_counts: torch.Tensor,
                 chunk: int, advance16: torch.Tensor, symbol_at
                 ) -> torch.Tensor:
    """The walk of a one-symbol-a-step decoder over every chunk: each
    step reads the 16-bit window at its cursor, emits ``symbol_at`` of it
    and advances by ``advance16`` of it.  block_words (NB, cap) int32,
    chunk_counts (NB,) → (NB, chunk) int32, zero past each count."""
    nb = block_words.shape[0]
    dev = block_words.device
    out = torch.zeros((nb, chunk), dtype=torch.int32, device=dev)
    live = (torch.arange(chunk, device=dev)[None, :]
            < chunk_counts.to(torch.int64)[:, None])
    for a, b, win in _walk_windows(block_words, chunk, advance16):
        out[a:b] = torch.where(live[a:b], symbol_at(win), 0).to(torch.int32)
    return out


def canonical_first_code(window: torch.Tensor, fc: torch.Tensor,
                         bi: torch.Tensor, nc: torch.Tensor,
                         ss: torch.Tensor, ls: torch.Tensor, max_len: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical-prefix search over candidate lengths ``ls`` for the
    ``max_len``-bit windows (N,): (length, symbol) of each window's
    first code — the smallest valid length, or ``ls[0]`` if none is."""
    cand = window[:, None] >> (max_len - ls)[None, :]
    off = cand - fc[ls][None, :]
    valid = (off >= 0) & (off < nc[ls][None, :])
    li = valid.to(torch.int32).argmax(dim=1)
    l = ls[li]
    o = off.gather(1, li[:, None])[:, 0]
    sym = ss[torch.clamp(bi[l] + o, 0, ss.shape[0] - 1)]
    return l, sym


def canonical_window_tables(tables, lo: int, max_len: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``canonical_first_code`` over lengths lo..max_len for every
    max_len-bit window: (length, symbol) tables of 2^max_len entries."""
    fc, bi, nc, ss = (t.to(torch.int64) for t in tables)
    ls = torch.arange(lo, max_len + 1, device=fc.device)
    wins = torch.arange(1 << max_len, device=fc.device)
    return canonical_first_code(wins, fc, bi, nc, ss, ls, max_len)


# Bits of B7's one-lookup table: 2^12 entries of (symbol, length), 8 KB
# a book as int16.
PREFIX_BITS = 12


def canonical_prefix_table(tables, max_len: int, k: int = PREFIX_BITS
                           ) -> torch.Tensor:
    """B7's one-lookup table for one book: (2^k,) int16, on the tables'
    device.  Entry p is ``symbol | length << 8`` of the first code of
    every max_len-bit window whose top k bits are p, as
    ``canonical_first_code`` over lengths 1..max_len gives it with
    sorted_symbols padded to 256 (the kernel's search), wherever the top
    k bits decide it; 0 where they do not (the first code is longer than
    k bits), which sends the kernel to that search.  With max_len ≤ k
    every entry is decided, the no-valid-length fallback included."""
    fc, bi, nc, ss = (t.to(torch.int64) for t in tables)
    ss = torch.nn.functional.pad(ss.reshape(-1), (0, 256 - ss.numel()))
    p = torch.arange(1 << k, device=fc.device)
    win = p << (max_len - k) if max_len >= k else p >> (k - max_len)
    short = torch.arange(1, min(k, max_len) + 1, device=fc.device)
    l, sym = canonical_first_code(win, fc, bi, nc, ss, short, max_len)
    off = (win >> (max_len - l)) - fc[l]
    decided = (off >= 0) & (off < nc[l])
    if max_len <= k:
        decided = torch.ones_like(decided)
    return torch.where(decided, sym | (l << 8), 0).to(torch.int16)


def decode_chunks(block_words: torch.Tensor, chunk_counts: torch.Tensor,
                  first_code: torch.Tensor, base_index: torch.Tensor,
                  num_codes: torch.Tensor, sorted_symbols: torch.Tensor,
                  chunk: int = DEFAULT_CHUNK, max_len: int = MAX_CODE_LEN
                  ) -> torch.Tensor:
    """Canonical walk over every chunk (reference ``decode_chunks_jit``,
    the function of kernel B3).

    block_words (NB, cap) int32, chunk_counts (NB,) int32 → (NB, chunk)
    int32 symbols, zero past each chunk's count.  Each step reads a
    max_len-bit window at the cursor, finds the unique code length,
    emits ``sorted_symbols[base_index[l] + offset]`` and advances; the
    steps are taken by ``_walk_positions``, with each window's (length,
    symbol) from a 2^max_len table of the canonical search.
    """
    ltab, stab = canonical_window_tables(
        (first_code, base_index, num_codes, sorted_symbols), 1, max_len)
    top = torch.arange(1 << 16, device=ltab.device) >> (16 - max_len)
    return walk_symbols(block_words, chunk_counts, chunk, ltab[top],
                        lambda win: stab[win >> (16 - max_len)])


def decode_chunks_multisym(block_words: torch.Tensor,
                           chunk_counts: torch.Tensor, syms: torch.Tensor,
                           meta: torch.Tensor, first_code: torch.Tensor,
                           base_index: torch.Tensor, num_codes: torch.Tensor,
                           sorted_symbols: torch.Tensor,
                           chunk: int = DEFAULT_CHUNK,
                           max_len: int = MAX_CODE_LEN) -> torch.Tensor:
    """Multi-symbol K-bit window-LUT decode (reference
    ``decode_chunks_multisym_jit`` / ``decode_chunks_multisym_pallas``;
    the algorithm of kernel B4).

    (NB, cap) int32 words, (NB,) counts, the (2^k, s_max) symbol LUT and
    (2^k,) ``count | bits << 8`` meta, and the canonical tables →
    (NB, chunk) int32, zero past each count.  Each step reads the K-bit
    window at the cursor and emits its LUT symbols — or, for a first
    code longer than K bits, the canonical search's one symbol — and
    advances by its bits; the steps are taken by ``_walk_positions``
    (every step emits at least one symbol, so ``chunk`` steps cover a
    chunk), and each step's symbols land at the running sum of the
    counts before it.
    """
    nb = block_words.shape[0]
    dev = block_words.device
    size, s_max = syms.shape
    k = size.bit_length() - 1
    stab = syms.to(torch.int64)
    mtab = meta.to(torch.int64)
    if k < max_len:                 # windows whose first code is longer
        slow_l, slow_s = canonical_window_tables(
            (first_code, base_index, num_codes, sorted_symbols), k + 1,
            max_len)
    else:                           # every code fits a window: no slow path
        slow_l = slow_s = torch.zeros(1 << max_len, dtype=torch.int64,
                                      device=dev)
    js = torch.arange(s_max, device=dev)
    w16 = torch.arange(1 << 16, device=dev)
    m16 = mtab[w16 >> (16 - k)]
    slow16 = (m16 & 0xFF) == 0
    advance16 = torch.where(slow16, slow_l[w16 >> (16 - max_len)],
                            (m16 >> 8) & 0xFF)
    count16 = torch.where(slow16, 1, m16 & 0xFF)

    out = torch.zeros((nb, chunk), dtype=torch.int32, device=dev)
    counts = chunk_counts.to(torch.int64)
    for a, b, win in _walk_windows(block_words, chunk, advance16):
        cnt, slow = count16[win], slow16[win]
        emit = torch.where(
            slow[..., None],
            torch.where(js == 0, slow_s[win >> (16 - max_len)][..., None], 0),
            stab[win >> (16 - k)])                          # (rows, chunk, s)
        dst = (torch.cumsum(cnt, dim=1) - cnt)[..., None] + js
        keep = (js < cnt[..., None]) & (dst < counts[a:b, None, None])
        rows = torch.arange(b - a, device=dev)[:, None, None].expand_as(dst)
        out[a:b][rows[keep], dst[keep]] = emit[keep].to(torch.int32)
    return out


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------
# Symbols a monolithic call may hold (the reference's cap).
_MAX_SYMBOLS = 1 << 26


def _int_table(a, device) -> torch.Tensor:
    """A code or length table (numpy, possibly uint32, or a tensor) as
    int64 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


@dataclass
class EncodeResult:
    """One monolithic stream: ``packed_words_capacity(n)`` words."""
    words: torch.Tensor         # (capacity,) int32 bit patterns
    n_bits: torch.Tensor        # () int32, the payload's true size
    n_symbols: int
    book_id: int = -1

    def payload_bytes(self) -> float:
        return float(self.n_bits) / 8.0


def encode_jit(symbols: torch.Tensor, codes, lengths,
               max_len: int = MAX_CODE_LEN
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monolithic encode (reference ``encode_jit``): (N,) symbols through
    the (codes, lengths) tables into one MSB-first stream, on the
    symbols' device.  Returns (words (packed_words_capacity(N),) int32,
    n_bits () int32).  It runs the reference's kernel path
    (``kernels.ops.encode_monolithic``: B1, B2 in 2048-symbol blocks,
    then the blocks merged into one stream), whose wrappers run their
    plain versions on the CPU."""
    from ..kernels.ops import encode_monolithic
    sym = torch.as_tensor(symbols).reshape(1, -1)
    if sym.shape[1] > _MAX_SYMBOLS:
        raise ValueError(f"chunk too large: {sym.shape[1]} > {_MAX_SYMBOLS}")
    lut = torch.stack([_int_table(codes, sym.device),
                       _int_table(lengths, sym.device)], dim=1)
    words, bits = encode_monolithic(sym, _to_int32_bits(lut),
                                    max_len=max_len)
    return words[0], bits[0]


def decode_jit(words: torch.Tensor, first_code, base_index, num_codes,
               sorted_symbols, n_symbols: int, max_len: int = MAX_CODE_LEN
               ) -> torch.Tensor:
    """Monolithic canonical decode (reference ``decode_jit``): the
    stream is one chunk of ``n_symbols`` (kernel B3 on the card, the
    plain canonical walk on the CPU).  Returns (n_symbols,) uint8."""
    from ..kernels.decode import decode_chunks_canonical
    dev = words.device
    if n_symbols == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    tables = [_int_table(t, dev).to(torch.int32)
              for t in (first_code, base_index, num_codes, sorted_symbols)]
    counts = torch.full((1,), n_symbols, dtype=torch.int32, device=dev)
    out = decode_chunks_canonical(words.reshape(1, -1).contiguous(), counts,
                                  *tables, chunk=n_symbols, max_len=max_len)
    return out.reshape(-1).to(torch.uint8)


def decode_with_book(words: torch.Tensor, book, n_symbols: int
                     ) -> torch.Tensor:
    """Monolithic decode of one plane's stream through the book's codec."""
    from .codec import codec_for_book
    return codec_for_book(book).decode_plane(words, book, n_symbols)


@dataclass
class ChunkedStream:
    """A Huffman bitstream cut into independently decodable chunks.

    block_words[b] holds chunk b's MSB-first packed words as int32 bit
    patterns (word-aligned start, slack zeroed); block_bits[b] is its
    true payload size — the per-chunk header a receiver reads first.
    """
    block_words: torch.Tensor   # (NB, cap) int32
    block_bits: torch.Tensor    # (NB,) int32
    n_symbols: int
    chunk: int
    book_id: int = -1

    @property
    def n_chunks(self) -> int:
        return self.block_words.shape[0]

    def chunk_counts(self) -> np.ndarray:
        return chunk_counts_for(self.n_symbols, self.chunk)


def encode_chunked(symbols, book, *, chunk: int = DEFAULT_CHUNK,
                   device=None) -> ChunkedStream:
    """Single-stage encode into the chunked wire format.

    Runs on ``device`` (CUDA unless named): the codebook lookup (kernel
    B1) and then the per-chunk pack (kernel B2), two launches; on the
    CPU both wrappers run their plain versions.
    """
    from ..kernels.ops import encode_with_book
    dev = resolve_device(device)
    sym = torch.as_tensor(symbols).reshape(-1).to(device=dev,
                                                  dtype=torch.uint8)
    words, bits = encode_with_book(sym, book, chunk=chunk)
    return ChunkedStream(block_words=words, block_bits=bits,
                         n_symbols=int(sym.shape[0]), chunk=chunk,
                         book_id=book.book_id)


def decode_chunked(stream: ChunkedStream, book, *,
                   backend: str = "auto") -> torch.Tensor:
    """Decode a ChunkedStream back to its uint8 symbols, on the device
    its words lie on.  ``"auto"`` means the canonical walk here (the
    reference entry point's ``pallas`` contract); spec-level ``"auto"``
    resolves to the codec's default instead."""
    from .codec import codec_for_book
    counts = torch.from_numpy(stream.chunk_counts()).to(
        stream.block_words.device)
    out = codec_for_book(book).decode_blocks(
        stream.block_words, counts, book, stream.chunk,
        "pallas" if backend == "auto" else backend)
    return concat_chunks(out, stream.chunk_counts())


def decode_dispatch(stream, book, n_symbols: Optional[int] = None, *,
                    backend: str = "auto") -> torch.Tensor:
    """Route a stream to the right decoder: a ChunkedStream to the
    chunked decode; a monolithic word buffer (``chunk_capacity_words(n)``
    words) to the book's codec as one chunk of ``n_symbols``."""
    from .codec import codec_for_book
    if isinstance(stream, ChunkedStream):
        return decode_chunked(stream, book, backend=backend)
    if n_symbols is None:
        raise ValueError("monolithic decode needs n_symbols")
    return codec_for_book(book).decode_plane(stream, book, n_symbols).to(
        torch.uint8)


# --------------------------------------------------------------------------
# The two encoder designs the paper compares
# --------------------------------------------------------------------------
def three_stage_encode(symbols, *, n_alphabet: int = 256,
                       max_len: int = MAX_CODE_LEN, device=None):
    """Baseline: scan → build codebook → encode, on ``device`` (CUDA
    unless named).  The scan is kernel B5 and one read of its counts, the
    build the host's, the encode ``encode_jit`` (B1 → B2 → merge; each
    wrapper's plain version on the CPU).  Returns (EncodeResult,
    Codebook, stage seconds): ``freq_scan_s``, ``tree_build_s``,
    ``encode_s`` (a stage on the card ends in a synchronize), and
    ``wire_bits``, the payload plus the book that must ride with it
    (a lengths vector, ``n_alphabet`` bytes)."""
    from ..kernels.histogram import histogram256
    from .codebook import build_codebook
    dev = resolve_device(device)
    sym = torch.as_tensor(symbols).reshape(-1).to(device=dev,
                                                  dtype=torch.uint8)

    def now() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = now()
    counts = histogram256(sym)[:n_alphabet].cpu().numpy()
    t1 = now()
    book = build_codebook(counts, max_len=max_len)
    t2 = now()
    words, n_bits = encode_jit(sym, book.codes, book.lengths, max_len=max_len)
    t3 = now()
    res = EncodeResult(words=words, n_bits=n_bits, n_symbols=sym.numel())
    stages = {"freq_scan_s": t1 - t0, "tree_build_s": t2 - t1,
              "encode_s": t3 - t2,
              "wire_bits": int(n_bits) + 8 * n_alphabet}
    return res, book, stages


def single_stage_encode(symbols, book, *, device=None) -> EncodeResult:
    """The paper's encoder: one pass through a fixed codebook
    (``encode_jit``, on ``device``, CUDA unless named).  Wire payload =
    header (book id + count) + bits; no codebook, no scan."""
    dev = resolve_device(device)
    sym = torch.as_tensor(symbols).reshape(-1).to(device=dev,
                                                  dtype=torch.uint8)
    words, n_bits = encode_jit(sym, book.codes, book.lengths,
                               max_len=book.max_len)
    return EncodeResult(words=words, n_bits=n_bits, n_symbols=sym.numel(),
                        book_id=book.book_id)


def encoded_size_bits(counts, lengths) -> torch.Tensor:
    """Ledger-mode exact size: histogram · lengths, summed in int64 on
    the counts' device (the reference's float32 dot is inexact past 2^24
    bits)."""
    c = torch.as_tensor(counts).to(torch.int64)
    return (c * torch.as_tensor(lengths).to(c.device, torch.int64)).sum()


# --------------------------------------------------------------------------
# NumPy reference codec (independent oracle, copied from the reference)
# --------------------------------------------------------------------------
def encode_np(symbols: np.ndarray, codes: np.ndarray,
              lengths: np.ndarray) -> Tuple[np.ndarray, int]:
    """Bit-exact reference encoder: plain Python bit twiddling."""
    bits = []
    for s in np.asarray(symbols).astype(np.int64):
        l = int(lengths[s])
        c = int(codes[s])
        bits.extend(((c >> (l - 1 - i)) & 1) for i in range(l))
    n_bits = len(bits)
    n_words = (n_bits + 31) // 32 + 1
    words = np.zeros(n_words, dtype=np.uint32)
    for i, b in enumerate(bits):
        if b:
            words[i >> 5] |= np.uint32(1) << np.uint32(31 - (i & 31))
    return words, n_bits


def decode_np(words: np.ndarray, n_symbols: int, book) -> np.ndarray:
    """Bit-serial canonical decode of a uint32 word stream."""
    t = book.tables
    out = np.zeros(n_symbols, dtype=np.uint8)
    pos = 0
    for k in range(n_symbols):
        code = 0
        l = 0
        while True:
            l += 1
            bit = (int(words[pos >> 5]) >> (31 - (pos & 31))) & 1
            pos += 1
            code = (code << 1) | bit
            off = code - int(t.first_code[l])
            if 0 <= off < int(t.num_codes[l]):
                out[k] = t.sorted_symbols[int(t.base_index[l]) + off]
                break
            if l >= t.max_len:
                raise ValueError("corrupt stream")
    return out
