"""Quad Length Codes (QLC) — the four-length prefix code fast path (port
of ``repro.core.qlc``).

A QLC codebook restricts the code to exactly four lengths
``l0 ≤ l1 ≤ l2 ≤ l3`` (each in ``[2, 16]``): every codeword is a 2-bit
**class** prefix ``c`` followed by ``l_c − 2`` index bits, so the code is
prefix-free by construction and the decoder reads the code length from
the two leading window bits — no canonical-prefix subtraction, no
per-window LUT, just shifts and one 256-entry symbol gather.

Construction ("length assignment by PMF quantile"): symbols are sorted
by probability and the four classes are filled greedily in order; the
builder scores **every** feasible non-decreasing 4-tuple over
``[2, max_len]`` (≤ 3060 candidates — one (T, n) · (n,) matvec on the
host) and keeps the argmin expected bits.  Within a class, members are
ordered by symbol value, so the code is a pure function of the
per-symbol lengths vector (``qlc_book_from_lengths``).

Wire format: identical to Huffman — codes ride the port's chunked
packer (kernel B2 on the card, ``encoder.pack_rows`` on the CPU) with
``max_len`` = ``MAX_CODE_LEN``, so chunk capacities match across codecs;
only the (codes, lengths) LUT and the decoder differ.

Books, codes, ``len_pack`` / ``base_pack`` / ``sym_tab`` and the content
hash are the reference's exactly.  The reference's XLA scan decoder
(``decode_chunks_qlc_jit`` with its 2^16 window LUT) has no counterpart:
both backend names of the QLC codec run kernel B6 on the card and
``decode_chunks_qlc`` here — B6's plain walk — on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .entropy import compressibility, expected_code_length
from .huffman import MAX_CODE_LEN

__all__ = [
    "QLC_CLASSES", "QLC_PREFIX_BITS", "QLC_MIN_LEN",
    "QLCBook", "build_qlc_book", "qlc_book_from_lengths",
    "qlc_kernel_args", "decode_chunks_qlc",
]

QLC_CLASSES = 4        # fixed by the 2-bit prefix
QLC_PREFIX_BITS = 2
QLC_MIN_LEN = 2        # prefix-only code (class capacity 1)

# The decoder reads a 16-bit window and takes the class from its top two
# bits, so no class length may exceed 16.
_QLC_WINDOW_BITS = 16
# Entries of the symbol table a decoder holds: the reference pads
# ``sym_tab`` to 256 with zeros and clamps every pointer into it.
SYM_TAB_SIZE = 256


def _class_capacity(length: int) -> int:
    return 1 << (length - QLC_PREFIX_BITS)


@lru_cache(maxsize=8)
def _candidate_tables(n: int, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """All feasible non-decreasing length 4-tuples for an n-symbol
    alphabet, in lexicographic order (the deterministic argmin
    tie-break), plus the (T, n) rank → length matrix the builder scores."""
    from itertools import combinations_with_replacement
    hi = min(max_len, _QLC_WINDOW_BITS)
    tuples = []
    rows = []
    for t in combinations_with_replacement(range(QLC_MIN_LEN, hi + 1),
                                           QLC_CLASSES):
        caps = [_class_capacity(l) for l in t]
        if sum(caps) < n:
            continue
        tuples.append(t)
        rows.append(np.repeat(np.asarray(t, np.int16), caps)[:n])
    if not tuples:
        raise ValueError(f"no feasible QLC length tuple for n={n} "
                         f"with max_len={max_len}")
    return np.asarray(tuples, np.int32), np.stack(rows)


@dataclass(frozen=True)
class QLCBook:
    """A fixed four-length (QLC) codebook over an n-symbol alphabet.

    Duck-types the host surface of ``codebook.Codebook`` (lengths, codes,
    encoded_bits, code_lut, ``device_tables("lut")``) so the encoder and
    the ledgers are codec-agnostic; only the decode tables differ — two
    packed scalars plus the (n,) pointer → symbol table.
    """
    book_id: int
    key: Tuple[str, str, str]
    lengths: np.ndarray            # (n,) int32 per-symbol code length
    codes: np.ndarray              # (n,) uint32, MSB-first, right-aligned
    class_lengths: Tuple[int, int, int, int]   # l0 ≤ l1 ≤ l2 ≤ l3
    class_bases: Tuple[int, int, int, int]     # symbols in classes < c
    sym_tab: np.ndarray            # (n,) int32: dense pointer → symbol
    source_counts: np.ndarray      # the (smoothed) histogram it came from
    max_len: int = MAX_CODE_LEN    # wire-capacity bound (chunk_capacity_words)
    _device_cache: Dict[Tuple[str, str], Tuple] = field(
        default_factory=dict, repr=False, compare=False)

    codec_name = "qlc"

    def expected_bits_per_symbol(self, counts: np.ndarray) -> float:
        return float(expected_code_length(counts, self.lengths))

    def encoded_bits(self, counts: np.ndarray) -> int:
        """Exact payload size in bits for a message with this histogram."""
        return int(np.dot(np.asarray(counts, np.int64),
                          self.lengths.astype(np.int64)))

    def compressibility(self, counts: np.ndarray, symbol_bits: int = 8) -> float:
        return float(compressibility(self.expected_bits_per_symbol(counts),
                                     symbol_bits))

    def code_lut(self) -> np.ndarray:
        """(n, 2) uint32 [code, length] table — the encoder kernel's LUT."""
        return np.stack([self.codes.astype(np.uint32),
                         self.lengths.astype(np.uint32)], axis=1)

    def len_pack(self) -> int:
        """Four class lengths packed 8 bits apiece into one uint32."""
        l0, l1, l2, l3 = self.class_lengths
        return l0 | (l1 << 8) | (l2 << 16) | (l3 << 24)

    def base_pack(self) -> int:
        """Class bases 1..3 packed 10 bits apiece (base 0 is always 0;
        a base can reach n=256, which needs the tenth bit)."""
        _, b1, b2, b3 = self.class_bases
        return b1 | (b2 << 10) | (b3 << 20)

    def device_tables(self, name: str, device) -> Tuple:
        """Tensor copies of the book's tables on ``device``, made once per
        (table, device) and cached:

          lut  — ((n, 2) int32 [code, length],), the encoder's LUT
          qlc  — ((256,) int32 sym_tab zero-padded to 256,), B6's table
        """
        dev = torch.device(device)
        ck = (name, str(dev))
        if ck not in self._device_cache:
            if name == "lut":
                a = self.code_lut().astype(np.int32)
            elif name == "qlc":
                a = np.zeros(SYM_TAB_SIZE, np.int32)
                a[:self.sym_tab.shape[0]] = self.sym_tab
            else:
                raise ValueError(f"unknown table set {name!r}")
            self._device_cache[ck] = (torch.from_numpy(a).to(dev),)
        return self._device_cache[ck]


def qlc_book_from_lengths(lengths: np.ndarray, *, book_id: int = -1,
                          key: Tuple[str, str, str] = ("", "", ""),
                          source_counts: Optional[np.ndarray] = None,
                          max_len: int = MAX_CODE_LEN) -> QLCBook:
    """Rebuild the canonical QLC book from its per-symbol lengths vector.

    Each distinct length L present needs ``ceil(n_L / 2^(L−2))``
    classes, in ascending length order; within a class, symbols are
    ordered by value.  More than four classes — or any length outside
    ``[2, min(max_len, 16)]`` — means the vector is not a QLC code.
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    n = lengths.shape[0]
    hi = min(max_len, _QLC_WINDOW_BITS)
    lo, top = int(lengths.min()), int(lengths.max())
    if lo < QLC_MIN_LEN or top > hi:
        raise ValueError(
            f"QLC code lengths must lie in [{QLC_MIN_LEN}, {hi}] "
            f"(2-bit prefix, 16-bit decode window, chunk capacity sized "
            f"for max_len={max_len}); got [{lo}, {top}]")
    classes = []
    for L in sorted(set(int(v) for v in lengths)):
        n_L = int((lengths == L).sum())
        cap = _class_capacity(L)
        classes.extend([L] * (-(-n_L // cap)))
    if len(classes) > QLC_CLASSES:
        raise ValueError(f"lengths need {len(classes)} classes; QLC has "
                         f"exactly {QLC_CLASSES} (2-bit prefix)")
    classes.extend([hi] * (QLC_CLASSES - len(classes)))   # unused classes

    codes = np.zeros(n, dtype=np.uint32)
    sym_tab = np.zeros(n, dtype=np.int32)
    bases = []
    ptr = 0
    remaining: Dict[int, list] = {}
    for s in range(n):                     # symbol-value order per length
        remaining.setdefault(int(lengths[s]), []).append(s)
    for c, L in enumerate(classes):
        bases.append(ptr)
        members = remaining.get(L, [])
        take = members[:_class_capacity(L)]
        remaining[L] = members[len(take):]
        for i, s in enumerate(take):
            codes[s] = np.uint32((c << (L - QLC_PREFIX_BITS)) | i)
            sym_tab[ptr + i] = s
        ptr += len(take)
    if ptr != n:
        raise ValueError("QLC class capacities do not cover the lengths "
                         "vector — not a canonical QLC code")
    if source_counts is None:
        source_counts = np.zeros(n, dtype=np.int64)
    return QLCBook(book_id=book_id, key=key, lengths=lengths, codes=codes,
                   class_lengths=tuple(classes), class_bases=tuple(bases),
                   sym_tab=sym_tab,
                   source_counts=np.asarray(source_counts),
                   max_len=max_len)


def build_qlc_book(counts: np.ndarray, *, book_id: int = -1,
                   key: Tuple[str, str, str] = ("", "", ""),
                   max_len: int = MAX_CODE_LEN, floor: int = 1,
                   n_symbols: Optional[int] = None) -> QLCBook:
    """Build the expected-bits-optimal QLC book from a probe histogram.

    Same contract as ``codebook.build_codebook``: ``floor`` smoothing
    makes the code total, the build is deterministic (stable sort,
    lexicographic tuple tie-break), and the result round-trips through
    ``qlc_book_from_lengths(book.lengths)``.
    """
    counts = np.asarray(counts, dtype=np.int64)
    n = counts.shape[0]
    if n_symbols is not None and n != n_symbols:
        raise ValueError(f"histogram has {n} bins, expected {n_symbols}")
    smoothed = np.maximum(counts, floor)
    tuples, rank_len = _candidate_tables(n, max_len)
    order = np.lexsort((np.arange(n), -smoothed))   # prob desc, value asc
    costs = rank_len.astype(np.float64) @ smoothed[order].astype(np.float64)
    best = int(np.argmin(costs))
    lengths = np.empty(n, dtype=np.int32)
    lengths[order] = rank_len[best].astype(np.int32)
    return qlc_book_from_lengths(lengths, book_id=book_id, key=key,
                                 source_counts=smoothed, max_len=max_len)


def qlc_kernel_args(book: QLCBook, device) -> Tuple[int, int, torch.Tensor]:
    """B6's arguments: both packed scalars and the (256,) int32
    pointer → symbol table on ``device``."""
    (sym_tab,) = book.device_tables("qlc", device)
    return book.len_pack(), book.base_pack(), sym_tab


def decode_chunks_qlc(block_words: torch.Tensor, chunk_counts: torch.Tensor,
                      len_pack: int, base_pack: int, sym_tab: torch.Tensor,
                      chunk: int, max_len: int = MAX_CODE_LEN
                      ) -> torch.Tensor:
    """Table-free QLC walk over every chunk (the function of kernel B6
    and of the reference's ``decode_chunks_qlc_pallas``).

    block_words (NB, cap) int32, chunk_counts (NB,) int32, the packed
    class lengths / bases and a sym_tab of at most 256 entries (padded
    with zeros to 256; pointers clamp into it, as the reference's do) →
    (NB, chunk) int32, zero past each count.  Each step's 16-bit window
    names its class by the top 2 bits, ``len_pack`` the length l, the
    next l − 2 bits the index past the class base (both resolved for all
    2^16 windows at once); ``encoder.walk_symbols`` takes the steps.
    """
    from .encoder import walk_symbols
    dev = block_words.device
    if sym_tab.numel() > SYM_TAB_SIZE:
        raise ValueError(f"sym_tab has {sym_tab.numel()} entries; at most "
                         f"{SYM_TAB_SIZE}")
    st = torch.zeros(SYM_TAB_SIZE, dtype=torch.int64, device=dev)
    st[:sym_tab.numel()] = sym_tab.reshape(-1).to(torch.int64)
    lens = torch.tensor([(len_pack >> (8 * c)) & 0xFF for c in range(4)],
                        dtype=torch.int64, device=dev)
    bases = torch.tensor([0] + [(base_pack >> (10 * c)) & 0x3FF
                                for c in range(3)],
                         dtype=torch.int64, device=dev)

    win = torch.arange(1 << 16, device=dev)              # 16-bit windows
    c = win >> 14                                        # 2-bit class
    l = lens[c]
    idx = (win >> (16 - l)) & ((1 << (l - 2)) - 1)
    sym16 = st[torch.clamp(bases[c] + idx, 0, SYM_TAB_SIZE - 1)]
    return walk_symbols(block_words, chunk_counts, chunk, l,
                        lambda w: sym16[w])
