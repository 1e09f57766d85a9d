"""Kernels B3 and B4: chunked canonical Huffman decode; kernel B6:
chunked QLC decode (``csrc/decode.cu``).

B3 (``decode_chunks_canonical``) replaces
``repro/kernels/decode.py::decode_chunks_pallas``: a per-chunk canonical
walk, one symbol a step.  B4 (``decode_chunks_multisym``) replaces
``repro/kernels/decode.py::decode_chunks_multisym_pallas``: a K-bit
window LUT emitting up to s_max symbols a step, with the inline
canonical slow path for codes longer than K bits.

Bound on the card: the dependent chain inside a chunk (2048 steps for
B3, about 2048 / s̄ for B4), not bytes or operations; a call takes at
least one chunk's chain times the time of a step.  B3 shortens the step
and walks every chunk at once: it spreads a plane's chunks over every SM
(ceil(NB / SMs) lanes a CTA, one lane a chunk), reads bits from registers
fed by a shared-memory word ring that each lane fills a slice ahead with
cp.async, decodes a step with one lookup in the book's
2^``PREFIX_BITS``-entry prefix table (``Codebook.device_tables
("prefix")``; for longer codes the canonical search, which runs beside
the lookup and is picked with a select, not a branch), and
writes its symbols out in coalesced 16-byte stores (the walker is B7's,
``csrc/walk.cuh``).  B4 walks one chunk a thread in CTAs of one warp, so
a plane's 500 chunks spread over 16 SMs; it holds its LUT as uint8
symbols and uint16 metadata, 80 KB of shared memory (see the source).
B4 is simple and slow; making it fast is later work.

B6 (``decode_chunks_qlc``) replaces
``repro/kernels/decode.py::decode_chunks_qlc_pallas``: the table-free
QLC walk (class from the window's top 2 bits, length and base from two
packed scalars, symbol from a 256-entry table), on B4's scaffolding.

Each has its plain-torch twin beside it: ``decode_chunks_canonical_plain``
is the reference's ``decode_chunks_jit`` walk, ``decode_chunks_multisym_plain``
runs B4's own algorithm — LUT step, slow path, emit — as a loop over
steps vectorised across chunks (both from ``core.encoder``), and
``decode_chunks_qlc_plain`` is ``core.qlc``'s walk.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.encoder import (DEFAULT_CHUNK, PREFIX_BITS,
                            canonical_prefix_table, chunk_capacity_words,
                            decode_chunks, decode_chunks_multisym as _multisym)
from ..core.huffman import MAX_CODE_LEN
from ..core.qlc import SYM_TAB_SIZE
from ..core.qlc import decode_chunks_qlc as _qlc
from .build import I, P, U, bind, check, count_launch, raise_on

__all__ = ["decode_chunks_canonical", "decode_chunks_canonical_plain",
           "decode_chunks_multisym", "decode_chunks_multisym_plain",
           "decode_chunks_qlc", "decode_chunks_qlc_plain", "check_qlc_packs"]

decode_chunks_canonical_plain = decode_chunks
decode_chunks_multisym_plain = _multisym
decode_chunks_qlc_plain = _qlc


def _check_stream(block_words, chunk_counts, chunk, max_len, tables):
    dev = block_words.device
    nb, cap = block_words.shape
    if cap != chunk_capacity_words(chunk, max_len):
        raise ValueError(f"cap {cap} != capacity for chunk={chunk}")
    if not 1 <= max_len <= 16:
        raise ValueError(f"max_len must be in [1, 16], got {max_len}")
    check(block_words, "block_words", torch.int32, dev)
    check(chunk_counts, "chunk_counts", torch.int32, dev, (nb,))
    fc, bi, nc, ss = tables
    for name, t in (("first_code", fc), ("base_index", bi),
                    ("num_codes", nc)):
        check(t, name, torch.int32, dev, (max_len + 1,))
    check(ss, "sorted_symbols", torch.int32, dev)
    if not 1 <= ss.numel() <= 256:
        raise ValueError(f"sorted_symbols has {ss.numel()} entries; "
                         f"expected 1..256")
    return dev, nb, cap


def decode_chunks_canonical(block_words: torch.Tensor,
                            chunk_counts: torch.Tensor,
                            first_code: torch.Tensor, base_index: torch.Tensor,
                            num_codes: torch.Tensor,
                            sorted_symbols: torch.Tensor, *,
                            chunk: int = DEFAULT_CHUNK,
                            max_len: int = MAX_CODE_LEN,
                            prefix: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Kernel B3 on CUDA tensors, the plain walk on CPU tensors.

    block_words (NB, cap) int32, chunk_counts (NB,) int32, the canonical
    tables as int32 → (NB, chunk) int32 symbols, zero past each count.
    ``prefix`` is the book's one-lookup table, (2^PREFIX_BITS,) int16
    (``Codebook.device_tables("prefix")``, which callers that hold a book
    pass); without it the kernel's wrapper builds it from the tables
    (``core.encoder.canonical_prefix_table``).  The result does not
    depend on it: the plain walk takes no table.
    """
    tables = (first_code, base_index, num_codes, sorted_symbols)
    if prefix is not None:
        check(prefix, "prefix", torch.int16, block_words.device,
              (1 << PREFIX_BITS,))
    if block_words.device.type == "cpu":
        return decode_chunks_canonical_plain(block_words, chunk_counts,
                                             *tables, chunk=chunk,
                                             max_len=max_len)
    if block_words.device.type != "cuda":
        raise ValueError(f"no B3 kernel for device {block_words.device}")
    dev, nb, cap = _check_stream(block_words, chunk_counts, chunk, max_len,
                                 tables)
    bits = bind("decode", "decode_canonical_prefix_bits", [])()
    if bits != PREFIX_BITS:
        raise RuntimeError(f"decode.cu looks up {bits}-bit prefixes, the "
                           f"tables hold {PREFIX_BITS}")
    if prefix is None:
        prefix = canonical_prefix_table(tables, max_len)
    if prefix.data_ptr() % 16:
        raise ValueError("prefix must be 16-byte aligned")
    out = torch.empty((nb, chunk), dtype=torch.int32, device=dev)
    fn = bind("decode", "decode_canonical_launch",
              [P, P, P, P, P, P, P, I, P, I, I, I, I, P])
    with torch.cuda.device(dev):
        err = fn(block_words.data_ptr(), chunk_counts.data_ptr(),
                 prefix.data_ptr(), *(t.data_ptr() for t in tables),
                 sorted_symbols.numel(), out.data_ptr(), nb, chunk, cap,
                 max_len, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "decode_chunks_canonical (B3)")
    count_launch("decode_chunks_canonical")
    return out


def decode_chunks_multisym(block_words: torch.Tensor,
                           chunk_counts: torch.Tensor, syms: torch.Tensor,
                           meta: torch.Tensor, first_code: torch.Tensor,
                           base_index: torch.Tensor, num_codes: torch.Tensor,
                           sorted_symbols: torch.Tensor, *,
                           chunk: int = DEFAULT_CHUNK,
                           max_len: int = MAX_CODE_LEN) -> torch.Tensor:
    """Kernel B4 on CUDA tensors, its plain version on CPU tensors.

    As ``decode_chunks_canonical`` plus the book's compact LUT
    (``Codebook.device_tables("multisym", device)``): syms (2^k, s_max)
    uint8 and meta (2^k,) int16 holding ``count | bits << 8``.
    """
    tables = (first_code, base_index, num_codes, sorted_symbols)
    if block_words.device.type == "cpu":
        return decode_chunks_multisym_plain(block_words, chunk_counts, syms,
                                            meta, *tables, chunk=chunk,
                                            max_len=max_len)
    if block_words.device.type != "cuda":
        raise ValueError(f"no B4 kernel for device {block_words.device}")
    dev, nb, cap = _check_stream(block_words, chunk_counts, chunk, max_len,
                                 tables)
    size, s_max = syms.shape
    k = size.bit_length() - 1
    if (1 << k) != size or not 3 <= k < max_len:
        raise ValueError(f"multisym table size {size} must be 2^k with "
                         f"3 <= k < max_len")
    if (size * s_max) % 16:
        raise ValueError(f"syms table of {size * s_max} B is not a "
                         f"multiple of 16 B")
    check(syms, "syms", torch.uint8, dev)
    check(meta, "meta", torch.int16, dev, (size,))
    for name, t in (("syms", syms), ("meta", meta)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((nb, chunk), dtype=torch.int32, device=dev)
    fn = bind("decode", "decode_multisym_launch",
              [P, P, P, P, P, P, P, P, I, P, I, I, I, I, I, I, P])
    with torch.cuda.device(dev):
        err = fn(block_words.data_ptr(), chunk_counts.data_ptr(),
                 syms.data_ptr(), meta.data_ptr(),
                 *(t.data_ptr() for t in tables), sorted_symbols.numel(),
                 out.data_ptr(), nb, chunk, cap, k, s_max, max_len,
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "decode_chunks_multisym (B4)")
    count_launch("decode_chunks_multisym")
    return out


def check_qlc_packs(len_pack: int, base_pack: int) -> None:
    """Raise unless every class length of ``len_pack`` lies in [2, 16]
    and ``base_pack`` fits its 30 bits: a walk shifts by ``16 - l`` and
    masks ``l - 2`` bits, which other lengths would break."""
    lens = [(len_pack >> (8 * c)) & 0xFF for c in range(4)]
    if not 0 <= len_pack < 1 << 32 or not all(2 <= l <= 16 for l in lens):
        raise ValueError(f"len_pack {len_pack:#x}: class lengths {lens} "
                         f"must lie in [2, 16]")
    if not 0 <= base_pack < 1 << 30:
        raise ValueError(f"base_pack {base_pack:#x} exceeds 30 bits")


def decode_chunks_qlc(block_words: torch.Tensor, chunk_counts: torch.Tensor,
                      len_pack: int, base_pack: int, sym_tab: torch.Tensor,
                      *, chunk: int = DEFAULT_CHUNK,
                      max_len: int = MAX_CODE_LEN) -> torch.Tensor:
    """Kernel B6 on CUDA tensors, the plain walk on CPU tensors.

    block_words (NB, cap) int32, chunk_counts (NB,) int32, the book's
    packed class lengths and bases (``QLCBook.len_pack()`` /
    ``base_pack()``) and its sym_tab (at most 256 int32 entries, padded
    with zeros to 256 as the reference pads it; ``QLCBook.device_tables
    ("qlc")`` holds it padded) → (NB, chunk) int32 symbols, zero past
    each count.
    """
    check_qlc_packs(len_pack, base_pack)
    if block_words.device.type == "cpu":
        return decode_chunks_qlc_plain(block_words, chunk_counts, len_pack,
                                       base_pack, sym_tab, chunk=chunk,
                                       max_len=max_len)
    if block_words.device.type != "cuda":
        raise ValueError(f"no B6 kernel for device {block_words.device}")
    dev = block_words.device
    nb, cap = block_words.shape
    if cap != chunk_capacity_words(chunk, max_len):
        raise ValueError(f"cap {cap} != capacity for chunk={chunk}")
    check(block_words, "block_words", torch.int32, dev)
    check(chunk_counts, "chunk_counts", torch.int32, dev, (nb,))
    check(sym_tab, "sym_tab", torch.int32, dev)
    if not 1 <= sym_tab.numel() <= SYM_TAB_SIZE:
        raise ValueError(f"sym_tab has {sym_tab.numel()} entries; expected "
                         f"1..{SYM_TAB_SIZE}")
    if sym_tab.numel() < SYM_TAB_SIZE:              # the reference's zero pad
        sym_tab = torch.nn.functional.pad(
            sym_tab, (0, SYM_TAB_SIZE - sym_tab.numel()))
    out = torch.empty((nb, chunk), dtype=torch.int32, device=dev)
    fn = bind("decode", "decode_qlc_launch", [P, P, U, U, P, P, I, I, I, P])
    with torch.cuda.device(dev):
        err = fn(block_words.data_ptr(), chunk_counts.data_ptr(), len_pack,
                 base_pack, sym_tab.data_ptr(), out.data_ptr(), nb, chunk,
                 cap, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "decode_chunks_qlc (B6)")
    count_launch("decode_chunks_qlc")
    return out
