"""Kernels B7 and B8: fused coded-weight decode + matmul
(``csrc/decode_matmul.cu``).

B7 (``decode_matmul``) replaces
``repro/kernels/decode_matmul.py::decode_matmul_pallas``: per chunk, a
canonical walk of W's lo and hi byte planes (each with its own book),
the bf16 tile ``lo | hi << 8`` of ``chunk // N`` rows, and its product
with x's matching columns, accumulated in float32.  B8
(``decode_matmul_qlc``) replaces ``decode_matmul_qlc_pallas``: the same
with per-plane QLC walks.  W (K, N) is flattened row-major before the
plane split and the chunked encode, and ``chunk % N == 0``; x (M, K) is
zero-padded to ``NB * rows`` columns, where a tail chunk's slack decodes
to bf16 0.0.

Sum order.  The TPU kernel adds ``x_blk @ tile`` chunk after chunk into
one resident output.  Hopper runs blocks in no order, so the kernels fix
a two-level order instead: chunks go in groups of ``GROUP`` consecutive
chunks (one CTA, one walker lane a chunk); a group's partial for output
(m, n) starts at 0 and takes, for each row-in-chunk j in order and for
each chunk c of the group in order, ``acc + x[m, c·rows + j] ·
W[c·rows + j, n]``; the output sums the group partials in group order.
Every multiply and add is a separate float32 operation.  The plain
versions here (``decode_matmul_plain``, ``decode_matmul_qlc_plain``)
decode with the plain walks and add in exactly that order
(``grouped_product``), so kernel and plain version agree bit for bit for
any float32 x; against the reference's chunk-major sum
(``ref.decode_matmul_ref``) the product agrees to float32 rounding.  The
decoded tiles are bit-exact everywhere.

Bound on the card: the chain of ``chunk`` dependent decode steps inside
a chunk (the store puts chunk ≥ N, so one chunk's chain is the floor of
the call; on gemma2-2b's layer-0 matrices it lies above ``x @ W`` of the
raw weight), then bytes (the coded words); the products are a decode
batch's few M·K·N multiply-adds, plain float32 on CUDA cores.  The
kernels walk every chunk of a matrix at once (a CTA holds a small ring
of decoded slices, not whole tiles, so nothing limits the chunk; one
walker warp a plane), read bits from registers fed by a shared-memory
word ring that each walker lane fills a slice ahead with cp.async, and
B7 decodes a step with one lookup in a 2^``PREFIX_BITS``-entry (symbol,
length) table per book (``core.encoder.canonical_prefix_table``), codes
longer than that taking the canonical search.  See the source for the
design.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from ..core.encoder import (PREFIX_BITS, canonical_prefix_table,
                            chunk_capacity_words, decode_chunks)
from ..core.huffman import MAX_CODE_LEN
from ..core.qlc import SYM_TAB_SIZE, decode_chunks_qlc
from ..core.symbols import bf16_from_planes
from .build import I, P, U, bind, check, count_launch, raise_on
from .decode import check_qlc_packs

__all__ = ["GROUP", "decode_matmul", "decode_matmul_plain",
           "decode_matmul_qlc", "decode_matmul_qlc_plain", "grouped_product",
           "pad_x", "prefix_tables"]

# Chunks per group of the sum order: the CUDA source's kGroup (one walker
# lane a chunk), checked against the built library at its first launch.
GROUP = 32

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _geometry(lo_words, hi_words, chunk_counts, chunk, n_cols, max_len):
    nb, cap = lo_words.shape
    if tuple(hi_words.shape) != (nb, cap):
        raise ValueError(f"hi_words {tuple(hi_words.shape)} != lo_words "
                         f"{(nb, cap)}")
    if tuple(chunk_counts.shape) != (nb,):
        raise ValueError(f"chunk_counts {tuple(chunk_counts.shape)} != "
                         f"({nb},)")
    if cap != chunk_capacity_words(chunk, max_len):
        raise ValueError(f"cap {cap} != capacity for chunk={chunk}")
    if n_cols <= 0 or chunk % n_cols != 0:
        raise ValueError(f"chunk {chunk} not a multiple of n_cols {n_cols}")
    return nb, cap, chunk // n_cols


def pad_x(x: torch.Tensor, nb: int, rows: int) -> torch.Tensor:
    """x (M, K) as float32, zero-padded to NB * rows columns (tail-chunk
    columns meet decoded-zero weight rows, so padding never changes the
    sum)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    k_pad = nb * rows
    if x.shape[1] > k_pad:
        raise ValueError(f"x K={x.shape[1]} exceeds coded rows {k_pad}")
    xf = x.to(torch.float32)
    if x.shape[1] < k_pad:
        xf = torch.nn.functional.pad(xf, (0, k_pad - x.shape[1]))
    return xf.contiguous()


def grouped_product(x: torch.Tensor, tiles: torch.Tensor, n_cols: int
                    ) -> torch.Tensor:
    """x (M, NB * rows) float32 @ the decoded weight tiles (NB, chunk)
    bf16, in the kernels' sum order: per group of ``GROUP`` consecutive
    chunks, each output (m, n) starts at 0 and takes, for each
    row-in-chunk j in order and for each chunk c of the group in order,
    ``acc = acc + x[m, c * rows + j] * W[c * rows + j, n]``; then the
    output sums the group partials in group order.  Each multiply and
    add is its own float32 operation.  Returns (M, n_cols) float32."""
    nb, chunk = tiles.shape
    rows = chunk // n_cols
    m = x.shape[0]
    dev = x.device
    ng = -(-nb // GROUP)
    w = torch.zeros((ng * GROUP, rows, n_cols), dtype=torch.float32,
                    device=dev)
    w[:nb] = tiles.reshape(nb, rows, n_cols).to(torch.float32)
    xs = torch.zeros((m, ng * GROUP, rows), dtype=torch.float32, device=dev)
    xs[:, :nb] = x.reshape(m, nb, rows)
    wg = w.reshape(ng, GROUP, rows, n_cols)
    xg = xs.reshape(m, ng, GROUP, rows).permute(1, 2, 3, 0)  # (ng, G, rows, M)
    here = torch.clamp(nb - torch.arange(ng, device=dev) * GROUP,
                       max=GROUP)[:, None, None]
    partial = torch.zeros((ng, m, n_cols), dtype=torch.float32, device=dev)
    for j in range(rows):
        for c in range(GROUP):
            prod = xg[:, c, j, :, None] * wg[:, c, j, None, :]
            partial = torch.where(c < here, partial + prod, partial)
    out = torch.zeros((m, n_cols), dtype=torch.float32, device=dev)
    for g in range(ng):
        out = out + partial[g]
    return out


def prefix_tables(first_code, base_index, num_codes, sorted_symbols,
                  max_len: int = MAX_CODE_LEN) -> Tuple[torch.Tensor, ...]:
    """B7's one-lookup tables for the two stacked books (row 0 lo, row 1
    hi), on the tables' device: ``canonical_prefix_table`` of each."""
    return tuple(canonical_prefix_table(
        (first_code[p], base_index[p], num_codes[p], sorted_symbols[p]),
        max_len) for p in range(2))


def _plain_result(x, lo_sym, hi_sym, nb, rows, n_cols, tiles) -> Result:
    w = bf16_from_planes(lo_sym, hi_sym)
    out = grouped_product(pad_x(x, nb, rows), w, n_cols)
    return (out, w) if tiles else out


def decode_matmul_plain(x, lo_words, hi_words, chunk_counts, first_code,
                        base_index, num_codes, sorted_symbols, *, chunk: int,
                        n_cols: int, max_len: int = MAX_CODE_LEN,
                        tiles: bool = False) -> Result:
    """B7 in plain torch: the canonical walk of each plane (row 0 of the
    stacked tables decodes lo, row 1 hi), then ``grouped_product``."""
    nb, _, rows = _geometry(lo_words, hi_words, chunk_counts, chunk, n_cols,
                            max_len)
    sym = [decode_chunks(words, chunk_counts, first_code[p], base_index[p],
                         num_codes[p], sorted_symbols[p], chunk=chunk,
                         max_len=max_len)
           for p, words in enumerate((lo_words, hi_words))]
    return _plain_result(x, *sym, nb, rows, n_cols, tiles)


def decode_matmul_qlc_plain(x, lo_words, hi_words, chunk_counts,
                            len_packs: Sequence[int],
                            base_packs: Sequence[int], sym_tabs, *,
                            chunk: int, n_cols: int,
                            max_len: int = MAX_CODE_LEN,
                            tiles: bool = False) -> Result:
    """B8 in plain torch: the QLC walk of each plane (``[lo, hi]`` packs
    and rows of ``sym_tabs``), then ``grouped_product``."""
    nb, _, rows = _geometry(lo_words, hi_words, chunk_counts, chunk, n_cols,
                            max_len)
    sym = [decode_chunks_qlc(words, chunk_counts, len_packs[p],
                             base_packs[p], sym_tabs[p], chunk=chunk,
                             max_len=max_len)
           for p, words in enumerate((lo_words, hi_words))]
    return _plain_result(x, *sym, nb, rows, n_cols, tiles)


def _launch(name: str, entry: str, argtypes, x, lo_words, hi_words,
            chunk_counts, table_args, *, chunk, n_cols, max_len, tiles
            ) -> Result:
    """Shared CUDA launch of B7 / B8: checks, scratch, one call."""
    dev = lo_words.device
    nb, cap, rows = _geometry(lo_words, hi_words, chunk_counts, chunk, n_cols,
                              max_len)
    check(lo_words, "lo_words", torch.int32, dev)
    check(hi_words, "hi_words", torch.int32, dev)
    check(chunk_counts, "chunk_counts", torch.int32, dev)
    group = bind("decode_matmul", "decode_matmul_group", [])()
    if group != GROUP:
        raise RuntimeError(f"decode_matmul.cu groups {group} chunks, the "
                           f"plain version {GROUP}")
    xf = pad_x(x.to(dev), nb, rows)
    m = xf.shape[0]
    ng = -(-nb // GROUP)
    partial = torch.empty((ng, m, n_cols), dtype=torch.float32, device=dev)
    out = torch.empty((m, n_cols), dtype=torch.float32, device=dev)
    tile_out = (torch.empty((nb, chunk), dtype=torch.int16, device=dev)
                if tiles else None)
    fn = bind("decode_matmul", entry, argtypes)
    with torch.cuda.device(dev):
        err = fn(xf.data_ptr(), lo_words.data_ptr(), hi_words.data_ptr(),
                 chunk_counts.data_ptr(), *table_args, partial.data_ptr(),
                 tile_out.data_ptr() if tiles else None, out.data_ptr(), nb,
                 chunk, cap, rows, n_cols, m,
                 *((max_len,) if name == "decode_matmul" else ()),
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, f"{name} ({'B7' if name == 'decode_matmul' else 'B8'})")
    count_launch(name)
    return (out, tile_out.view(torch.bfloat16)) if tiles else out


def decode_matmul(x, lo_words, hi_words, chunk_counts, first_code,
                  base_index, num_codes, sorted_symbols, *, chunk: int,
                  n_cols: int, max_len: int = MAX_CODE_LEN,
                  tiles: bool = False, prefix=None) -> Result:
    """Kernel B7 on CUDA tensors, its plain version on CPU tensors.

    x (M, K) (bf16 on the serve path; widened to float32), lo/hi words
    (NB, cap) int32, chunk_counts (NB,) int32, the two books' canonical
    tables stacked: first_code / base_index / num_codes (2, max_len + 1)
    and sorted_symbols (2, 256) int32 → (M, n_cols) float32; with
    ``tiles=True`` also the decoded weight (NB, chunk) bf16.  ``prefix``
    is the kernel's (lo, hi) pair of one-lookup tables, (2^PREFIX_BITS,)
    int16 each, as ``prefix_tables`` gives them (callers that hold books
    pass their cached copies, ``Codebook.device_tables("prefix")``);
    without it the kernel's wrapper builds them from the stacked tables.
    The plain version needs none.
    """
    args = (first_code, base_index, num_codes, sorted_symbols)
    if lo_words.device.type == "cpu":
        return decode_matmul_plain(x, lo_words, hi_words, chunk_counts,
                                   *args, chunk=chunk, n_cols=n_cols,
                                   max_len=max_len, tiles=tiles)
    if lo_words.device.type != "cuda":
        raise ValueError(f"no B7 kernel for device {lo_words.device}")
    if not 1 <= max_len <= 16:
        raise ValueError(f"max_len must be in [1, 16], got {max_len}")
    dev = lo_words.device
    for name, t in zip(("first_code", "base_index", "num_codes"), args):
        check(t, name, torch.int32, dev, (2, max_len + 1))
    check(sorted_symbols, "sorted_symbols", torch.int32, dev, (2, 256))
    bits = bind("decode_matmul", "decode_matmul_prefix_bits", [])()
    if bits != PREFIX_BITS:
        raise RuntimeError(f"decode_matmul.cu looks up {bits}-bit prefixes, "
                           f"the tables hold {PREFIX_BITS}")
    if prefix is None:
        prefix = prefix_tables(*args, max_len=max_len)
    for name, t in zip(("prefix[0]", "prefix[1]"), prefix):
        check(t, name, torch.int16, dev, (1 << PREFIX_BITS,))
    return _launch("decode_matmul", "decode_matmul_launch",
                   [P] * 13 + [I] * 7 + [P], x, lo_words, hi_words,
                   chunk_counts, [t.data_ptr() for t in (*args, *prefix)],
                   chunk=chunk, n_cols=n_cols, max_len=max_len, tiles=tiles)


def decode_matmul_qlc(x, lo_words, hi_words, chunk_counts,
                      len_packs: Sequence[int], base_packs: Sequence[int],
                      sym_tabs: torch.Tensor, *, chunk: int, n_cols: int,
                      max_len: int = MAX_CODE_LEN,
                      tiles: bool = False) -> Result:
    """Kernel B8 on CUDA tensors, its plain version on CPU tensors.

    As ``decode_matmul`` with the two books' QLC scalars: len_packs and
    base_packs ``[lo, hi]`` ints and sym_tabs (2, 256) int32.
    """
    for lp, bp in zip(len_packs, base_packs):
        check_qlc_packs(lp, bp)
    if lo_words.device.type == "cpu":
        return decode_matmul_qlc_plain(x, lo_words, hi_words, chunk_counts,
                                       len_packs, base_packs, sym_tabs,
                                       chunk=chunk, n_cols=n_cols,
                                       max_len=max_len, tiles=tiles)
    if lo_words.device.type != "cuda":
        raise ValueError(f"no B8 kernel for device {lo_words.device}")
    check(sym_tabs, "sym_tabs", torch.int32, lo_words.device,
          (2, SYM_TAB_SIZE))
    packs = [len_packs[0], base_packs[0], len_packs[1], base_packs[1]]
    return _launch("decode_matmul_qlc", "decode_matmul_qlc_launch",
                   [P] * 4 + [U] * 4 + [P] * 4 + [I] * 6 + [P], x, lo_words,
                   hi_words, chunk_counts, packs + [sym_tabs.data_ptr()],
                   chunk=chunk, n_cols=n_cols, max_len=max_len, tiles=tiles)
