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
chunks; a group's partial sums ``acc + x[m, r] * W[r, n]`` over its rows
in order, and the output sums the group partials in group order, every
multiply and add a separate float32 operation.  The plain versions here
(``decode_matmul_plain``, ``decode_matmul_qlc_plain``) decode with the
plain walks and add in exactly that order, so kernel and plain version
agree bit for bit for any float32 x; against the reference's chunk-major
sum (``ref.decode_matmul_ref``) the product agrees to float32 rounding.
The decoded tiles are bit-exact everywhere.

Bound on the card: the chain of dependent decode steps inside a chunk
(see the source); the products are a decode batch's few M·K·N
multiply-adds, written as plain float32 loops, no tensor cores yet.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from ..core.encoder import chunk_capacity_words, decode_chunks
from ..core.huffman import MAX_CODE_LEN
from ..core.qlc import SYM_TAB_SIZE, decode_chunks_qlc
from ..core.symbols import bf16_from_planes
from .build import I, P, U, bind, check, count_launch, raise_on
from .decode import check_qlc_packs

__all__ = ["GROUP", "decode_matmul", "decode_matmul_plain",
           "decode_matmul_qlc", "decode_matmul_qlc_plain", "grouped_product",
           "pad_x"]

# Chunks per group of the sum order; the CUDA source's kGroup, checked
# against the built library at its first launch.
GROUP = 4
# Shared memory a CTA may hold (Hopper: 227 KB), less the static tables.
_MAX_SMEM = 232_448 - 4096

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
    bf16, in the kernels' sum order: per group of ``GROUP`` chunks
    ``acc = acc + x[m, r] * W[r, n]`` over the group's rows, then the
    group partials in group order.  Returns (M, n_cols) float32."""
    nb, chunk = tiles.shape
    rows = chunk // n_cols
    m = x.shape[0]
    ng = -(-nb // GROUP)
    span = GROUP * rows
    w = torch.zeros((ng * span, n_cols), dtype=torch.float32,
                    device=tiles.device)
    w[:nb * rows] = tiles.reshape(nb * rows, n_cols).to(torch.float32)
    xs = torch.zeros((m, ng * span), dtype=torch.float32, device=x.device)
    xs[:, :nb * rows] = x
    wg = w.reshape(ng, span, n_cols)
    xg = xs.reshape(m, ng, span).permute(1, 0, 2)            # (ng, M, span)
    valid = (torch.clamp(nb - torch.arange(ng, device=x.device) * GROUP,
                         max=GROUP) * rows)[:, None, None]
    partial = torch.zeros((ng, m, n_cols), dtype=torch.float32,
                          device=x.device)
    for j in range(span):
        prod = xg[:, :, j, None] * wg[:, None, j, :]
        partial = torch.where(j < valid, partial + prod, partial)
    out = torch.zeros((m, n_cols), dtype=torch.float32, device=x.device)
    for g in range(ng):
        out = out + partial[g]
    return out


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
    if 2 * GROUP * chunk > _MAX_SMEM:
        raise ValueError(f"chunk {chunk} needs {2 * GROUP * chunk} B of "
                         f"shared memory for its tiles; at most {_MAX_SMEM}")
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
                  tiles: bool = False) -> Result:
    """Kernel B7 on CUDA tensors, its plain version on CPU tensors.

    x (M, K) (bf16 on the serve path; widened to float32), lo/hi words
    (NB, cap) int32, chunk_counts (NB,) int32, the two books' canonical
    tables stacked: first_code / base_index / num_codes (2, max_len + 1)
    and sorted_symbols (2, 256) int32 → (M, n_cols) float32; with
    ``tiles=True`` also the decoded weight (NB, chunk) bf16.
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
    return _launch("decode_matmul", "decode_matmul_launch",
                   [P] * 11 + [I] * 7 + [P], x, lo_words, hi_words,
                   chunk_counts, [t.data_ptr() for t in args], chunk=chunk,
                   n_cols=n_cols, max_len=max_len, tiles=tiles)


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
