"""CompressedParamStore — bf16 params held coded-at-rest in device memory
(port of ``repro.memstore.store``).

The store keeps each large bf16 leaf as two chunked coded byte-plane
streams (lo/hi, ``core.symbols.bf16_planes``) plus one book per plane,
built through the codec registry from whole-tree histograms (kernel B5
on the card).  Consumers either ``materialize`` a leaf (decode → bf16,
for one-shot uses such as an engine's load; kernel B4 or B6 on the card)
or call the fused ``matmul(x, leaf)`` (kernels B7/B8), which multiplies
tiles as they decode and never writes the raw weight to device memory.

At-rest layout — the reference's, which the compressed checkpoint also
writes: per plane, symbols are cut into ``chunk``-symbol blocks, each
encoded MSB-first (kernels B1 → B2) and trimmed to its own
``(bits + 31) // 32 + 1`` words, then concatenated.  ``blocks()``
re-expands to the zero-padded ``(NB, chunk_capacity_words)`` wire shape
the decoders read.  Where the reference loops over chunks on the host,
trimming and re-expansion here are one gather or scatter on the device,
indexed from the per-chunk word counts; the words are bit-identical to
the reference's (the CPU tests hold them equal).

Words are int32 bit patterns on the store's device; per-chunk bit counts
stay on the host as int64, as the reference keeps them.  Footprint
ledger: per-leaf ``raw_bits`` / ``coded_bits`` (payload + 32-bit
per-chunk headers; book lengths counted once store-wide), rolled up into
``hbm_raw_bits`` / ``hbm_coded_bits``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.codec import codec_for_book, default_codec, get_codec
from ..core.encoder import (chunk_capacity_words, chunk_counts_for,
                            concat_chunks)
from ..core.huffman import MAX_CODE_LEN
from ..core.symbols import bf16_from_planes, bf16_planes
from ..device import resolve_device

__all__ = ["PLANES", "DEFAULT_CHUNK", "DEFAULT_MIN_SIZE", "PlaneStream",
           "CodedLeaf", "RawLeaf", "encode_plane", "encode_blocks",
           "tighten", "decode_plane_stream", "decode_plane_streams",
           "CompressedParamStore"]

PLANES = ("lo", "hi")
DEFAULT_CHUNK = 4096
DEFAULT_MIN_SIZE = 1024
# Symbols per batched decode call of ``materialize_tree``: leaves are
# decoded together up to this many symbols (a larger leaf alone), so a
# plane costs one walk per batch, not one per leaf.
_DECODE_BATCH = 1 << 27


def _word_index(word_counts: torch.Tensor, total: int, cap: int
                ) -> torch.Tensor:
    """Flat positions in a (NB, cap) block array of each tight word:
    chunk i's words sit at [i * cap, i * cap + word_counts[i]).
    ``word_counts`` lies on the device, ``total`` is its sum."""
    dev = word_counts.device
    row = torch.repeat_interleave(
        torch.arange(word_counts.numel(), device=dev), word_counts,
        output_size=total)
    starts = torch.cumsum(word_counts, 0) - word_counts
    return row * cap + (torch.arange(total, device=dev) - starts[row])


def _symbol_counts(n_symbols: int, chunk: int, nb: int, device
                   ) -> torch.Tensor:
    """``chunk_counts_for`` made on the device: (NB,) int32, all
    ``chunk`` but the tail.  ``fill_`` takes the tail as a kernel
    argument; an item assignment would copy it from the host."""
    counts = torch.full((nb,), chunk, dtype=torch.int32, device=device)
    counts[-1:].fill_(n_symbols - (nb - 1) * chunk)
    return counts


@dataclass
class PlaneStream:
    """One byte plane of one leaf, chunked-coded and tightly packed.

    words:      (Σ words,) int32 — per-chunk streams, each trimmed to
                ``(bits + 31) // 32 + 1`` words, concatenated
    bit_counts: (NB,) int64 on the host — payload bits per chunk
    n_symbols:  total symbols (= leaf element count)
    chunk:      symbols per block (tail block may be short)
    """
    words: torch.Tensor
    bit_counts: np.ndarray
    n_symbols: int
    chunk: int
    max_len: int = MAX_CODE_LEN
    _device: Optional[Tuple[torch.Tensor, torch.Tensor]] = field(
        default=None, repr=False, compare=False)

    def chunk_word_counts(self) -> np.ndarray:
        return (self.bit_counts.astype(np.int64) + 31) // 32 + 1

    def chunk_counts(self) -> np.ndarray:
        return np.asarray(chunk_counts_for(self.n_symbols, self.chunk),
                          np.int32)

    def device_counts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(words per chunk int64, symbols per chunk int32) on the words'
        device, made once per stream, so a read that re-expands the
        stream copies nothing from the host."""
        if self._device is None:
            dev = self.words.device
            self._device = (
                torch.from_numpy(self.chunk_word_counts()).to(dev),
                _symbol_counts(self.n_symbols, self.chunk,
                               len(self.bit_counts), dev))
        return self._device

    def blocks(self) -> torch.Tensor:
        """The (NB, cap) zero-padded wire shape the decoders read —
        bit-identical to the chunked encoder's output."""
        return expand_blocks([self])

    @property
    def payload_bits(self) -> int:
        return int(self.bit_counts.sum())

    @property
    def stored_bits(self) -> int:
        """Tight at-rest footprint: packed words + 32-bit chunk headers."""
        return int(self.words.numel() * 32 + 32 * len(self.bit_counts))


def expand_blocks(streams: Sequence[PlaneStream]) -> torch.Tensor:
    """The blocks of several streams of one chunk size, stacked:
    (Σ NB, cap) int32 in stream order, one scatter on the device."""
    chunk, max_len = streams[0].chunk, streams[0].max_len
    if any(ps.chunk != chunk or ps.max_len != max_len for ps in streams):
        raise ValueError("streams of different chunk or max_len")
    cap = chunk_capacity_words(chunk, max_len)
    words = torch.cat([ps.words for ps in streams])
    counts = torch.cat([ps.device_counts()[0] for ps in streams])
    out = torch.zeros(counts.numel() * cap, dtype=torch.int32,
                      device=words.device)
    out[_word_index(counts, words.numel(), cap)] = words
    return out.reshape(counts.numel(), cap)


@dataclass
class CodedLeaf:
    """A bf16 leaf held as coded byte planes."""
    shape: Tuple[int, ...]
    planes: Dict[str, PlaneStream]

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def raw_bits(self) -> int:
        return 16 * self.n_elements

    @property
    def coded_bits(self) -> int:
        return sum(ps.stored_bits for ps in self.planes.values())


@dataclass
class RawLeaf:
    """A pass-through leaf (non-bf16 or below the coding floor)."""
    value: torch.Tensor

    @property
    def raw_bits(self) -> int:
        return self.value.numel() * self.value.element_size() * 8

    coded_bits = raw_bits


def encode_blocks(symbols: torch.Tensor, book, *, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One uint8 plane → its chunked stream (words (NB, cap) int32, bits
    (NB,) int32) on the symbols' device: B1 then B2."""
    from ..kernels.ops import encode_with_book
    return encode_with_book(symbols.reshape(-1), book, chunk=chunk)


def tighten(words: torch.Tensor, bits: torch.Tensor, bits_host: np.ndarray,
            n_symbols: int, *, chunk: int, max_len: int = MAX_CODE_LEN
            ) -> PlaneStream:
    """Trim chunked words (NB, cap) to the tight at-rest stream, given
    the chunks' bit counts on the device (``bits``, B2's output) and
    their copy on the host."""
    bits_host = np.asarray(bits_host, np.int64)
    word_counts = (bits.to(torch.int64) + 31) // 32 + 1
    total = int(((bits_host + 31) // 32 + 1).sum())
    idx = _word_index(word_counts, total, words.shape[1])
    return PlaneStream(words=words.reshape(-1)[idx], bit_counts=bits_host,
                       n_symbols=n_symbols, chunk=chunk, max_len=max_len,
                       _device=(word_counts, _symbol_counts(
                           n_symbols, chunk, words.shape[0], words.device)))


def encode_plane(symbols: torch.Tensor, book, *, chunk: int) -> PlaneStream:
    """Chunk-encode one uint8 symbol plane into a tight PlaneStream on
    the symbols' device (one host read of the chunks' bit counts)."""
    words, bits = encode_blocks(symbols, book, chunk=chunk)
    return tighten(words, bits, bits.cpu().numpy(), int(symbols.numel()),
                   chunk=chunk, max_len=book.max_len)


def decode_plane_streams(streams: Sequence[PlaneStream], book, *,
                         backend: str = "auto") -> List[torch.Tensor]:
    """Decode several streams of one book and chunk size in ONE decode
    call (B4 or B6 on the card) → each stream's (n_symbols,) uint8."""
    codec = codec_for_book(book)
    counts = torch.cat([ps.device_counts()[1] for ps in streams])
    out = codec.decode_blocks(expand_blocks(streams), counts, book,
                              streams[0].chunk, codec.resolve_backend(backend))
    res, row = [], 0
    for ps in streams:
        nb = len(ps.bit_counts)
        res.append(concat_chunks(out[row:row + nb], ps.chunk_counts()))
        row += nb
    return res


def decode_plane_stream(ps: PlaneStream, book, *,
                        backend: str = "auto") -> torch.Tensor:
    """Decode a PlaneStream back to its (n_symbols,) uint8 plane."""
    return decode_plane_streams([ps], book, backend=backend)[0]


class CompressedParamStore:
    """Param leaves coded-at-rest, with materialize and fused-consume
    paths plus a per-leaf footprint ledger.  See module docstring."""

    def __init__(self, entries: Dict[str, Any], books: Mapping[str, Any],
                 *, codec: Optional[str] = None, book_epoch: int = 0,
                 chunk: int = DEFAULT_CHUNK, treedef=None, device=None):
        self.entries = dict(entries)
        self.books = dict(books)
        name = codec or getattr(next(iter(self.books.values()), None),
                                "codec_name", None) or default_codec()
        get_codec(name)                      # validate eagerly
        self.codec = name
        self.book_epoch = int(book_epoch)
        self.chunk = int(chunk)
        self.treedef = treedef               # the tree's structure, or None
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_tree(cls, tree, *, chunk: int = DEFAULT_CHUNK,
                  codec: Optional[str] = None,
                  min_size: int = DEFAULT_MIN_SIZE, book_epoch: int = 0,
                  books: Optional[Mapping[str, Any]] = None,
                  key_prefix: Tuple[str, ...] = ("param", "bf16"),
                  device=None) -> "CompressedParamStore":
        """Encode every large bf16 leaf of ``tree`` on ``device`` (CUDA
        unless named); smaller / non-bf16 leaves pass through raw.
        Books are shared across leaves, one per byte plane, built from
        whole-tree histograms (B5) through the codec registry, or passed
        in.  Leaves are encoded one plane at a time, so the transient
        memory is one plane's codes, not the tree's."""
        from ..checkpoint.ckpt import _flatten, _skeleton
        from ..kernels.histogram import histogram256
        dev = resolve_device(device)
        codec_name = codec or (getattr(next(iter(books.values())),
                                       "codec_name", None)
                               if books else None) or default_codec()
        codec_obj = get_codec(codec_name)
        flat = _flatten(tree)
        coded = [n for n, leaf in flat.items()
                 if leaf.dtype == torch.bfloat16 and leaf.numel() >= min_size]

        if books is None:
            counts = {p: torch.zeros(256, dtype=torch.int64, device=dev)
                      for p in PLANES}
            for name in coded:
                planes = bf16_planes(flat[name].to(dev))
                for p in PLANES:
                    counts[p] += histogram256(planes[p])
            books = {p: codec_obj.build_book(counts[p].cpu().numpy(),
                                             key=key_prefix + (p,))
                     for p in PLANES}

        entries: Dict[str, Any] = {}
        for name, leaf in flat.items():
            if name in coded:
                planes = bf16_planes(leaf.to(dev))
                entries[name] = CodedLeaf(
                    shape=tuple(leaf.shape),
                    planes={p: encode_plane(planes[p], books[p], chunk=chunk)
                            for p in PLANES})
            else:
                entries[name] = RawLeaf(value=leaf.to(dev))
        return cls(entries, books, codec=codec_name, book_epoch=book_epoch,
                   chunk=chunk, treedef=_skeleton(tree), device=dev)

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------
    def names(self):
        return list(self.entries.keys())

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    def materialize(self, name: str, *, backend: str = "auto"
                    ) -> torch.Tensor:
        """Decode one leaf back to its exact bf16 tensor (raw leaves pass
        through untouched)."""
        return self._materialize([name], backend)[name]

    def _materialize(self, names: Sequence[str], backend: str
                     ) -> Dict[str, torch.Tensor]:
        """Decode ``names``, coded leaves in batches of up to
        ``_DECODE_BATCH`` symbols, one decode call per plane and batch."""
        out: Dict[str, torch.Tensor] = {}
        batch: List[str] = []

        def flush():
            if not batch:
                return
            sym = {p: decode_plane_streams(
                       [self.entries[n].planes[p] for n in batch],
                       self.books[p], backend=backend) for p in PLANES}
            for i, n in enumerate(batch):
                out[n] = bf16_from_planes(sym["lo"][i], sym["hi"][i]
                                          ).reshape(self.entries[n].shape)
            batch.clear()

        size = 0
        for n in names:
            e = self.entries[n]
            if isinstance(e, RawLeaf):
                out[n] = e.value
                continue
            if batch and (size + e.n_elements > _DECODE_BATCH
                          or e.planes["lo"].chunk
                          != self.entries[batch[0]].planes["lo"].chunk):
                flush()
                size = 0
            batch.append(n)
            size += e.n_elements
        flush()
        return out

    def materialize_tree(self, like=None, *, backend: str = "auto"):
        """Decode every leaf and rebuild the original tree (shaped as
        ``like``, else as the tree the store was built from)."""
        from ..checkpoint.ckpt import _unflatten
        template = like if like is not None else self.treedef
        if template is None:
            raise ValueError("store has no treedef; pass like=<template>")
        return _unflatten(template, self._materialize(self.names(), backend))

    def plane_blocks(self, name: str):
        """Kernel-ready coded blocks of one leaf on the store's device:
        (lo (NB, cap), hi (NB, cap), chunk_counts (NB,) int32)."""
        e = self.entries[name]
        if not isinstance(e, CodedLeaf):
            raise KeyError(f"{name!r} is stored raw, not coded")
        lo = e.planes["lo"]
        return lo.blocks(), e.planes["hi"].blocks(), lo.device_counts()[1]

    def matmul(self, x: torch.Tensor, name: str, *, tiles: bool = False):
        """Fused consume path: x @ leaf straight from the coded planes
        (kernels B7/B8).  Requires a 2D leaf whose column count divides
        the store chunk so chunks tile whole rows."""
        e = self.entries[name]
        if not isinstance(e, CodedLeaf) or len(e.shape) != 2:
            raise ValueError(f"{name!r} is not a coded 2D leaf")
        n_cols = e.shape[1]
        chunk = e.planes["lo"].chunk
        if chunk % n_cols != 0:
            raise ValueError(
                f"chunk {chunk} does not tile rows of {name!r} "
                f"(n_cols={n_cols}); rebuild the store with a chunk that "
                f"is a multiple of the leaf's column count")
        from ..kernels import ops
        lo, hi, counts = self.plane_blocks(name)
        return ops.decode_matmul(x, lo, hi, counts, self.books, chunk=chunk,
                                 n_cols=n_cols, tiles=tiles)

    # ------------------------------------------------------------------
    # ledger
    # ------------------------------------------------------------------
    def footprint(self) -> Dict[str, Any]:
        """Per-leaf and total footprint, in bits.  Raw pass-through
        leaves count identically on both sides; book tables (one lengths
        vector per plane) are counted once, store-wide."""
        leaves = {}
        raw = coded = 0
        for name, e in self.entries.items():
            r, c = int(e.raw_bits), int(e.coded_bits)
            leaves[name] = {
                "raw_bits": r, "coded_bits": c,
                "kind": "coded" if isinstance(e, CodedLeaf) else "raw"}
            raw += r
            coded += c
        book_bits = sum(
            np.asarray(b.lengths).astype(np.int32).nbytes * 8
            for b in self.books.values())
        coded += book_bits
        return {"leaves": leaves, "hbm_raw_bits": raw,
                "hbm_coded_bits": coded, "book_bits": book_bits,
                "ratio": (coded / raw) if raw else 0.0}
