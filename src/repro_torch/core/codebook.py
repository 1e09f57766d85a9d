"""Fixed codebooks and the codebook registry — the paper's §4 Implementation.

A deployment keeps one codebook per *(tensor kind, dtype, byte plane)*,
built from the running-average PMF of previous batches, entirely off the
critical path.  All participating nodes hold identical registries, so a
message is just ``(codebook_id, n_symbols, encoded bits)`` — no codebook
ever rides the wire.

Codebook *selection* supports both of the paper's modes:
  * software — the caller names the tensor kind and gets "its" book;
  * hardware — ``select_best`` evaluates every candidate book against the
    message histogram in parallel (a (n_books, 256) · (256,) matvec) and
    picks the argmin expected length, mimicking parallel hardware
    evaluation.

Histograms are floor-smoothed before code construction so *every* symbol
owns a code — a fixed book must be total: future batches may emit bytes
the averaging window never saw.

Port of ``repro.core.codebook``: books, the content hash and the saved
registry format are the reference's exactly (a registry saved by either
package loads in the other).  The port adds ``Codebook.device_tables``,
the per-device tensor copies of a book's encode and decode tables.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .entropy import compressibility, expected_code_length, pmf_from_counts
from .huffman import (MAX_CODE_LEN, MULTISYM_K, MULTISYM_SMAX,
                      CanonicalTables, MultiSymTables, build_multisym_tables,
                      canonical_codes, canonical_decode_tables,
                      package_merge_lengths, validate_prefix_free)

__all__ = ["Codebook", "CodebookKey", "CodebookRegistry", "RegistrySnapshot",
           "build_codebook", "multisym_device_tables",
           "registry_content_hash"]

CodebookKey = Tuple[str, str, str]  # (tensor_kind, dtype_scheme, plane)


@dataclass(frozen=True)
class Codebook:
    """A fixed canonical Huffman codebook over an n-symbol alphabet."""
    codec_name = "huffman"               # registry tag (core.codec)
    book_id: int
    key: CodebookKey
    lengths: np.ndarray          # (n,) int32; >0 everywhere (total code)
    codes: np.ndarray            # (n,) uint32, canonical, MSB-first
    tables: CanonicalTables      # decode-side tables
    source_counts: np.ndarray    # the (smoothed) histogram it was built from
    max_len: int = MAX_CODE_LEN
    # Lazily-built multi-symbol decode tables, keyed by (k, s_max); a
    # mutable cache is fine inside the frozen dataclass — the codebook
    # itself (lengths/codes) never changes.
    _multisym_cache: Dict[Tuple[int, int], MultiSymTables] = field(
        default_factory=dict, repr=False, compare=False)
    _device_cache: Dict[Tuple[str, str], Tuple] = field(
        default_factory=dict, repr=False, compare=False)

    def multisym_tables(self, k: int = MULTISYM_K,
                        s_max: int = MULTISYM_SMAX) -> MultiSymTables:
        """The K-bit direct-indexed multi-symbol decode LUT (cached)."""
        key = (k, s_max)
        if key not in self._multisym_cache:
            self._multisym_cache[key] = build_multisym_tables(
                self.lengths, k=k, s_max=s_max, max_len=self.max_len)
        return self._multisym_cache[key]

    def device_tables(self, name: str, device) -> Tuple:
        """Tensor copies of one of the book's tables on ``device``, made
        once per (table, device) and cached, so a decode step copies no
        table from the host:

          lut        — ((n, 2) int32 [code, length],)
          canonical  — (first_code, base_index, num_codes, sorted_symbols)
                       int32
          multisym   — (syms (2^K, s_max) uint8, meta (2^K,) int16): B4's
                       compact form of the default LUT (K = MULTISYM_K,
                       s_max = MULTISYM_SMAX; ``multisym_device_tables``),
                       80 KB
          prefix     — ((2^PREFIX_BITS,) int16,): B7's one-lookup table
                       of ``symbol | length << 8``
                       (``encoder.canonical_prefix_table``)
        """
        dev = torch.device(device)
        ck = (name, str(dev))
        if ck in self._device_cache:
            return self._device_cache[ck]

        def t(a, dtype=torch.int32):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        if name == "lut":
            out = (t(self.code_lut().astype(np.int32)),)
        elif name == "canonical":
            tb = self.tables
            out = (t(tb.first_code), t(tb.base_index), t(tb.num_codes),
                   t(tb.sorted_symbols))
        elif name == "multisym":
            out = multisym_device_tables(self.multisym_tables(), dev)
        elif name == "prefix":
            from .encoder import canonical_prefix_table
            out = (canonical_prefix_table(self.device_tables("canonical",
                                                             dev),
                                          self.max_len),)
        else:
            raise ValueError(f"unknown table set {name!r}")
        self._device_cache[ck] = out
        return out

    def expected_bits_per_symbol(self, counts: np.ndarray) -> float:
        return float(expected_code_length(counts, self.lengths))

    def encoded_bits(self, counts: np.ndarray) -> int:
        """Exact payload size in bits for a message with this histogram."""
        return int(np.dot(np.asarray(counts, np.int64), self.lengths.astype(np.int64)))

    def compressibility(self, counts: np.ndarray, symbol_bits: int = 8) -> float:
        return float(compressibility(self.expected_bits_per_symbol(counts),
                                     symbol_bits))

    def code_lut(self) -> np.ndarray:
        """(n, 2) uint32 [code, length] table — the encoder kernel's LUT."""
        return np.stack([self.codes.astype(np.uint32),
                         self.lengths.astype(np.uint32)], axis=1)


def multisym_device_tables(mt: MultiSymTables, device) -> Tuple:
    """Kernel B4's compact form of a multi-symbol LUT on ``device``:
    (syms (2^K, s_max) uint8, meta (2^K,) int16).  Symbols are < 256 and
    ``count | bits << 8`` <= 16 | 16 << 8, so neither loses a bit."""
    dev = torch.device(device)
    return (torch.from_numpy(mt.syms.astype(np.uint8)).to(dev),
            torch.from_numpy(mt.meta.astype(np.int16)).to(dev))


def build_codebook(counts: np.ndarray, *, book_id: int = -1,
                   key: CodebookKey = ("", "", ""),
                   max_len: int = MAX_CODE_LEN,
                   floor: int = 1, n_symbols: Optional[int] = None,
                   codec: Optional[str] = None) -> Codebook:
    """Build a total, length-limited codebook from a histogram.

    ``floor`` smoothing gives every symbol at least that count so the code
    is total.  The compression loss from smoothing is O(n/total) bits —
    negligible for the multi-MB shards the paper studies.

    ``codec`` selects the length-assignment strategy (``core.codec``
    registry): ``"huffman"`` builds the canonical Huffman book inline;
    any other registered codec dispatches to its ``build_book``; ``None``
    resolves to the default codec (``core.codec.default_codec``).
    """
    if codec is None:
        from .codec import default_codec
        codec = default_codec()
    if codec != "huffman":
        from .codec import get_codec
        return get_codec(codec).build_book(
            counts, book_id=book_id, key=key, max_len=max_len, floor=floor,
            n_symbols=n_symbols)
    counts = np.asarray(counts, dtype=np.int64)
    if n_symbols is not None and counts.shape[0] != n_symbols:
        raise ValueError(f"histogram has {counts.shape[0]} bins, expected {n_symbols}")
    smoothed = np.maximum(counts, floor)
    lengths = package_merge_lengths(smoothed, max_len=max_len)
    validate_prefix_free(lengths)
    codes = canonical_codes(lengths)
    tables = canonical_decode_tables(lengths, max_len=max_len)
    return Codebook(book_id=book_id, key=key, lengths=lengths, codes=codes,
                    tables=tables, source_counts=smoothed, max_len=max_len)


@dataclass
class _RunningPMF:
    """Exponential-moving-average histogram over observation windows."""
    counts: np.ndarray
    n_batches: int = 0

    def observe(self, counts: np.ndarray, ema: float) -> None:
        counts = np.asarray(counts, dtype=np.float64)
        if self.n_batches == 0:
            self.counts = counts.copy()
        else:
            # EMA over *normalized* batch PMFs so batch size can vary.
            self.counts = ema * self.counts + (1.0 - ema) * (
                counts / max(counts.sum(), 1.0) * max(self.counts.sum(), 1.0))
        self.n_batches += 1


def registry_content_hash(books: Iterable[Codebook]) -> str:
    """Deterministic digest of a registry's *coding content* — the
    (book_id, key, lengths) triples that define what every encoder and
    decoder on the fleet must agree on.  Canonical codes and decode
    tables are pure functions of the lengths, so hashing lengths pins
    the whole wire format; EMA observation state is deliberately
    excluded (it differs across replicas without breaking the wire).

    The per-book **codec identity** is part of the content: the same
    lengths vector decodes differently under huffman vs qlc, so a
    mixed-codec fleet must fail ``verify_epoch_agreement`` exactly like
    a mixed-lengths one."""
    h = hashlib.sha256()
    for book in books:
        h.update(np.int64(book.book_id).tobytes())
        h.update(getattr(book, "codec_name", "huffman").encode() + b"\x1e")
        h.update("\x1f".join(book.key).encode() + b"\x1e")
        h.update(np.ascontiguousarray(book.lengths, dtype=np.int32).tobytes())
    return h.hexdigest()


@dataclass(frozen=True)
class RegistrySnapshot:
    """Immutable view of one registry epoch (repro.lifecycle).

    ``books`` are in ``book_id`` order; ``content_hash`` is
    ``registry_content_hash`` over them.  A snapshot never mutates, so a
    train/serve step may keep encoding against epoch N while the
    lifecycle manager builds epoch N+1 on the host.
    """
    epoch: int
    books: Tuple[Codebook, ...]
    content_hash: str
    codec: str = "huffman"       # the codec every book was built with

    def get(self, key: CodebookKey) -> Codebook:
        for book in self.books:
            if book.key == key:
                return book
        raise KeyError(key)

    def keys(self) -> List[CodebookKey]:
        return [book.key for book in self.books]

    def __len__(self) -> int:
        return len(self.books)


class CodebookRegistry:
    """Shared registry of fixed codebooks, mirrored on every node.

    Lifecycle: `observe()` feeds histograms from previous batches (cheap,
    off critical path); `rebuild()` refreshes the codebooks; `get()` /
    `select_best()` serve the encoder.  Thread-safe: a background stats
    thread may observe while the train loop encodes.

    Every ``rebuild()`` that refreshes at least one book bumps the
    monotone ``book_epoch``; ``snapshot()`` captures the current epoch as
    an immutable ``RegistrySnapshot`` whose ``content_hash`` lets peers
    verify they hold the same books (repro.lifecycle.sync).
    """

    def __init__(self, n_symbols: int = 256, *, ema: float = 0.9,
                 max_len: int = MAX_CODE_LEN, codec: Optional[str] = None):
        if codec is None:
            from .codec import default_codec
            codec = default_codec()
        else:
            from .codec import get_codec
            get_codec(codec)             # validate eagerly
        self.n_symbols = n_symbols
        self.ema = ema
        self.max_len = max_len
        self.codec = codec
        self._lock = threading.Lock()
        self._running: Dict[CodebookKey, _RunningPMF] = {}
        self._books: Dict[CodebookKey, Codebook] = {}
        self._by_id: List[Codebook] = []
        self._epoch = 0

    @property
    def book_epoch(self) -> int:
        with self._lock:
            return self._epoch

    def snapshot(self) -> RegistrySnapshot:
        with self._lock:
            books = tuple(self._by_id)
            return RegistrySnapshot(epoch=self._epoch, books=books,
                                    content_hash=registry_content_hash(books),
                                    codec=self.codec)

    # ---------------------------------------------------------- observation
    def observe(self, key: CodebookKey, counts: np.ndarray) -> None:
        counts = np.asarray(counts, dtype=np.float64)
        n = counts.shape[-1]
        with self._lock:
            rp = self._running.setdefault(
                key, _RunningPMF(np.zeros(n, dtype=np.float64)))
            if counts.ndim == 1:
                rp.observe(counts, self.ema)
            else:  # a stack of shard histograms: average first (paper §3)
                rp.observe(counts.sum(axis=0), self.ema)

    def average_pmf(self, key: CodebookKey) -> np.ndarray:
        with self._lock:
            return pmf_from_counts(self._running[key].counts)

    # ---------------------------------------------------------- (re)build
    def rebuild(self, keys: Optional[Iterable[CodebookKey]] = None) -> None:
        with self._lock:
            todo = list(keys) if keys is not None else list(self._running)
            for key in todo:
                counts = np.round(self._running[key].counts).astype(np.int64)
                book_id = (self._books[key].book_id if key in self._books
                           else len(self._by_id))
                book = build_codebook(counts, book_id=book_id, key=key,
                                      max_len=self.max_len, codec=self.codec)
                self._books[key] = book
                if book_id == len(self._by_id):
                    self._by_id.append(book)
                else:
                    self._by_id[book_id] = book
            if todo:
                self._epoch += 1

    def install(self, key: CodebookKey, counts: np.ndarray) -> Codebook:
        """Observe + rebuild in one shot (bootstrap path)."""
        self.observe(key, counts)
        self.rebuild([key])
        return self._books[key]

    # ---------------------------------------------------------- lookup
    def get(self, key: CodebookKey) -> Codebook:
        with self._lock:
            return self._books[key]

    def by_id(self, book_id: int) -> Codebook:
        with self._lock:
            return self._by_id[book_id]

    def __contains__(self, key: CodebookKey) -> bool:
        with self._lock:
            return key in self._books

    def keys(self) -> List[CodebookKey]:
        with self._lock:
            return list(self._books)

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_id)

    def select_best(self, counts: np.ndarray,
                    candidates: Optional[Iterable[int]] = None) -> Tuple[int, float]:
        """Hardware-mode selection: evaluate candidate books in parallel
        against the message histogram; return (book_id, bits/symbol)."""
        with self._lock:
            ids = list(candidates) if candidates is not None else list(
                range(len(self._by_id)))
            if not ids:
                raise ValueError("registry has no codebooks")
            lens = np.stack([self._by_id[i].lengths for i in ids])  # (k, n)
        pmf = pmf_from_counts(counts)
        ebits = lens.astype(np.float64) @ pmf                        # (k,)
        j = int(np.argmin(ebits))
        return ids[j], float(ebits[j])

    # ---------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """Persist the FULL registry state: books in ``book_id`` order,
        the EMA observation state, the epoch, and the build parameters.

        A ``load`` of this blob reproduces the registry exactly — same
        ``book_id``s, same lengths (codebook construction is
        deterministic), same EMA counts/``n_batches`` — so a spec built
        ``from_registry`` on the reload is hash-identical to the
        original.  That exactness is what makes the lifecycle manifest
        (repro.lifecycle.manager) trustworthy.
        """
        with self._lock:
            blob = {
                "format": np.array(2),
                "n_books": np.array(len(self._by_id)),
                "n_symbols": np.array(self.n_symbols),
                "ema": np.array(self.ema, np.float64),
                "max_len": np.array(self.max_len),
                "book_epoch": np.array(self._epoch),
                "codec": np.array(self.codec),
            }
            for i, book in enumerate(self._by_id):
                blob[f"lengths_{i}"] = book.lengths
                blob[f"counts_{i}"] = book.source_counts
                blob[f"key_{i}"] = np.array(list(book.key))
            rkeys = list(self._running)
            blob["n_running"] = np.array(len(rkeys))
            for j, key in enumerate(rkeys):
                blob[f"rkey_{j}"] = np.array(list(key))
                blob[f"rcounts_{j}"] = self._running[key].counts
                blob[f"rbatches_{j}"] = np.array(self._running[key].n_batches)
        np.savez(path, **blob)

    @classmethod
    def load(cls, path: str) -> "CodebookRegistry":
        blob = np.load(path, allow_pickle=False)
        if "format" not in blob.files:
            # Legacy (pre-lifecycle) blobs: books only, EMA state lost;
            # pre-codec blobs are by definition huffman.
            reg = cls(n_symbols=int(blob["n_symbols"]), codec="huffman")
            for i in range(int(blob["n_books"])):
                key = tuple(str(s) for s in blob[f"key_{i}"])
                reg.install(key, blob[f"counts_{i}"])
            return reg
        codec = (str(blob["codec"]) if "codec" in blob.files else "huffman")
        reg = cls(n_symbols=int(blob["n_symbols"]), ema=float(blob["ema"]),
                  max_len=int(blob["max_len"]), codec=codec)
        for i in range(int(blob["n_books"])):
            key = tuple(str(s) for s in blob[f"key_{i}"])
            book = build_codebook(blob[f"counts_{i}"], book_id=i, key=key,
                                  max_len=reg.max_len, codec=reg.codec)
            if not np.array_equal(book.lengths, blob[f"lengths_{i}"]):
                raise ValueError(
                    f"codebook {i} ({key}) did not rebuild to its saved "
                    f"lengths — blob corrupt or book construction drifted")
            reg._books[key] = book
            reg._by_id.append(book)
        for j in range(int(blob["n_running"])):
            key = tuple(str(s) for s in blob[f"rkey_{j}"])
            reg._running[key] = _RunningPMF(
                np.asarray(blob[f"rcounts_{j}"], np.float64),
                n_batches=int(blob[f"rbatches_{j}"]))
        reg._epoch = int(blob["book_epoch"])
        return reg
