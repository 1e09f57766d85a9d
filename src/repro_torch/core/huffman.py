"""Huffman code construction: classic heap algorithm, length-limited
package-merge, and canonical code assignment.

All of this runs on host, off the critical path — the paper's point is
precisely that code *construction* is amortized over previous batches so
the encoder itself is single-stage.  We therefore optimize for clarity
and exactness here, not speed.

Canonical codes are essential for two reasons:
  * the encoder table is fully described by the length vector (256 bytes),
    which is what real systems ship/pin in hardware registers;
  * decoding reduces to the first-code/offset table walk, which encoder.py
    runs as a loop over output slots vectorised across chunks (and
    kernels/csrc/decode.cu as one thread per chunk).

This module is a verbatim copy of ``repro.core.huffman`` (pure NumPy):
the port imports nothing from the JAX package, and the parity tests hold
every table it builds equal to the reference's.

We length-limit to ``MAX_CODE_LEN = 16`` bits by default (package-merge,
optimal under the constraint).  This bounds worst-case expansion to 2x on
8-bit symbols, keeps decode tables tiny, and costs <0.1% compressibility
on the distributions the paper studies — a standard hardware-encoder
tradeoff (DEFLATE uses 15).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

__all__ = [
    "MAX_CODE_LEN",
    "MULTISYM_K",
    "MULTISYM_SMAX",
    "huffman_code_lengths",
    "package_merge_lengths",
    "canonical_codes",
    "CanonicalTables",
    "canonical_decode_tables",
    "MultiSymTables",
    "build_multisym_tables",
    "STEP_PTR_BITS",
    "STEP_CNT_BITS",
    "kraft_sum",
    "validate_prefix_free",
]

MAX_CODE_LEN = 16

# Multi-symbol decode-table defaults: a 2^K-entry direct-indexed window
# LUT emitting up to SMAX symbols per lookup.  K=13 keeps the tables at
# ~288 KB of int32 in VMEM (syms (8192, 8) + meta (8192,)) while covering
# every code the package-merge construction assigns except the rarest
# 14–16-bit tails, which take the canonical-walk slow path.
MULTISYM_K = 13
MULTISYM_SMAX = 8


def huffman_code_lengths(counts: np.ndarray) -> np.ndarray:
    """Classic (unbounded) Huffman code lengths via a binary heap.

    Symbols with zero count receive length 0 (no code).  Degenerate cases:
    a single nonzero symbol gets length 1 (it still needs one bit so the
    decoder can count symbols).
    """
    counts = np.asarray(counts, dtype=np.int64)
    n = counts.shape[0]
    lengths = np.zeros(n, dtype=np.int32)
    alive = [i for i in range(n) if counts[i] > 0]
    if not alive:
        return lengths
    if len(alive) == 1:
        lengths[alive[0]] = 1
        return lengths

    # Heap of (count, tiebreak, node). Leaves are ints; internal nodes are
    # [left, right] lists. Tiebreak keeps the build deterministic.
    tie = 0
    heap: list = []
    for i in alive:
        heapq.heappush(heap, (int(counts[i]), tie, i))
        tie += 1
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (c1 + c2, tie, [n1, n2]))
        tie += 1

    # Depth-first traversal assigns depths as code lengths.
    stack = [(heap[0][2], 0)]
    while stack:
        node, depth = stack.pop()
        if isinstance(node, list):
            stack.append((node[0], depth + 1))
            stack.append((node[1], depth + 1))
        else:
            lengths[node] = depth
    return lengths


def package_merge_lengths(counts: np.ndarray, max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Optimal length-limited code lengths via the package-merge algorithm.

    Runs in O(n·max_len) — trivial for n=256.  Zero-count symbols get no
    code (length 0); callers that must code *any* byte (fixed codebooks!)
    should floor-smooth their histograms first (codebook.py does).
    """
    counts = np.asarray(counts, dtype=np.int64)
    n = counts.shape[0]
    alive = np.nonzero(counts > 0)[0]
    m = alive.size
    lengths = np.zeros(n, dtype=np.int32)
    if m == 0:
        return lengths
    if m == 1:
        lengths[alive[0]] = 1
        return lengths
    if m > (1 << max_len):
        raise ValueError(f"cannot code {m} symbols within {max_len} bits")

    # Each item is (weight, frozenset-of-leaf-indices) conceptually; we
    # carry leaf multiplicity via a count vector per package to stay exact.
    # packages[l] = list of (weight, leaf_count_vector_index) — we store
    # leaf membership as a list of leaf indices (packages stay small in
    # aggregate: total work bounded by 2*m per level).
    leaves = sorted((int(counts[i]), int(i)) for i in alive)

    def merge_level(prev_packages):
        """One package-merge level: package pairs from prev, merge with leaves."""
        packaged = []
        for k in range(0, len(prev_packages) - 1, 2):
            w1, s1 = prev_packages[k]
            w2, s2 = prev_packages[k + 1]
            packaged.append((w1 + w2, s1 + s2))
        merged: list = []
        li, pi = 0, 0
        while li < len(leaves) or pi < len(packaged):
            take_leaf = pi >= len(packaged) or (
                li < len(leaves) and leaves[li][0] <= packaged[pi][0])
            if take_leaf:
                w, idx = leaves[li]
                merged.append((w, [idx]))
                li += 1
            else:
                merged.append(packaged[pi])
                pi += 1
        return merged

    packages = [(w, [i]) for w, i in leaves]
    for _ in range(max_len - 1):
        packages = merge_level(packages)

    # The first 2m-2 items of the final level; each appearance of leaf i
    # adds one to its code length.
    for _, members in packages[: 2 * m - 2]:
        for i in members:
            lengths[i] += 1
    return lengths


def kraft_sum(lengths: np.ndarray) -> float:
    """Σ 2^-l over coded symbols — exactly 1.0 for a complete prefix code."""
    lengths = np.asarray(lengths)
    coded = lengths[lengths > 0].astype(np.float64)
    return float(np.sum(2.0 ** (-coded)))


@dataclass(frozen=True)
class CanonicalTables:
    """Decode-side tables for canonical Huffman codes.

    first_code[l]  — canonical code value of the first code of length l
    base_index[l]  — index into sorted_symbols of that first code
    num_codes[l]   — number of codes of length l
    sorted_symbols — symbols ordered by (length, symbol value)
    max_len        — table extent
    """
    first_code: np.ndarray   # (max_len+1,) int32
    base_index: np.ndarray   # (max_len+1,) int32
    num_codes: np.ndarray    # (max_len+1,) int32
    sorted_symbols: np.ndarray  # (n_coded,) int32
    max_len: int


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codewords (MSB-first, right-aligned in uint32).

    Canonical rule: codes are assigned in order of (length, symbol);
    the first code of length l is (first_code[l-1] + num[l-1]) << 1.
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    max_len = int(lengths.max(initial=0))
    codes = np.zeros(lengths.shape[0], dtype=np.uint32)
    if max_len == 0:
        return codes
    num = np.bincount(lengths, minlength=max_len + 1)
    num[0] = 0
    code = 0
    next_code = np.zeros(max_len + 1, dtype=np.int64)
    for l in range(1, max_len + 1):
        code = (code + num[l - 1]) << 1
        next_code[l] = code
    order = np.lexsort((np.arange(lengths.shape[0]), lengths))
    for sym in order:
        l = lengths[sym]
        if l == 0:
            continue
        codes[sym] = next_code[l]
        next_code[l] += 1
    return codes


def canonical_decode_tables(lengths: np.ndarray,
                            max_len: int = MAX_CODE_LEN) -> CanonicalTables:
    lengths = np.asarray(lengths, dtype=np.int32)
    if int(lengths.max(initial=0)) > max_len:
        raise ValueError("code lengths exceed table extent")
    num = np.bincount(lengths, minlength=max_len + 1).astype(np.int32)
    num[0] = 0
    first_code = np.zeros(max_len + 1, dtype=np.int32)
    base_index = np.zeros(max_len + 1, dtype=np.int32)
    code, idx = 0, 0
    for l in range(1, max_len + 1):
        code = (code + num[l - 1]) << 1
        first_code[l] = code
        base_index[l] = idx
        idx += num[l]
    order = np.lexsort((np.arange(lengths.shape[0]), lengths))
    sorted_symbols = np.array([s for s in order if lengths[s] > 0], dtype=np.int32)
    return CanonicalTables(first_code=first_code, base_index=base_index,
                           num_codes=num, sorted_symbols=sorted_symbols,
                           max_len=max_len)


@dataclass(frozen=True)
class MultiSymTables:
    """Direct-indexed multi-symbol decode tables for one codebook.

    ``syms[w, j]`` — the j-th symbol decoded from the K-bit window ``w``
    (0 past the entry's count); ``meta[w]`` packs ``count | bits << 8``:
    how many complete codewords the window contains (capped at s_max)
    and how many bits they consume together.  ``count == 0`` marks the
    slow path: the window's first codeword is longer than K bits and
    must be resolved by the canonical walk over lengths K+1..max_len.

    ``meta_full`` is the same (count | bits << 8) packing indexed by the
    *full* max_len-bit window: identical to ``meta`` for fast windows,
    but its slow entries carry the long code's true length in the bits
    field (decidable from max_len real bits), so a decoder stepping with
    ``meta_full`` needs no in-loop canonical walk at all — only the
    emitted *symbol* of a slow window is left to the walk, off the
    sequential path.

    ``sym_full`` gives the *first* symbol of every max_len-bit window —
    the emission side of the slow path: a decoder that recorded a slow
    window resolves its one symbol with this single gather instead of
    re-running the canonical walk.

    ``step_tab`` / ``emit_tab`` are the same information folded for the
    XLA window-replay scan, whose sequential body must be as close to
    one gather as possible: ``emit_tab`` concatenates the flattened LUT
    rows with ``sym_full`` (so a slow window's symbol is just an index
    past ``2^k * s_max``), and ``step_tab[w]`` packs the *absolute*
    emit-table pointer of w's first symbol with its count and bit
    advance — ``ptr | count << 21 | bits << 26`` (count already floored
    to 1 for slow windows).  Replaying a window is then ``ptr + 1`` per
    step and emission is a single ``emit_tab[ptr]`` gather.

    Codes are fixed per batch (the single-stage property), so this table
    is built once per codebook on host and reused for every stream.
    """
    syms: np.ndarray       # (2^k, s_max) int32
    meta: np.ndarray       # (2^k,) int32 — count | bits_consumed << 8
    meta_full: np.ndarray  # (2^max_len,) int32 — slow bits = code length
    sym_full: np.ndarray   # (2^max_len,) int32 — first symbol of window
    step_tab: np.ndarray   # (2^max_len,) int32 — ptr | cnt<<21 | bits<<26
    emit_tab: np.ndarray   # (2^k * s_max + 2^max_len,) int32 symbols
    k: int
    s_max: int
    max_len: int


# step_tab bit layout: ptr ≤ 2^k·s_max + 2^max_len ≤ 2^20 + 2^16 < 2^21,
# count ≤ s_max ≤ 16 (5 bits), bit advance ≤ max_len ≤ 16 (5 bits).
STEP_PTR_BITS = 21
STEP_CNT_BITS = 5


def build_multisym_tables(lengths: np.ndarray, *, k: int = MULTISYM_K,
                          s_max: int = MULTISYM_SMAX,
                          max_len: int = MAX_CODE_LEN) -> MultiSymTables:
    """Precompute the K-bit window → (symbols, count, bits) decode LUT.

    For every K-bit window value we greedily decode canonical codewords
    until the next one no longer fits inside the window (or s_max is
    reached).  Correctness of the zero-padded simulation: validity of a
    candidate length l ≤ remaining-bits depends only on real window
    bits, so any code accepted here is exactly what a sequential decoder
    of the true stream would emit; a smallest-valid length that needs
    padded bits means the true codeword overruns the window, which is
    precisely the stop condition.
    """
    if not 1 <= k <= max_len:
        raise ValueError(f"k must be in [1, {max_len}], got {k}")
    t = canonical_decode_tables(lengths, max_len)
    size = 1 << k
    fc = t.first_code.astype(np.int64)
    nc = t.num_codes.astype(np.int64)
    bi = t.base_index.astype(np.int64)
    ss = t.sorted_symbols.astype(np.int64)

    # Windows left-aligned in 32 bits; zeros shift in as codes are consumed.
    win = np.arange(size, dtype=np.uint64) << np.uint64(32 - k)
    syms = np.zeros((size, s_max), dtype=np.int32)
    count = np.zeros(size, dtype=np.int64)
    consumed = np.zeros(size, dtype=np.int64)
    active = np.ones(size, dtype=bool)
    for j in range(s_max):
        w = (win >> np.uint64(32 - max_len)).astype(np.int64)
        l = np.zeros(size, dtype=np.int64)
        off = np.zeros(size, dtype=np.int64)
        found = np.zeros(size, dtype=bool)
        for ll in range(1, max_len + 1):
            o = (w >> (max_len - ll)) - fc[ll]
            ok = ~found & (o >= 0) & (o < nc[ll])
            l = np.where(ok, ll, l)
            off = np.where(ok, o, off)
            found |= ok
        fits = active & found & (consumed + l <= k)
        if ss.size:
            sym = ss[np.clip(bi[l] + off, 0, ss.size - 1)]
            syms[:, j] = np.where(fits, sym, 0)
        count += fits
        consumed = np.where(fits, consumed + l, consumed)
        win = np.where(fits, (win << l.astype(np.uint64))
                       & np.uint64(0xFFFFFFFF), win)
        active &= fits
        if not active.any():
            break
    meta = (count | (np.where(count > 0, consumed, 0) << 8)).astype(np.int32)

    # Full-window meta: fast windows share the K-bit entry (their count
    # and bits depend only on the first K bits — proved by the padding
    # argument above); slow windows store the first code's true length,
    # which max_len real bits always decide.  Corrupt windows (no valid
    # code at any length) advance max_len bits — valid streams never
    # read them before their symbol count is exhausted.
    w = np.arange(1 << max_len, dtype=np.int64)
    l1 = np.zeros(w.shape[0], dtype=np.int64)
    off1 = np.zeros(w.shape[0], dtype=np.int64)
    found = np.zeros(w.shape[0], dtype=bool)
    for ll in range(1, max_len + 1):
        o = (w >> (max_len - ll)) - fc[ll]
        ok = ~found & (o >= 0) & (o < nc[ll])
        l1 = np.where(ok, ll, l1)
        off1 = np.where(ok, o, off1)
        found |= ok
    if ss.size:
        sym_full = np.where(
            found, ss[np.clip(bi[l1] + off1, 0, ss.size - 1)], 0
        ).astype(np.int32)
    else:
        sym_full = np.zeros(w.shape[0], dtype=np.int32)
    l1 = np.where(found, l1, max_len)
    k_meta = meta[w >> (max_len - k)]
    meta_full = np.where(k_meta & 0xFF, k_meta, l1 << 8).astype(np.int32)

    # Folded tables for the XLA window-replay scan (see class docstring).
    emit_tab = np.concatenate([syms.reshape(-1), sym_full]).astype(np.int32)
    cnt_f = meta_full & 0xFF
    ptr = np.where(cnt_f > 0, (w >> (max_len - k)) * s_max,
                   size * s_max + w)
    step_tab = (ptr | np.maximum(cnt_f, 1) << STEP_PTR_BITS
                | (meta_full >> 8) << (STEP_PTR_BITS + STEP_CNT_BITS)
                ).astype(np.int32)
    return MultiSymTables(syms=syms, meta=meta, meta_full=meta_full,
                          sym_full=sym_full, step_tab=step_tab,
                          emit_tab=emit_tab, k=k, s_max=s_max,
                          max_len=max_len)


def validate_prefix_free(lengths: np.ndarray) -> None:
    """Raise if the length vector cannot form a prefix code (Kraft > 1)."""
    k = kraft_sum(lengths)
    if k > 1.0 + 1e-12:
        raise ValueError(f"Kraft inequality violated: {k} > 1")
