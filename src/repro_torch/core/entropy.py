"""Information-theoretic primitives: PMFs, Shannon entropy, KL divergence,
compressibility.

These are the measurement half of the paper: Fig. 1 (PMF), Fig. 2/4
(ideal = Shannon compressibility), Fig. 3 (KL of each shard from the
average PMF).  All functions accept either raw counts or normalized PMFs
and are pure NumPy — they run on host, off the critical path, exactly
where the paper puts codebook maintenance.

A verbatim copy of ``repro.core.entropy``: the port imports nothing from
the JAX package.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "pmf_from_counts",
    "shannon_entropy",
    "cross_entropy",
    "kl_divergence",
    "compressibility",
    "expected_code_length",
    "huffman_compressibility",
]


def pmf_from_counts(counts: np.ndarray, axis: int = -1) -> np.ndarray:
    """Normalize histogram counts into a probability mass function.

    Zero-total histograms return the uniform distribution (the natural
    prior for an empty observation window).
    """
    counts = np.asarray(counts, dtype=np.float64)
    total = counts.sum(axis=axis, keepdims=True)
    n = counts.shape[axis]
    uniform = np.full_like(counts, 1.0 / n)
    with np.errstate(divide="ignore", invalid="ignore"):
        pmf = np.where(total > 0, counts / np.where(total > 0, total, 1.0), uniform)
    return pmf


def shannon_entropy(pmf_or_counts: np.ndarray, axis: int = -1) -> np.ndarray:
    """Shannon entropy in bits.  Accepts counts (normalized internally)."""
    p = pmf_from_counts(pmf_or_counts, axis=axis)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p > 0, -p * np.log2(np.where(p > 0, p, 1.0)), 0.0)
    return terms.sum(axis=axis)


def cross_entropy(p: np.ndarray, q: np.ndarray, axis: int = -1) -> np.ndarray:
    """H(p, q) in bits — the expected code length of coding p with an ideal
    code for q.  Infinite where q assigns zero mass to p-support; callers
    building codebooks avoid this with floor smoothing (see codebook.py).
    """
    p = pmf_from_counts(p, axis=axis)
    q = pmf_from_counts(q, axis=axis)
    with np.errstate(divide="ignore", invalid="ignore"):
        logq = np.where(q > 0, np.log2(np.where(q > 0, q, 1.0)), -np.inf)
        terms = np.where(p > 0, -p * logq, 0.0)
    return terms.sum(axis=axis)


def kl_divergence(p: np.ndarray, q: np.ndarray, axis: int = -1) -> np.ndarray:
    """D_KL(p ‖ q) in bits (Fig. 3 uses this against the average PMF)."""
    return cross_entropy(p, q, axis=axis) - shannon_entropy(p, axis=axis)


def compressibility(bits_per_symbol: np.ndarray, symbol_bits: int = 8) -> np.ndarray:
    """The paper's compressibility metric: (raw - coded) / raw.

    E.g. entropy 6.25 bits on 8-bit symbols → (8 - 6.25) / 8 ≈ 21.9 %.
    """
    return (symbol_bits - np.asarray(bits_per_symbol, dtype=np.float64)) / symbol_bits


def expected_code_length(pmf_or_counts: np.ndarray, lengths: np.ndarray,
                         axis: int = -1) -> np.ndarray:
    """Expected bits/symbol when coding the distribution with the given
    per-symbol code lengths.  This is the ledger-mode cost: a histogram ·
    length dot product, cheap enough for the critical path."""
    p = pmf_from_counts(pmf_or_counts, axis=axis)
    return (p * np.asarray(lengths, dtype=np.float64)).sum(axis=axis)


def huffman_compressibility(counts: np.ndarray, lengths: np.ndarray,
                            symbol_bits: int = 8) -> float:
    """Compressibility achieved by a concrete code on a concrete histogram."""
    return float(compressibility(expected_code_length(counts, lengths), symbol_bits))
