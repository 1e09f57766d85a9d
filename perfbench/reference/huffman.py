"""Plain code-length arithmetic of the wire: byte planes, 256-bin
histograms, length-limited Huffman lengths and coded sizes.

``package_merge_lengths`` is a frozen copy of the package-merge in the
port's ``core/huffman.py`` (a book is floor-smoothed to a count of at
least 1 a symbol and limited to 16 bits, as ``build_codebook`` does),
so the benchmark works the books out again from the same histograms
instead of reading the program's.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

MAX_LEN = 16
PLANES = ("lo", "hi")


def bf16_planes(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The low and high bytes of each bfloat16 value, as int64."""
    v = x.to(torch.bfloat16).reshape(-1).view(torch.int16).to(torch.int64)
    v = v & 0xFFFF
    return {"lo": v & 0xFF, "hi": v >> 8}


def histogram(sym: torch.Tensor) -> np.ndarray:
    return torch.bincount(sym.reshape(-1), minlength=256).cpu().numpy(
    ).astype(np.int64)


def package_merge_lengths(counts: np.ndarray,
                          max_len: int = MAX_LEN) -> np.ndarray:
    """Optimal code lengths of at most ``max_len`` bits (0 for a symbol
    that never occurs)."""
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
    leaves = sorted((int(counts[i]), int(i)) for i in alive)

    def merge_level(prev):
        packaged = [(prev[k][0] + prev[k + 1][0], prev[k][1] + prev[k + 1][1])
                    for k in range(0, len(prev) - 1, 2)]
        merged, li, pi = [], 0, 0
        while li < len(leaves) or pi < len(packaged):
            if pi >= len(packaged) or (li < len(leaves)
                                       and leaves[li][0] <= packaged[pi][0]):
                merged.append((leaves[li][0], [leaves[li][1]]))
                li += 1
            else:
                merged.append(packaged[pi])
                pi += 1
        return merged

    packages = [(w, [i]) for w, i in leaves]
    for _ in range(max_len - 1):
        packages = merge_level(packages)
    for _, members in packages[:2 * m - 2]:
        for i in members:
            lengths[i] += 1
    return lengths


def book_lengths(counts: np.ndarray) -> np.ndarray:
    """A fixed book's lengths from a histogram: every symbol counted at
    least once, so the code is total."""
    return package_merge_lengths(np.maximum(np.asarray(counts), 1))


def books_of(x: torch.Tensor) -> Dict[str, np.ndarray]:
    """Each plane's book lengths from the histogram of ``x``."""
    return {p: book_lengths(histogram(s)) for p, s in bf16_planes(x).items()}


def coded_bits(x: torch.Tensor, lengths: Dict[str, np.ndarray]) -> int:
    """Bits of ``x``'s planes under the books, summed exactly."""
    total = 0
    for p, s in bf16_planes(x).items():
        total += int((histogram(s) * lengths[p].astype(np.int64)).sum())
    return total
