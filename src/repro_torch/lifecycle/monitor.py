"""Online codebook-drift monitor — when does a fixed book go stale?

The paper's single-stage claim (§4) rests on codebooks derived from the
average PMF of *previous* batches; its "within 0.5% of per-shard
Huffman" result implicitly assumes those books track the traffic.  This
module measures that assumption per ``CodebookKey`` from the per-plane
histograms the ledger/bitexact paths already compute (the probe a
hardware encoder gets for free), entirely on the host and off the
critical path:

  * **realized coded bits** — ``counts · lengths``, the exact payload
    the installed book produces on this window;
  * **KL divergence** — ``D_KL(window ‖ book source PMF)``, how far the
    traffic has moved from the distribution the book was built for;
  * **Shannon gap** — realized bits/symbol minus the window's own
    entropy, split into the book's *baseline* redundancy (integer code
    lengths never reach entropy, even on their own source) and the
    **excess** caused by drift.  The excess is exactly 0 when the window
    *is* the book's source distribution, and it is the recoverable part:
    a rebuild claws back ≈``excess`` bits/symbol, never the baseline.

Staleness is a thresholded, hysteresis-guarded signal: a window trips
when ``kl_bits`` or ``excess_bits`` exceeds its threshold (tiny windows
are ignored — their histograms are noise), and the monitor raises the
refresh ``signal`` only after ``patience`` consecutive tripped windows,
so one outlier batch cannot force a recompile.

A copy of ``repro.lifecycle.monitor`` (host numpy, float64) on the
port's ``core.codebook`` and ``core.entropy``: its reports equal the
reference's field for field on the same histograms and books.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..core.codebook import Codebook, CodebookKey
from ..core.entropy import (expected_code_length, kl_divergence,
                            shannon_entropy)

__all__ = ["DriftThresholds", "DriftReport", "DriftMonitor"]


@dataclass(frozen=True)
class DriftThresholds:
    """Configurable staleness policy (bits are per symbol)."""
    kl_bits: float = 0.05       # D_KL(window ‖ book source) trip point
    excess_bits: float = 0.05   # drift-caused redundancy trip point
    min_symbols: int = 4096     # ignore windows smaller than this
    patience: int = 2           # consecutive stale windows before signal

    def __post_init__(self):
        if self.kl_bits < 0 or self.excess_bits < 0:
            raise ValueError("thresholds must be non-negative")
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")


@dataclass(frozen=True)
class DriftReport:
    """One observation window's drift measurement for one book."""
    key: CodebookKey
    book_id: int
    n_symbols: int
    realized_bits: float       # counts · lengths (exact payload)
    coded_bps: float           # realized bits / symbol
    shannon_bps: float         # the window's own entropy
    baseline_bps: float        # book redundancy on its OWN source PMF
    excess_bits: float         # coded − shannon − baseline (drift part)
    kl_bits: float             # D_KL(window ‖ book source PMF)
    stale: bool                # this window tripped a threshold
    signal: bool               # stale for >= patience consecutive windows


class DriftMonitor:
    """Per-key drift tracking over observation windows.

    Passive by design: the caller (normally a ``BookLifecycleManager``)
    supplies the installed ``Codebook`` with each histogram, so the
    monitor never holds registry references that could go stale across
    an epoch flip.  ``reset(key)`` clears the staleness streak after a
    refresh; totals keep accumulating for reporting.
    """

    def __init__(self, thresholds: Optional[DriftThresholds] = None):
        self.thresholds = thresholds or DriftThresholds()
        self._streak: Dict[CodebookKey, int] = {}
        self._last: Dict[CodebookKey, DriftReport] = {}
        self.n_windows = 0
        self.total_realized_bits = 0.0
        self.total_shannon_bits = 0.0

    def observe(self, key: CodebookKey, counts: np.ndarray,
                book: Codebook) -> DriftReport:
        """Measure one window's histogram against the installed book."""
        if book.key != key and book.key != ("", "", ""):
            raise ValueError(f"book {book.key} observed under key {key}")
        counts = np.asarray(counts, dtype=np.float64)
        n = float(counts.sum())
        lengths = book.lengths.astype(np.float64)
        coded_bps = float(expected_code_length(counts, lengths))
        shannon_bps = float(shannon_entropy(counts))
        # The book's redundancy on its own source — computed with the
        # identical expression so excess is exactly 0.0 when the window
        # equals the source distribution.
        baseline_bps = (float(expected_code_length(book.source_counts,
                                                   lengths))
                        - float(shannon_entropy(book.source_counts)))
        excess = coded_bps - shannon_bps - baseline_bps
        kl = float(kl_divergence(counts, book.source_counts))
        th = self.thresholds
        stale = (n >= th.min_symbols
                 and (kl > th.kl_bits or excess > th.excess_bits))
        streak = self._streak.get(key, 0) + 1 if stale else 0
        self._streak[key] = streak
        report = DriftReport(
            key=key, book_id=book.book_id, n_symbols=int(n),
            realized_bits=coded_bps * n, coded_bps=coded_bps,
            shannon_bps=shannon_bps, baseline_bps=baseline_bps,
            excess_bits=excess, kl_bits=kl, stale=stale,
            signal=streak >= th.patience)
        self._last[key] = report
        self.n_windows += 1
        self.total_realized_bits += report.realized_bits
        self.total_shannon_bits += shannon_bps * n
        return report

    def last(self, key: CodebookKey) -> Optional[DriftReport]:
        return self._last.get(key)

    def stale_keys(self) -> List[CodebookKey]:
        """Keys whose staleness signal is currently raised."""
        return [k for k, r in self._last.items() if r.signal
                and self._streak.get(k, 0) >= self.thresholds.patience]

    def reset(self, key: Optional[CodebookKey] = None) -> None:
        """Clear the staleness streak (after a refresh installs a fresh
        book); ``key=None`` resets every tracked key."""
        from dataclasses import replace
        keys = [key] if key is not None else list(self._streak)
        for k in keys:
            self._streak[k] = 0
            if k in self._last:
                self._last[k] = replace(self._last[k], signal=False)
