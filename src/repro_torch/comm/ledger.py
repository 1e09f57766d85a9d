"""Host-side collective-traffic ledger (port of ``repro.comm.ledger``;
pure Python, the same class).

A step returns compression stats (scalars, 0-d tensors or floats)
alongside its real outputs; the train/serve loop feeds them here.  The
ledger aggregates per-(tensor kind, op) raw vs coded wire traffic and
produces the numbers the roofline's collective term is scaled by.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

__all__ = ["CollectiveLedger", "LedgerEntry"]


@dataclass
class LedgerEntry:
    label: str
    raw_wire_bits: float = 0.0
    coded_wire_bits: float = 0.0
    calls: int = 0

    @property
    def ratio(self) -> float:
        return (self.coded_wire_bits / self.raw_wire_bits
                if self.raw_wire_bits else 1.0)

    @property
    def compressibility(self) -> float:
        return 1.0 - self.ratio


@dataclass
class CollectiveLedger:
    entries: Dict[str, LedgerEntry] = field(default_factory=dict)

    def record(self, label: str, stats: Dict[str, float]) -> None:
        e = self.entries.setdefault(label, LedgerEntry(label))
        e.raw_wire_bits += float(stats.get("raw_wire_bits", 0.0))
        e.coded_wire_bits += float(stats.get("coded_wire_bits", 0.0))
        e.calls += 1

    def record_tree(self, stats_tree: Dict[str, Dict[str, float]]) -> None:
        for label, stats in stats_tree.items():
            self.record(label, stats)

    def overall_ratio(self) -> float:
        raw = sum(e.raw_wire_bits for e in self.entries.values())
        coded = sum(e.coded_wire_bits for e in self.entries.values())
        return coded / raw if raw else 1.0

    def summary(self) -> List[Dict[str, float]]:
        return [{"label": e.label, "raw_GB": e.raw_wire_bits / 8e9,
                 "coded_GB": e.coded_wire_bits / 8e9, "ratio": e.ratio,
                 "compressibility": e.compressibility, "calls": e.calls}
                for e in self.entries.values()]

    def report(self) -> str:
        lines = [f"{'label':<32}{'raw GB':>12}{'coded GB':>12}"
                 f"{'ratio':>8}{'saved %':>9}{'calls':>7}"]
        for s in self.summary():
            lines.append(f"{s['label']:<32}{s['raw_GB']:>12.4f}"
                         f"{s['coded_GB']:>12.4f}{s['ratio']:>8.3f}"
                         f"{100 * s['compressibility']:>9.2f}{s['calls']:>7d}")
        if self.entries:
            lines.append(f"{'TOTAL':<32}{'':>32}{self.overall_ratio():>8.3f}")
        return "\n".join(lines)
