"""Shard-statistics capture (port of ``repro.core.stats``) — the
measurement machinery behind the paper's Figures 2–4.

The paper analyzes 18 layers × 64 TPU shards = 1152 shards per tensor
kind.  ``ShardStatsCollector`` reproduces that: it snapshots named
tensors, splits them into (layer, shard) tiles with the geometry the
mesh would induce, counts each tile's per-plane symbol histograms and
hands them to the codebook registry.

``shard_histograms`` counts on the tensor's device: kernel B5
(``histogram256``, one launch a shard and plane) on the card, its plain
version on the CPU, with one copy of all counts to the host at the end.
The collector and ``per_shard_report`` are numpy on the host, as in the
reference, and give its arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .codebook import CodebookKey, CodebookRegistry, build_codebook
from .entropy import (compressibility, expected_code_length, kl_divergence,
                      pmf_from_counts, shannon_entropy)
from .symbols import SCHEMES, SymbolScheme

__all__ = ["shard_histograms", "ShardStatsCollector", "per_shard_report"]


def shard_histograms(x: torch.Tensor, scheme: SymbolScheme, n_shards: int,
                     layer_axis_len: int = 1) -> Dict[str, np.ndarray]:
    """Split ``x`` into ``layer_axis_len × n_shards`` shards and histogram
    each shard's symbol planes.

    Returns {plane: (n_layers*n_shards, n_symbols) int64} on the host.
    The shard split follows the model-parallel convention: the trailing
    feature axis is divided into ``n_shards`` contiguous tiles (what each
    device of a TP group holds); ``layer_axis_len`` splits the leading
    axis.
    """
    from ..kernels.histogram import histogram256
    arr = x.reshape(max(layer_axis_len, 1), -1, x.shape[-1])
    if arr.shape[-1] % n_shards:
        raise ValueError(f"feature dim {arr.shape[-1]} not divisible by "
                         f"{n_shards}")
    tile = arr.shape[-1] // n_shards
    hists: Dict[str, List[torch.Tensor]] = {p: [] for p in scheme.planes}
    for li in range(arr.shape[0]):
        for si in range(n_shards):
            shard = arr[li, :, si * tile:(si + 1) * tile]
            for p, sym in scheme.to_symbols(shard).items():
                hists[p].append(histogram256(sym)[:scheme.n_symbols])
    counts = torch.stack([torch.stack(hists[p]) for p in scheme.planes])
    host = counts.cpu().numpy()
    return {p: host[i] for i, p in enumerate(scheme.planes)}


@dataclass
class ShardStatsCollector:
    """Accumulates per-(tensor kind, plane) shard histograms across steps
    and feeds the average PMF into a CodebookRegistry."""
    scheme_name: str = "bf16"
    n_shards: int = 64
    registry: Optional[CodebookRegistry] = None
    _hists: Dict[Tuple[str, str], List[np.ndarray]] = field(
        default_factory=dict)

    @property
    def scheme(self) -> SymbolScheme:
        return SCHEMES[self.scheme_name]

    def capture(self, tensor_kind: str, x: torch.Tensor,
                layer_axis_len: int = 1) -> None:
        per_plane = shard_histograms(x, self.scheme, self.n_shards,
                                     layer_axis_len=layer_axis_len)
        for plane, h in per_plane.items():
            self._hists.setdefault((tensor_kind, plane), []).append(h)
            if self.registry is not None:
                key: CodebookKey = (tensor_kind, self.scheme_name, plane)
                self.registry.observe(key, h)

    def histograms(self, tensor_kind: str, plane: str) -> np.ndarray:
        """All captured shard histograms, stacked: (steps*shards, n_sym)."""
        return np.concatenate(self._hists[(tensor_kind, plane)], axis=0)

    def average_counts(self, tensor_kind: str, plane: str) -> np.ndarray:
        return self.histograms(tensor_kind, plane).sum(axis=0)

    def build_codebooks(self) -> CodebookRegistry:
        """Books from the captured histograms: the given registry (fed
        at every capture) rebuilt, or a new one fed all of them at once.
        The reference tests ``self.registry or ...``, so a given registry
        that holds no book yet (an empty one is falsy) is passed over for
        a new, empty one; the port rebuilds the given registry."""
        reg = self.registry
        if reg is None:
            reg = CodebookRegistry(self.scheme.n_symbols)
            for (kind, plane), hs in self._hists.items():
                key: CodebookKey = (kind, self.scheme_name, plane)
                reg.observe(key, np.concatenate(hs, axis=0))
        reg.rebuild()
        return reg


def per_shard_report(hists: np.ndarray, avg_lengths: np.ndarray,
                     symbol_bits: int = 8) -> Dict[str, np.ndarray]:
    """Per-shard metrics used by Figs 2–4 (float64): ideal (Shannon)
    compressibility, per-shard-Huffman compressibility, fixed-codebook
    compressibility and KL(shard ‖ average)."""
    hists = np.asarray(hists, dtype=np.int64)
    avg = hists.sum(axis=0)
    avg_pmf = pmf_from_counts(avg)
    n = hists.shape[0]
    ideal = np.zeros(n)
    per_shard = np.zeros(n)
    fixed = np.zeros(n)
    kl = np.zeros(n)
    for i in range(n):
        h = hists[i]
        ideal[i] = compressibility(shannon_entropy(h), symbol_bits)
        book = build_codebook(h)
        per_shard[i] = compressibility(expected_code_length(h, book.lengths),
                                       symbol_bits)
        fixed[i] = compressibility(expected_code_length(h, avg_lengths),
                                   symbol_bits)
        kl[i] = kl_divergence(pmf_from_counts(h), avg_pmf)
    return {"ideal": ideal, "per_shard_huffman": per_shard,
            "fixed_codebook": fixed, "kl_from_avg": kl}
