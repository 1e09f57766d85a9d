"""Synthetic data pipeline (port of ``repro.data.pipeline``):
deterministic token batches.

Real deployments plug a tokenized corpus in here; the framework needs a
substrate that is reproducible and produces realistic *symbol
statistics* for the compression study (token streams follow a Zipf
law).  Batches are numpy arrays drawn from ``numpy``'s generator with
the reference's calls in the reference's order, so for the same config
and seed they equal the reference's bit for bit; the caller moves them
to its device.  Prefix embeddings (VLM/audio) wait for those configs
(ROADMAP.md A8).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from ..models.common import ModelConfig

__all__ = ["DataConfig", "SyntheticDataset", "batch_spec"]


@dataclass(frozen=True)
class DataConfig:
    batch_size: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2          # token frequency law
    pad_id: int = 0


def batch_spec(cfg: ModelConfig, data: DataConfig) -> Dict[str, tuple]:
    """Shapes/dtypes of one batch."""
    shape = (data.batch_size, data.seq_len)
    return {"tokens": (shape, np.int32), "labels": (shape, np.int32)}


class SyntheticDataset:
    """Infinite iterator of synthetic ``tokens``/``labels`` batches."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        self._rng = np.random.default_rng(data.seed)

    def _tokens(self, shape) -> np.ndarray:
        z = self._rng.zipf(self.data.zipf_a, size=shape).astype(np.int64)
        return np.minimum(z, self.cfg.vocab_size - 1).astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b, s = self.data.batch_size, self.data.seq_len
        toks = self._tokens((b, s + 1))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
