"""Synthetic data pipeline (port of ``repro.data.pipeline``):
deterministic token and embedding batches.

Real deployments plug a tokenized corpus in here; the framework needs a
substrate that is reproducible and produces realistic *symbol
statistics* for the compression study (token streams follow a Zipf
law, prefix embeddings are Gaussian like ViT or audio-codec outputs).
Batches are numpy arrays drawn from ``numpy``'s generator with the
reference's calls in the reference's order, so for the same config and
seed they equal the reference's bit for bit; the caller moves them to
its device.  A VLM batch (``prefix_len > 0``) adds ``prefix_embeds``
(B, prefix_len, d) after its tokens; a prefix-only (audio) batch is
``prefix_embeds`` (B, S, d) and ``labels``, with no ``tokens``.
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
    spec: Dict[str, tuple] = {}
    if not cfg.prefix_only:
        spec["tokens"] = (shape, np.int32)
        spec["labels"] = (shape, np.int32)
    if cfg.prefix_len > 0 or cfg.prefix_only:
        n = data.seq_len if cfg.prefix_only else cfg.prefix_len
        spec["prefix_embeds"] = ((data.batch_size, n, cfg.d_model),
                                 np.float32)
    if cfg.prefix_only:
        spec["labels"] = (shape, np.int32)
    return spec


class SyntheticDataset:
    """Infinite iterator of synthetic batches with the model's keys."""

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
        b, s, d = self.data.batch_size, self.data.seq_len, self.cfg.d_model
        if self.cfg.prefix_only:
            emb = self._rng.normal(size=(b, s, d)).astype(np.float32)
            return {"prefix_embeds": emb, "labels": self._tokens((b, s))}
        toks = self._tokens((b, s + 1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.prefix_len > 0:
            batch["prefix_embeds"] = self._rng.normal(
                size=(b, self.cfg.prefix_len, d)).astype(np.float32)
        return batch
