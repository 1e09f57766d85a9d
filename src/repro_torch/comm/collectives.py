"""Compressed collective wrappers (port of ``repro.comm.collectives``).

Each wrapper performs the plain collective over an ``Axis`` and, when a
``CompressionSpec`` is enabled, adds the exact wire-traffic accounting
under the fixed codebook (ledger mode: B5's histogram · lengths of each
rank's payload, times the ring-algorithm egress factor):

  all_reduce       2(n-1)/n × payload     (reduce-scatter + all-gather)
  reduce_scatter    (n-1)/n × payload
  all_gather        (n-1)   × shard       (each shard forwarded n-1 times)
  all_to_all        (n-1)/n × payload
  ppermute                1 × payload

The plain collectives follow the ``jax.lax`` ones in a rank's body:
``psum`` (bf16 and e4m3 added in rank order, ``wire.rank_sum``),
``psum_scatter(tiled=True)``, ``all_gather``, ``all_to_all(tiled=True)``
and ``ppermute``.  Bitexact wire strategies live in ``comm.transport``;
the ``*_bitexact*`` functions here are the reference's thin aliases over
its registry.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.codebook import Codebook
from ..core.encoder import DEFAULT_CHUNK
from .axis import Axis, take_rows
from .compression import CompressionSpec, payload_stats
from .transport import (RING_FACTORS, TRANSPORTS, all_gather_compressed,
                        all_reduce_compressed, all_to_all_compressed,
                        reduce_scatter_compressed)
from .wire import _BITS

__all__ = [
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all", "ppermute",
    "all_gather_bitexact", "psum_bitexact",
    "all_gather_bitexact_chunked", "psum_bitexact_chunked",
    "all_gather_compressed", "all_reduce_compressed",
    "reduce_scatter_compressed", "all_to_all_compressed",
    "merge_stats", "zero_stats",
]

_KEYS = ("raw_wire_bits", "coded_wire_bits", "payload_raw_bits",
         "payload_coded_bits")


def zero_stats() -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float64)
    return {k: z for k in _KEYS}


def merge_stats(*stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = zero_stats()
    for s in stats:
        for k in out:
            out[k] = out[k] + s.get(k, 0.0)
    return out


def _wire_stats(op: str, x: torch.Tensor, axis: Axis,
                spec: CompressionSpec) -> Dict[str, torch.Tensor]:
    """Per-rank ledger stats of ``op`` on x (float64, batch shape)."""
    if not spec.enabled:
        return zero_stats()
    nl = len(axis.batch)
    factor = RING_FACTORS[op](axis.size)
    rows = x.reshape(-1, *x.shape[nl:]) if nl else x[None]
    per = [payload_stats(r, spec) for r in rows]
    raw = torch.stack([p["raw_bits"] for p in per]).reshape(axis.batch)
    coded = torch.stack([p["coded_bits"] for p in per]).reshape(axis.batch)
    return {"raw_wire_bits": factor * raw, "coded_wire_bits": factor * coded,
            "payload_raw_bits": raw, "payload_coded_bits": coded}


def _merge_dims(t: torch.Tensor, d: int) -> torch.Tensor:
    """Merge dims d and d + 1 of ``t``."""
    return t.reshape(*t.shape[:d], t.shape[d] * t.shape[d + 1],
                     *t.shape[d + 2:])


# ---------------------------------------------------------------- wrappers
def all_reduce(x: torch.Tensor, axis: Axis,
               spec: CompressionSpec = CompressionSpec.off()
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return axis.psum(x), _wire_stats("all_reduce", x, axis, spec)


def reduce_scatter(x: torch.Tensor, axis: Axis, *,
                   scatter_dimension: int = 0,
                   spec: CompressionSpec = CompressionSpec.off()):
    nl, n = len(axis.batch), axis.size
    d = nl + scatter_dimension
    full = axis.psum(x)
    parts = full.reshape(*full.shape[:d], n, full.shape[d] // n,
                         *full.shape[d + 1:]).movedim(d, nl)
    bits = _BITS.get(x.dtype, x.dtype)
    y = take_rows(parts.view(bits), axis.index(x.device), nl).view(x.dtype)
    return y, _wire_stats("reduce_scatter", x, axis, spec)


def all_gather(x: torch.Tensor, axis: Axis, *, axis_dim: int = 0,
               tiled: bool = True,
               spec: CompressionSpec = CompressionSpec.off()):
    """``jax.lax.all_gather(x, axis, axis=axis_dim, tiled=tiled)``."""
    nl = len(axis.batch)
    y = axis.all_gather(x).movedim(nl, nl + axis_dim)
    if tiled:
        y = _merge_dims(y, nl + axis_dim)
    return y, _wire_stats("all_gather", x, axis, spec)


def all_to_all(x: torch.Tensor, axis: Axis, *, split_axis: int,
               concat_axis: int,
               spec: CompressionSpec = CompressionSpec.off()):
    """``jax.lax.all_to_all(..., tiled=True)``: each rank splits x into
    n parts along ``split_axis``, part j goes to rank j, and the parts a
    rank receives are joined along ``concat_axis`` in source order."""
    nl, n = len(axis.batch), axis.size
    bits = _BITS.get(x.dtype, x.dtype)
    g = axis.all_gather(x.view(bits))           # batch + (n_src,) + s
    d = nl + 1 + split_axis
    g = g.reshape(*g.shape[:d], n, g.shape[d] // n, *g.shape[d + 1:])
    mine = take_rows(g.movedim(d, nl), axis.index(x.device), nl)
    y = _merge_dims(mine.movedim(nl, nl + concat_axis), nl + concat_axis)
    return y.view(x.dtype), _wire_stats("all_to_all", x, axis, spec)


def ppermute(x: torch.Tensor, axis: Axis, perm,
             spec: CompressionSpec = CompressionSpec.off()):
    return axis.permute(x, perm), _wire_stats("ppermute", x, axis, spec)


# ---------------------------------------------------- bitexact aliases
def all_gather_bitexact(x, axis: Axis, books: Dict[str, Codebook],
                        scheme_name: str = "bf16"):
    """Monolithic-transport all-gather (see transport.py)."""
    return TRANSPORTS["monolithic"].all_gather(x, axis, books, scheme_name)


def psum_bitexact(x, axis: Axis, books: Dict[str, Codebook],
                  scheme_name: str = "bf16"):
    """Monolithic-transport all-reduce (see transport.py)."""
    return TRANSPORTS["monolithic"].all_reduce(x, axis, books, scheme_name)


def all_gather_bitexact_chunked(x, axis: Axis, books: Dict[str, Codebook],
                                scheme_name: str = "bf16", *,
                                chunk: int = DEFAULT_CHUNK,
                                decode_backend: str = "pallas"):
    """Chunked-transport all-gather (see transport.py)."""
    return TRANSPORTS["chunked"].all_gather(x, axis, books, scheme_name,
                                            chunk=chunk,
                                            decode_backend=decode_backend)


def psum_bitexact_chunked(x, axis: Axis, books: Dict[str, Codebook],
                          scheme_name: str = "bf16", *,
                          chunk: int = DEFAULT_CHUNK,
                          decode_backend: str = "pallas"):
    """Chunked-transport all-reduce (see transport.py)."""
    return TRANSPORTS["chunked"].all_reduce(x, axis, books, scheme_name,
                                            chunk=chunk,
                                            decode_backend=decode_backend)
