"""Wire-compression spec + on-device payload accounting (port of
``repro.comm.compression``).

A ``CompressionSpec`` is the device-side view of the codebook registry
for one tensor kind: the per-plane code-length vectors as constants,
plus the static wire knobs (transport, chunk, codec, decode backend).
It is a frozen, hashable dataclass with the reference's fields,
validation and ``"auto"`` resolution, so a spec built for the JAX
package builds the same here.

Modes: ``off`` (nothing), ``ledger`` (exact coded size by histogram ·
lengths, no coding), ``bitexact`` (encode → decode and check).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.codebook import Codebook, CodebookRegistry
from ..core.encoder import DEFAULT_CHUNK
from ..core.symbols import SCHEMES, SymbolScheme
# The ledger's exact 256-bin histogram (the reference's
# ``histogram256_xla``): kernel B5 on the card, with no host sync inside
# a decode step.
from ..kernels.histogram import histogram256

__all__ = ["CompressionSpec", "payload_stats", "histogram256",
           "shannon_bits", "KNOWN_TRANSPORTS"]

_MODES = ("off", "ledger", "bitexact")
KNOWN_TRANSPORTS = ("monolithic", "chunked", "ring")
_CARRIES = ("wire", "f32")


def shannon_bits(hist: torch.Tensor) -> torch.Tensor:
    """Shannon payload bits of a histogram (``total × H``), float64."""
    h = hist.to(torch.float64)
    p = h / torch.clamp(h.sum(), min=1.0)
    logp = torch.where(p > 0, torch.log2(torch.where(p > 0, p, 1.0)), 0.0)
    return -(h * logp).sum()


@dataclass(frozen=True, eq=True)
class CompressionSpec:
    """Device-side fixed-codebook description for one tensor kind."""
    mode: str = "off"                    # off | ledger | bitexact
    scheme_name: str = "bf16"
    tensor_kind: str = "generic"
    # plane -> tuple of 256 code lengths (tuples keep the spec hashable)
    plane_lengths: Optional[Tuple[Tuple[str, Tuple[int, ...]], ...]] = None
    book_ids: Optional[Tuple[Tuple[str, int], ...]] = None
    book_epoch: int = 0
    transport: str = "monolithic"        # monolithic | chunked | ring
    chunk: int = DEFAULT_CHUNK           # chunked/ring symbols per chunk
    codec: str = "auto"                  # resolved at construction
    decode_backend: str = "auto"         # resolved to the codec's default
    carry: str = "wire"                  # wire | f32 (ring only)
    axes: Optional[Tuple[str, str]] = None   # two-axis ring (ring only)

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown mode {self.mode!r}; one of {_MODES}")
        if self.transport not in KNOWN_TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r}; "
                             f"one of {KNOWN_TRANSPORTS}")
        from ..core.codec import default_codec, get_codec
        codec_name = (default_codec() if self.codec == "auto" else self.codec)
        codec = get_codec(codec_name)    # raises on unknown codec
        backend = codec.resolve_backend(self.decode_backend)
        object.__setattr__(self, "codec", codec_name)
        object.__setattr__(self, "decode_backend", backend)
        if self.carry not in _CARRIES:
            raise ValueError(f"unknown carry {self.carry!r}; "
                             f"one of {_CARRIES}")
        if self.carry != "wire" and self.transport != "ring":
            raise ValueError(f"carry={self.carry!r} requires the ring "
                             f"transport, got {self.transport!r}")
        if self.axes is not None:
            if (not isinstance(self.axes, tuple) or len(self.axes) != 2
                    or not all(isinstance(a, str) and a for a in self.axes)
                    or self.axes[0] == self.axes[1]):
                raise ValueError(
                    f"axes must be two distinct mesh axis names "
                    f"(inner, outer), got {self.axes!r}")
            if self.transport != "ring":
                raise ValueError(
                    f"axes={self.axes!r} (hierarchical two-axis ring) "
                    f"requires the ring transport, got {self.transport!r}")
        if self.chunk <= 0:
            raise ValueError(f"chunk must be positive, got {self.chunk}")
        if self.book_epoch < 0:
            raise ValueError(f"book_epoch must be >= 0, "
                             f"got {self.book_epoch}")

    @property
    def scheme(self) -> SymbolScheme:
        return SCHEMES[self.scheme_name]

    @property
    def enabled(self) -> bool:
        return self.mode != "off" and self.plane_lengths is not None

    def lengths_for(self, plane: str) -> np.ndarray:
        """The 256 code lengths of ``plane`` (int32)."""
        return np.asarray(dict(self.plane_lengths)[plane], dtype=np.int32)

    @classmethod
    def off(cls) -> "CompressionSpec":
        """The spec that codes nothing (every collective's default)."""
        return cls(mode="off")

    @classmethod
    def from_registry(cls, registry: CodebookRegistry, tensor_kind: str,
                      scheme_name: str = "bf16", mode: str = "ledger",
                      transport: str = "monolithic",
                      chunk: int = DEFAULT_CHUNK,
                      decode_backend: str = "auto",
                      carry: str = "wire",
                      axes: Optional[Tuple[str, str]] = None,
                      book_epoch: Optional[int] = None,
                      codec: Optional[str] = None
                      ) -> "CompressionSpec":
        scheme = SCHEMES[scheme_name]
        lens = []
        ids = []
        for plane in scheme.planes:
            book = registry.get((tensor_kind, scheme_name, plane))
            lens.append((plane, tuple(int(v) for v in book.lengths)))
            ids.append((plane, book.book_id))
        if book_epoch is None:
            book_epoch = getattr(registry, "book_epoch",
                                 getattr(registry, "epoch", 0))
        if codec is None:
            codec = getattr(registry, "codec", "huffman")
        return cls(mode=mode, scheme_name=scheme_name, tensor_kind=tensor_kind,
                   plane_lengths=tuple(lens), book_ids=tuple(ids),
                   transport=transport, chunk=chunk, codec=codec,
                   decode_backend=decode_backend, carry=carry, axes=axes,
                   book_epoch=book_epoch)

    @classmethod
    def from_books(cls, books: Dict[str, Codebook], scheme_name: str,
                   tensor_kind: str = "generic", mode: str = "ledger",
                   transport: str = "monolithic", chunk: int = DEFAULT_CHUNK,
                   decode_backend: str = "auto",
                   carry: str = "wire",
                   axes: Optional[Tuple[str, str]] = None,
                   book_epoch: int = 0,
                   codec: Optional[str] = None
                   ) -> "CompressionSpec":
        lens = tuple((p, tuple(int(v) for v in b.lengths))
                     for p, b in books.items())
        ids = tuple((p, b.book_id) for p, b in books.items())
        if codec is None:
            names = {getattr(b, "codec_name", "huffman")
                     for b in books.values()}
            if len(names) > 1:
                raise ValueError(f"books mix codecs {sorted(names)}; "
                                 f"one spec covers one codec")
            codec = names.pop() if names else "auto"
        return cls(mode=mode, scheme_name=scheme_name, tensor_kind=tensor_kind,
                   plane_lengths=lens, book_ids=ids, transport=transport,
                   chunk=chunk, codec=codec, decode_backend=decode_backend,
                   carry=carry, axes=axes, book_epoch=book_epoch)


@functools.lru_cache(maxsize=64)
def _lengths_tensor(lengths: Tuple[int, ...], device: str) -> torch.Tensor:
    """A plane's code lengths as an int64 tensor on ``device``, made once:
    a per-step host→device copy would stall the step on the card."""
    return torch.tensor(lengths, dtype=torch.int64, device=device)


def payload_stats(x: torch.Tensor, spec: CompressionSpec, *,
                  with_hists: bool = False) -> Dict[str, torch.Tensor]:
    """Exact (raw_bits, coded_bits) of ``x`` under the fixed books, as
    0-d float64 tensors on ``x``'s device (coded = histogram · lengths,
    summed in int64, so it is exact at any size).  ``with_hists`` adds
    ``shannon_bits`` and the per-plane histograms ``hist_<plane>``."""
    z = torch.zeros((), dtype=torch.float64, device=x.device)
    if not spec.enabled:
        out = {"raw_bits": z, "coded_bits": z}
        if with_hists:
            out["shannon_bits"] = z
        return out
    scheme = spec.scheme
    out = {}
    coded = torch.zeros((), dtype=torch.int64, device=x.device)
    shannon = z
    for plane, sym in scheme.to_symbols(x).items():
        hist = histogram256(sym)
        lens = _lengths_tensor(dict(spec.plane_lengths)[plane], str(x.device))
        coded = coded + (hist * lens).sum()
        if with_hists:
            shannon = shannon + shannon_bits(hist)
            out[f"hist_{plane}"] = hist
    out["raw_bits"] = z + float(x.numel() * scheme.total_symbol_bits())
    out["coded_bits"] = coded.to(torch.float64)
    if with_hists:
        out["shannon_bits"] = shannon
    return out
