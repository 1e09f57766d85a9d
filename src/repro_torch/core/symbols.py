"""Tensor → symbol-stream extraction (port of ``repro.core.symbols``).

The paper codes 8-bit symbols.  A bfloat16 tensor splits into two byte
planes: the high byte (sign, exponent, top mantissa bit) is structured
and compresses hard, the low byte (mantissa) is near uniform, so each
plane keeps its own book.  An fp8 tensor is one plane of its raw bytes.

All byte handling goes through torch views (``view(torch.int16)``,
``view(torch.uint8)``), so it runs the same on the CPU and the card and
needs no ``ml_dtypes``.  Shifts are done on int16 and masked, because
unsigned 16-bit shifts are missing from CPU torch.

Only ``bf16`` and ``e4m3`` are ported; the other schemes of the
reference (f32, e5m2 and the sub-byte eXmY formats) wait for the slices
that need them (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

__all__ = ["SymbolScheme", "SCHEMES", "bf16_planes", "bf16_from_planes",
           "e4m3_planes"]


def bf16_planes(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Split a tensor (cast to bfloat16) into low/high uint8 byte planes."""
    v = x.to(torch.bfloat16).reshape(-1).view(torch.int16)
    return {"lo": (v & 0xFF).to(torch.uint8),
            "hi": ((v >> 8) & 0xFF).to(torch.uint8)}


def bf16_from_planes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The inverse of ``bf16_planes``: symbols of the two planes (any
    integer dtype, values < 256, one shape) → the bfloat16 values
    ``lo | hi << 8``, bit for bit."""
    u = lo.to(torch.int32) | (hi.to(torch.int32) << 8)
    return torch.where(u >= 1 << 15, u - (1 << 16), u).to(
        torch.int16).view(torch.bfloat16)


def e4m3_planes(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The raw bytes of a tensor cast to float8_e4m3fn, as one plane."""
    return {"b0": x.to(torch.float8_e4m3fn).reshape(-1).view(torch.uint8)}


@dataclass(frozen=True)
class SymbolScheme:
    """How a tensor dtype maps to one or more uint8 symbol streams."""
    name: str
    planes: Tuple[str, ...]
    symbol_bits: int                      # true bits per symbol (≤8)
    n_symbols: int                        # alphabet size (≤256)
    to_symbols: Callable[[torch.Tensor], Dict[str, torch.Tensor]]

    def total_symbol_bits(self) -> int:
        """Bits of raw payload represented by one symbol from *each* plane."""
        return self.symbol_bits * len(self.planes)


SCHEMES: Dict[str, SymbolScheme] = {
    "bf16": SymbolScheme("bf16", ("lo", "hi"), 8, 256, bf16_planes),
    "e4m3": SymbolScheme("e4m3", ("b0",), 8, 256, e4m3_planes),
}
