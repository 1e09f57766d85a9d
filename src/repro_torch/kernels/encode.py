"""Kernel B1: single-stage codebook lookup (``csrc/encode.cu``).

Replaces ``repro/kernels/encode.py::encode_lookup_pallas``.  Each uint8
symbol maps through the book's 256-entry [code, length] LUT; the kernel
also sums the lengths, the plane's exact coded size.

Bound on the card: bytes (1 B in, 8 B out per symbol).  The LUT lives
in shared memory, a grid-stride loop masks the ragged edge, and the bit
total is a warp reduction with one 64-bit atomicAdd per block (see the
source for the design).  ``encode_lookup_plain`` is the same function in
plain torch: the CPU path, and what the kernel is held to on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .build import LL, P, bind, check, count_launch, raise_on

__all__ = ["encode_lookup", "encode_lookup_plain"]


def encode_lookup_plain(symbols: torch.Tensor, lut: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """symbols (N,) uint8/int, lut (256, 2) int32 → (codes (N,) int32,
    lengths (N,) int32, total bits () int64)."""
    sym = symbols.reshape(-1).to(torch.int64)
    codes = lut[:, 0].to(torch.int32)[sym]
    lens = lut[:, 1].to(torch.int32)[sym]
    return codes, lens, lens.to(torch.int64).sum()


def encode_lookup(symbols: torch.Tensor, lut: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B1 on a CUDA tensor, the plain version on a CPU tensor.

    symbols (N,) uint8 (int32 is narrowed first), lut (256, 2) int32 on
    the same device.  Returns (codes (N,) int32, lengths (N,) int32,
    total bits () int64); the codes are < 2^16, so the int32 values are
    the reference's uint32 codes.
    """
    if symbols.device.type == "cpu":
        return encode_lookup_plain(symbols, lut)
    if symbols.device.type != "cuda":
        raise ValueError(f"no B1 kernel for device {symbols.device}")
    sym = symbols.reshape(-1)
    if sym.dtype != torch.uint8:
        sym = sym.to(torch.uint8)
    sym = sym.contiguous()
    dev = sym.device
    check(sym, "symbols", torch.uint8, dev)
    check(lut, "lut", torch.int32, dev, (256, 2))
    n = sym.numel()
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    lens = torch.empty(n, dtype=torch.int32, device=dev)
    bits = torch.empty((), dtype=torch.int64, device=dev)
    fn = bind("encode", "encode_lookup_launch", [P, P, P, P, P, LL, P])
    with torch.cuda.device(dev):
        err = fn(sym.data_ptr(), lut.data_ptr(), codes.data_ptr(),
                 lens.data_ptr(), bits.data_ptr(), n,
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "encode_lookup (B1)")
    count_launch("encode_lookup")
    return codes, lens, bits
