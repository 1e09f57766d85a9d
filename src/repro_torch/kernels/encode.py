"""Kernel B1: single-stage codebook lookup (``csrc/encode.cu``).

Replaces ``repro/kernels/encode.py::encode_lookup_pallas``.  Each uint8
symbol maps through the book's 256-entry [code, length] LUT; the kernel
also sums the lengths, the plane's exact coded size.

Bound on the card: bytes (1 B in, 8 B out per symbol), a few
microseconds for a logits plane, which is less than a call's host path.
So a call is one launch and nothing else (the bit total is summed by the
last block to finish, in a per-stream accumulator, not by atomics into
a counter zeroed first), and the wrapper is kept short: one allocation
for codes, lengths and total, checks that compare device indices, the
raw stream handle, a device switch only when the symbols' device is not
current.  On the device, 16 symbols a thread through one 16-byte
load and one shared-memory lookup a symbol (see the source for the
design).  ``encode_lookup_plain`` is the same function in plain torch:
the CPU path, and what the kernel is held to on the card.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .build import LL, P, bind, check, count_launch, raise_on, raw_stream

__all__ = ["encode_lookup", "encode_lookup_plain"]

# The kernel's bit-total accumulator (sum, ticket) for each (device,
# stream) it has run on: zeroed once, and left zero by every launch, so a
# stream's calls, which run one after another, share it.
_ACC: Dict[Tuple[int, int], torch.Tensor] = {}


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
    the same device, a book's LUT (codes < 2^16, lengths <= 16, as every
    book's are: the kernel packs each entry into 32 bits).  Returns
    (codes (N,) int32, lengths (N,) int32, total bits () int64); the
    int32 codes are the reference's uint32 codes.  On the card the three
    are views of one allocation (codes, lengths, each row on 16 bytes,
    then the total).
    """
    if not symbols.is_cuda:
        if symbols.device.type == "cpu":
            return encode_lookup_plain(symbols, lut)
        raise ValueError(f"no B1 kernel for device {symbols.device}")
    sym = symbols if symbols.dim() == 1 else symbols.reshape(-1)
    if sym.dtype is not torch.uint8:
        sym = sym.to(torch.uint8)
    if not sym.is_contiguous():
        sym = sym.contiguous()
    idx = sym.get_device()
    if (lut.get_device() != idx or lut.dtype is not torch.int32
            or lut.shape != (256, 2) or not lut.is_contiguous()):
        check(lut, "lut", torch.int32, sym.device, (256, 2))
    n = sym.numel()
    n4 = (n + 3) & ~3           # codes, lengths (n4 int32 each), the total
    out = sym.new_empty(n4 + 1, dtype=torch.int64)
    stream = raw_stream(idx)
    acc = _ACC.get((idx, stream))
    if acc is None:
        acc = _ACC[(idx, stream)] = sym.new_zeros(2, dtype=torch.int64)
    fn = bind("encode", "encode_lookup_launch", [P, P, P, P, LL, P])
    args = (sym.data_ptr(), lut.data_ptr(), out.data_ptr(), acc.data_ptr(),
            n, stream)
    if idx == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(idx):
            err = fn(*args)
    if err:
        raise_on(err, "encode_lookup (B1)")
    count_launch("encode_lookup")
    # as_strided: the cheapest view op on the host (slicing costs more)
    words = out.view(torch.int32)
    return (words.as_strided((n,), (1,), 0),
            words.as_strided((n,), (1,), n4), out.as_strided((), (), n4))
