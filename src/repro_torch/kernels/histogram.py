"""Kernel B5: exact 256-bin histogram of a symbol plane
(``csrc/histogram.cu``).

Replaces ``repro/kernels/histogram.py::histogram256_pallas``, which pads
to whole blocks, counts by an iota compare (the TPU has no atomics) and
subtracts the padding from bin 0.  On Hopper: per-warp bins in shared
memory with ``atomicAdd``, the ragged edge masked, one 64-bit atomic per
bin and block into an int64 output zeroed on the same stream (see the
source).  Bound on the card: bytes, one per symbol.

It builds the books of the compressed-at-rest path (whole-tree plane
counts of ``memstore.CompressedParamStore``, the first K/V ingest of
``memstore.CodedKVStore``) and runs every decode step's ledger
histogram (``comm.compression.payload_stats``) without a host sync.
``histogram256_plain`` is the same function as a torch scatter-add: the
CPU path, and what the kernel is held to on the card.
"""
from __future__ import annotations

import torch

from .build import LL, P, bind, check, count_launch, raise_on

__all__ = ["histogram256", "histogram256_plain"]


def histogram256_plain(symbols: torch.Tensor) -> torch.Tensor:
    """symbols (any shape) of values in [0, 256) → (256,) int64 counts,
    by scatter-add (``torch.bincount`` on CUDA would read the input's
    maximum back to the host)."""
    idx = symbols.reshape(-1).to(torch.int64)
    hist = torch.zeros(256, dtype=torch.int64, device=idx.device)
    return hist.scatter_add_(0, idx, torch.ones_like(idx))


def histogram256(symbols: torch.Tensor) -> torch.Tensor:
    """Kernel B5 on a CUDA tensor, the plain version on a CPU tensor.

    symbols: uint8 (int32 in [0, 256) is narrowed first), any shape →
    (256,) int64 counts on the symbols' device; nothing waits for the
    device.
    """
    if symbols.device.type == "cpu":
        return histogram256_plain(symbols)
    if symbols.device.type != "cuda":
        raise ValueError(f"no B5 kernel for device {symbols.device}")
    sym = symbols.reshape(-1)
    if sym.dtype != torch.uint8:
        sym = sym.to(torch.uint8)
    sym = sym.contiguous()
    dev = sym.device
    check(sym, "symbols", torch.uint8, dev)
    out = torch.empty(256, dtype=torch.int64, device=dev)
    fn = bind("histogram", "histogram256_launch", [P, LL, P, P])
    with torch.cuda.device(dev):
        err = fn(sym.data_ptr(), sym.numel(), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "histogram256 (B5)")
    count_launch("histogram256")
    return out
