"""Kernel B5: exact 256-bin histogram of a symbol plane
(``csrc/histogram.cu``).

Replaces ``repro/kernels/histogram.py::histogram256_pallas``, which pads
to whole blocks, counts by an iota compare (the TPU has no atomics) and
subtracts the padding from bin 0.  On Hopper: each warp counts into its
own bins in shared memory with shared atomics (which merge the lanes of
a warp that add to one address, so skew costs nothing); each CTA adds
its bins into a per-stream accumulator, and the last CTA to finish
moves the sums into the int64 output and leaves the accumulator zero
(see the source).  One launch a call, nothing else on the stream.
Bound on the card: bytes, one per symbol.

It builds the books of the compressed-at-rest path (whole-tree plane
counts of ``memstore.CompressedParamStore``, the first K/V ingest of
``memstore.CodedKVStore``, checkpoints) and runs every decode step's
ledger histogram (``comm.compression.payload_stats``) without a host
sync.  ``histogram256_plain`` is the same function as a torch
scatter-add: the CPU path, and what the kernel is held to on the card.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .build import (LL, P, I, accumulator_key, bind, count_launch,
                    raise_on, raw_stream)

__all__ = ["histogram256", "histogram256_plain", "launch_grid", "wave_ctas"]

# The launch's schedule.  THREADS is passed to the launch, which checks
# it against csrc/histogram.cu's own; the card's occupancy query
# (``wave_ctas``) gives the CTAs of one wave.
THREADS = 256            # threads a CTA, 8 warps with 256 bins each
MIN_LOADS = 4            # 16-byte loads a thread at least, before the
                         # grid grows

# Per device: the CTAs of one wave.  Per (device, stream, owner)
# (``build.accumulator_key``): the kernel's accumulator, 256 sums and a
# ticket, which every launch leaves zero.
_WAVE: Dict[int, int] = {}
_ACC: Dict[Tuple[int, int, object], torch.Tensor] = {}


def launch_grid(n: int, wave: int) -> int:
    """CTAs of B5's launch on ``n`` symbols when one wave holds ``wave``
    CTAs: enough to give each thread ``MIN_LOADS`` 16-byte loads, at
    least one, at most one wave."""
    return max(1, min(-(-(n // 16) // (THREADS * MIN_LOADS)), wave))


def histogram256_plain(symbols: torch.Tensor) -> torch.Tensor:
    """symbols (any shape) of values in [0, 256) → (256,) int64 counts,
    by scatter-add (``torch.bincount`` on CUDA would read the input's
    maximum back to the host)."""
    idx = symbols.reshape(-1).to(torch.int64)
    hist = torch.zeros(256, dtype=torch.int64, device=idx.device)
    return hist.scatter_add_(0, idx, torch.ones_like(idx))


def wave_ctas(idx: int) -> int:
    """The CTAs of one B5 wave on CUDA device ``idx`` (the occupancy
    query's CTAs an SM times its SMs), queried once a device."""
    wave = _WAVE.get(idx)
    if wave is None:
        ctas = ctypes.c_int(0)
        fn = bind("histogram", "histogram256_wave", [P])
        with torch.cuda.device(idx):
            raise_on(fn(ctypes.addressof(ctas)), "histogram256 wave")
        wave = _WAVE[idx] = ctas.value
    return wave


def histogram256(symbols: torch.Tensor) -> torch.Tensor:
    """Kernel B5 on a CUDA tensor, the plain version on a CPU tensor.

    symbols: uint8 (int32 in [0, 256) is narrowed first), any shape and
    byte alignment → (256,) int64 counts on the symbols' device, from one
    launch on the current stream; nothing waits for the device.
    """
    if not symbols.is_cuda:
        if symbols.device.type == "cpu":
            return histogram256_plain(symbols)
        raise ValueError(f"no B5 kernel for device {symbols.device}")
    sym = symbols if symbols.dim() == 1 else symbols.reshape(-1)
    if sym.dtype is not torch.uint8:
        sym = sym.to(torch.uint8)
    if not sym.is_contiguous():
        sym = sym.contiguous()
    idx = sym.get_device()
    stream = raw_stream(idx)
    key = accumulator_key(idx, stream)
    acc = _ACC.get(key)
    if acc is None:
        acc = _ACC[key] = sym.new_zeros(257, dtype=torch.int64)
    n = sym.numel()
    out = sym.new_empty(256, dtype=torch.int64)
    fn = bind("histogram", "histogram256_launch", [P, LL, P, P, I, I, P])
    args = (sym.data_ptr(), n, out.data_ptr(), acc.data_ptr(), THREADS,
            launch_grid(n, wave_ctas(idx)), stream)
    if idx == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(idx):
            err = fn(*args)
    if err:
        raise_on(err, "histogram256 (B5)")
    count_launch("histogram256")
    return out
