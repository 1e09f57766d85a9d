"""Kernel B2: per-chunk bit packing into the chunked wire format
(``csrc/bitpack.cu``).

Replaces ``repro/kernels/bitpack.py::pack_blocks_pallas``: per chunk an
exclusive prefix sum of the code lengths, the MSB-first hi/lo two-word
placement into ``chunk_capacity_words(chunk)`` words (1025 at 2048), and
the chunk's bit count.  Unlike the TPU kernel, ``chunk`` is a runtime
argument, so odd chunks (31, 1001) pack on the card too.

Bound on the card: bytes (8 B in per symbol, cap words out per chunk).
One CTA per chunk scans the lengths block-wide and atomicOr's the code
parts into the chunk's words in shared memory (see the source).
``pack_blocks_plain`` is the same function in plain torch (the
reference's ``_pack_rows`` core, ``core.encoder.pack_rows``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.encoder import DEFAULT_CHUNK, chunk_capacity_words, pack_rows
from ..core.huffman import MAX_CODE_LEN
from .build import I, LL, P, bind, check, count_launch, raise_on

__all__ = ["pack_blocks", "pack_blocks_plain"]

# Shared memory a CTA may hold (Hopper: 227 KB) bounds the chunk's words.
_MAX_SMEM = 232_448


def _geometry(n: int, chunk: int, max_len: int) -> Tuple[int, int]:
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return max((n + chunk - 1) // chunk, 1), chunk_capacity_words(chunk,
                                                                  max_len)


def pack_blocks_plain(codes: torch.Tensor, lens: torch.Tensor, *,
                      chunk: int = DEFAULT_CHUNK,
                      max_len: int = MAX_CODE_LEN
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """codes/lens (N,) int → (words (NB, cap) int32, bits (NB,) int32);
    positions past N have length 0."""
    n = codes.shape[0]
    nb, cap = _geometry(n, chunk, max_len)
    v = torch.zeros(nb * chunk, dtype=torch.int64, device=codes.device)
    l = torch.zeros_like(v)
    v[:n] = codes.to(torch.int64)
    l[:n] = lens.to(torch.int64)
    return pack_rows(v.reshape(nb, chunk), l.reshape(nb, chunk), cap)


def pack_blocks(codes: torch.Tensor, lens: torch.Tensor, *,
                chunk: int = DEFAULT_CHUNK, max_len: int = MAX_CODE_LEN
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B2 on CUDA tensors, the plain version on CPU tensors.

    codes, lens: (N,) int32 on one device (B1's outputs).  Returns
    (words (NB, cap) int32 bit patterns, bits (NB,) int32), bit-equal to
    the reference's ``encode_chunked_jit`` at the same chunk.
    """
    if codes.device.type == "cpu":
        return pack_blocks_plain(codes, lens, chunk=chunk, max_len=max_len)
    if codes.device.type != "cuda":
        raise ValueError(f"no B2 kernel for device {codes.device}")
    dev = codes.device
    n = codes.shape[0]
    check(codes, "codes", torch.int32, dev, (n,))
    check(lens, "lens", torch.int32, dev, (n,))
    nb, cap = _geometry(n, chunk, max_len)
    if cap * 4 > _MAX_SMEM - 1024:
        raise ValueError(f"chunk {chunk} needs {cap * 4} B of shared memory "
                         f"for its words; the card offers {_MAX_SMEM}")
    words = torch.empty((nb, cap), dtype=torch.int32, device=dev)
    bits = torch.empty((nb,), dtype=torch.int32, device=dev)
    fn = bind("bitpack", "pack_blocks_launch", [P, P, P, P, LL, I, I, I, P])
    with torch.cuda.device(dev):
        err = fn(codes.data_ptr(), lens.data_ptr(), words.data_ptr(),
                 bits.data_ptr(), n, nb, chunk, cap,
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "pack_blocks (B2)")
    count_launch("pack_blocks")
    return words, bits
