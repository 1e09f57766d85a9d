"""Wire-dtype arithmetic of the compressed collectives, bit for bit as
the reference's XLA computes it.

torch adds bf16 as XLA does (through float32, rounded once), but it
cannot add float8_e4m3fn at all, and its float32 → e4m3fn conversion
saturates where XLA's gives NaN.  So:

  to_wire   float32 → wire dtype; e4m3fn: a magnitude past 464 (which
            rounds beyond 448) or a NaN gives NaN with the value's sign;
  wire_add  a + b in the wire dtype; e4m3fn through float32 (exact for
            two e4m3 values) and ``to_wire``, a NaN operand passed on as
            it is, a's before b's;
  peer_sum  the sum over peers of an endpoint reduction (XLA's reduce
            of ``sum(axis=0)``): bf16 in float32 in peer order, rounded
            once; e4m3 by successive ``wire_add``s;
  rank_sum  a ``psum`` over the ranks (what ``jax.lax.psum`` gives under
            vmap): successive ``wire_add``s in rank order, bf16 rounded at
            every add.
"""
from __future__ import annotations

import torch

from ..core.symbols import xla_cast

__all__ = ["to_wire", "wire_add", "peer_sum", "rank_sum"]

# Integer views for moving wire values through ops torch lacks for fp8.
_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
         torch.float32: torch.int32}


# float32 → the wire dtype as XLA converts: e4m3fn gives NaN where torch
# saturates (see ``core.symbols.xla_cast``)
to_wire = xla_cast


def wire_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b in the wire dtype, bit for bit as XLA adds it: bf16 through
    float32 (torch's own add); e4m3fn, which torch cannot add, through
    float32 (exact) and ``to_wire``, with a NaN operand passed on as it is
    (a's before b's)."""
    if a.dtype != torch.float8_e4m3fn:
        return a + b
    fa, fb = a.float(), b.float()
    r = to_wire(fa + fb, a.dtype).view(torch.uint8)
    r = torch.where(torch.isnan(fb), b.view(torch.uint8), r)
    r = torch.where(torch.isnan(fa), a.view(torch.uint8), r)
    return r.view(a.dtype)


def peer_sum(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over the peers at ``dim`` as XLA's reduce gives it: bf16
    accumulated in float32 in peer order and rounded once; e4m3 by
    successive ``wire_add``s from the first peer; other dtypes by
    ``sum``."""
    if g.dtype not in _BITS or g.dtype == torch.float32:
        return g.sum(dim)
    parts = g.unbind(dim)
    if g.dtype == torch.float8_e4m3fn:
        acc = parts[0]
        for p in parts[1:]:
            acc = wire_add(acc, p)
        return acc
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(g.dtype)


def rank_sum(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The psum over the ranks at ``dim``: bf16 and e4m3 by successive
    ``wire_add``s in rank order; other dtypes by ``sum``."""
    if g.dtype not in (torch.bfloat16, torch.float8_e4m3fn):
        return g.sum(dim)
    parts = g.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = wire_add(acc, p)
    return acc
