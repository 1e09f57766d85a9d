"""The uncoded ring all-reduce: the coded ring's hop schedule and adds
with no coding, in plain torch.

A frozen copy of ``chip_smoke.py``'s ``plain_ring`` (wire carry): ``n``
ranks stacked on the first axis, each flat payload split into ``n``
segments of ``ceil(size / n)`` elements (the last zero-padded).  Rank
``i`` starts the reduce phase from its segment ``i``; each hop ships
the partial sum one rank on and adds the receiver's own segment (in
float32, rounded once to the wire dtype); the gather phase forwards the
reduced segments unchanged.  ``add_dtype`` is the precision each add
rounds to: the payload's for the reference, a lower one for the
control.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def _round(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.to(dtype)


def ring_all_reduce(x: torch.Tensor, add_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x (n, size) → (y (n, size) in x's dtype, shipped): ``shipped[h]``
    is the (n, seg) values every rank sends at hop ``h``, 2(n − 1)
    hops."""
    add_dtype = add_dtype or x.dtype
    n, size = x.shape
    seg = -(-size // n)
    acc = torch.nn.functional.pad(x, (0, n * seg - size)).reshape(n, n, seg)
    i = torch.arange(n, device=x.device)

    def add(a, b):
        s = a.to(torch.float32) + b.to(torch.float32)
        return _round(s, add_dtype).to(x.dtype)

    shipped = []
    cur = acc[i, i]
    for t in range(n - 1):
        shipped.append(cur)
        cur = add(torch.roll(cur, 1, 0), acc[i, (i - t - 1) % n])
    out = torch.zeros((n, n, seg), dtype=x.dtype, device=x.device)
    out[i, (i + 1) % n] = cur
    c = cur
    for t in range(n - 1):
        shipped.append(c)
        c = torch.roll(c, 1, 0)
        out[i, (i - t) % n] = c
    return out.reshape(n, -1)[:, :size], shipped
