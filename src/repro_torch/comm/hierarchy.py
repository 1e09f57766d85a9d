"""Hierarchical two-axis compressed rings (intra-pod × inter-pod; port
of ``repro.comm.hierarchy``).

The classic two-level all_reduce keeps the slow axis's traffic at 1/n₁
of the payload by reducing locally first:

    1. intra-axis reduce_scatter  (n₁−1 hops on the fast links);
    2. inter-axis all_reduce on the owned shard  (2(n₂−1) hops, payload
       / n₁ each);
    3. intra-axis all_gather  (n₁−1 hops on the fast links).

Every stage is one of the compressed ring collectives of
``repro_torch.comm.ring``, so the payload stays coded on all
2(n₁−1) + 2(n₂−1) hops, each measured in the combined ``hop_coded_bits``
(stage order: inner reduce-scatter hops, outer all-reduce hops, inner
all-gather hops).  Analytic per-device raw volume is the sum of the
per-axis terms, ``hierarchical_wire_factor`` × local payload.

On one card the two axes are loopback axes over one stack of ranks
(``comm.axis.loopback_mesh({"outer": n₂, "inner": n₁})``): tensors carry
the leading dims (n₂, n₁) and each axis acts on its own.  Numerics as
the reference: ``carry="wire"`` reduces in the wire dtype at every stage;
``carry="f32"`` applies within each stage, and the stage boundary rounds
to the wire dtype.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..core.codebook import Codebook
from ..core.encoder import DEFAULT_CHUNK
from ..core.symbols import SCHEMES
from .axis import Axis
from .ring import (DEFAULT_RING_BACKEND, ring_all_gather, ring_all_reduce,
                   ring_reduce_scatter)
from .transport import _full

__all__ = ["hierarchical_all_reduce", "hierarchical_wire_factor"]


def hierarchical_wire_factor(n_inner: int, n_outer: int) -> float:
    """Analytic per-device all_reduce egress (× local payload) of the
    two-axis ring: the sum of the per-axis terms."""
    if n_inner <= 1 and n_outer <= 1:
        return 0.0
    return (2.0 * (n_inner - 1) / n_inner
            + 2.0 * (n_outer - 1) / (n_inner * n_outer))


def _check_axes(axes: Sequence[Axis]) -> Tuple[Axis, Axis]:
    if (len(axes) != 2 or not all(isinstance(a, Axis) for a in axes)
            or axes[0] is axes[1] or axes[0].name == axes[1].name):
        raise ValueError(f"hierarchical ring needs two distinct axes "
                         f"(inner, outer), got {axes!r}")
    if axes[0].batch != axes[1].batch:
        raise ValueError(f"the two axes stack their ranks differently: "
                         f"{axes[0].batch} and {axes[1].batch}")
    return axes[0], axes[1]


def hierarchical_all_reduce(x: torch.Tensor, axes: Sequence[Axis],
                            books: Dict[str, Codebook],
                            scheme_name: str = "bf16", *,
                            chunk: int = DEFAULT_CHUNK,
                            decode_backend: str = DEFAULT_RING_BACKEND,
                            carry: str = "wire"
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Two-axis ring all_reduce: intra-axis reduce_scatter → inter-axis
    all_reduce on the owned segment → intra-axis all_gather.

    ``axes = (inner, outer)``: ``inner`` is the fast axis that carries
    the full payload, ``outer`` the slow one (each hop 1/n_inner of it).
    The stats compose so that a psum over both axes reads global wire
    bits and hop counts, as for a flat ring.
    """
    inner, outer = _check_axes(axes)
    n1, n2 = inner.size, outer.size
    nl = len(inner.batch)
    scheme = SCHEMES[scheme_name]

    seg, s1 = ring_reduce_scatter(x, inner, books, scheme_name, chunk=chunk,
                                  decode_backend=decode_backend, carry=carry)
    red, s2 = ring_all_reduce(seg, outer, books, scheme_name, chunk=chunk,
                              decode_backend=decode_backend, carry=carry)
    full, s3 = ring_all_gather(red, inner, books, scheme_name, chunk=chunk,
                               decode_backend=decode_backend)
    # segments come back in inner-axis rank order == flat segment order;
    # trim the indivisible-size padding.
    size = x[(0,) * nl].numel()
    y = full[..., :size].reshape(x.shape)

    wire_keys = ("raw_wire_bits", "coded_wire_bits", "payload_header_bits")
    stats = {k: s1[k] + s2[k] + s3[k] for k in wire_keys}
    stats["payload_raw_bits"] = _full(
        inner, float(size * scheme.total_symbol_bits()) * (n1 * n2), x.device)
    stats["payload_coded_bits"] = outer.psum(s1["payload_coded_bits"])
    stats["hop_coded_bits"] = torch.cat(
        [s1["hop_coded_bits"], s2["hop_coded_bits"], s3["hop_coded_bits"]],
        dim=-1)
    stats["hops"] = _full(inner, (2 * (n1 - 1) + 2 * (n2 - 1)) / (n1 * n2),
                          x.device)
    return y, stats
