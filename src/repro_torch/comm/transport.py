"""Pluggable transport layer for compressed collectives (port of
``repro.comm.transport``).

A ``Transport`` is one strategy for moving a Huffman-coded payload
through a collective: what rides the wire, where decode happens, and how
wire bits are accounted.  The three built-ins, as in the reference:

  monolithic — one stream per plane per rank, gathered whole; the
      receiver decodes every peer's stream at the endpoint.
  chunked    — each plane's stream cut into fixed-symbol chunks with
      per-chunk bit-count headers; each chunk rides its own gather.
  ring       — ``repro_torch.comm.ring``: every hop decodes, reduces and
      re-encodes, so the payload is coded on all n−1 hops and the ledger
      records measured per-hop wire bits.

A collective runs over an ``Axis`` (``comm.axis``) where the reference
names a mesh axis: ``LoopbackAxis`` stacks every rank on leading dims in
one process (each op then decodes and encodes all ranks in one kernel
launch a plane), ``ProcessGroupAxis`` runs one rank a process.  Every
tensor lies on its own device: a CUDA tensor's encode runs B1 → B2 and
its decode B3, B4 or B6, with no fallback; a CPU tensor's runs the
kernels' plain versions.

Selection is registry-driven: ``CompressionSpec.transport`` names the
transport and the ``*_compressed`` entry points dispatch through
``TRANSPORTS``.  Setting ``CompressionSpec.axes = (inner, outer)``
routes ``all_reduce_compressed`` to the hierarchical two-axis ring; the
axis argument is then a mapping of names to axes (``loopback_mesh``).

Stat convention (all transports): stats are replicated values equal to
``true_global_quantity / n`` so that a caller-side psum over the axis
recovers the true global number.  They are float64 tensors of the axis's
``batch`` shape (the reference's are float32: the same numbers wherever
float32 holds them exactly).  Endpoint reductions sum the peers with
``peer_sum``: bf16 in float32 rounded once, e4m3 by successive e4m3
adds, as XLA's reduce does.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..core.codebook import Codebook
from ..core.codec import codec_for_book
from ..core.encoder import DEFAULT_CHUNK
from ..core.symbols import SCHEMES, bf16_from_planes
from .axis import Axis, take_rows
from .wire import _BITS, peer_sum

__all__ = [
    "Transport", "MonolithicTransport", "ChunkedTransport", "RingTransport",
    "TRANSPORTS", "register_transport", "get_transport",
    "all_gather_compressed", "all_reduce_compressed",
    "reduce_scatter_compressed", "all_to_all_compressed",
    "encode_planes", "decode_plane", "decode_blocks", "decode_gathered_chunk",
    "reassemble", "planes_of", "RING_FACTORS", "wire_factor",
    "moe_dispatch_raw_bits", "moe_ep_raw_bits",
    "DEFAULT_DECODE_BACKEND",
]

# Default chunked-decode backend for every transport entry point:
# "auto" resolves per codec in ``decode_blocks`` (huffman → multisym, B4
# on the card; qlc → scan, B6).
DEFAULT_DECODE_BACKEND = "auto"

# Analytic ring-algorithm egress factors per device (× payload), shared
# by ledger mode and the transports' raw-bit accounting.
RING_FACTORS = {
    "all_reduce": lambda n: 2.0 * (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_gather": lambda n: float(n - 1),
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
}


def wire_factor(op: str, n: int) -> float:
    """Analytic per-device egress factor for ``op`` on an n-ring (the
    reference's ``Transport.wire_factor``, the same for every transport)."""
    return RING_FACTORS[op](n)


def moe_dispatch_raw_bits(n_tokens: int, experts_per_token: int,
                          d_model: int, symbol_bits: int,
                          n_moe_layers: int) -> float:
    """Raw bits of one step's MoE expert-dispatch payload: every routed
    token slot ships its d_model hidden once out (dispatch) and once
    back (combine), per MoE layer."""
    return float(n_tokens * experts_per_token * d_model * symbol_bits
                 * 2 * n_moe_layers)


def moe_ep_raw_bits(model_cfg, n_tokens: int, symbol_bits: int,
                    ep_degree: int) -> Tuple[float, float]:
    """(dispatch, wire) raw bits of one pass of ``n_tokens`` tokens
    through ``model_cfg``'s MoE layers: ``moe_dispatch_raw_bits``, and
    that times the ``ep_degree``-way all-to-all factor, as the
    reference's serve and train steps account them; (0, 0) without
    expert parallelism or an MoE layer."""
    n_moe = sum(1 for kind in model_cfg.layer_kinds if "moe" in kind)
    if ep_degree <= 1 or not n_moe:
        return 0.0, 0.0
    dispatch = moe_dispatch_raw_bits(n_tokens, model_cfg.experts_per_token,
                                     model_cfg.d_model, symbol_bits, n_moe)
    return dispatch, wire_factor("all_to_all", ep_degree) * dispatch


def _require_wire_carry(name: str, carry: str) -> None:
    """Endpoint-decode transports accumulate at the receiver in full
    precision already; an f32 hop carry only means something on a ring,
    where partial sums actually ride the wire."""
    if carry != "wire":
        raise ValueError(f"carry={carry!r} is only supported by the ring "
                         f"transport, not {name!r}")


# ------------------------------------------------------- shared plumbing
def planes_of(x: torch.Tensor, scheme_name: str, nl: int = 0
              ) -> Dict[str, torch.Tensor]:
    """The symbol planes of every rank's tensor: x (batch + s) → plane →
    (batch + (numel(s),)) uint8, ``nl`` the number of rank dims."""
    lead = x.shape[:nl]
    return {p: s.reshape(*lead, -1)
            for p, s in SCHEMES[scheme_name].to_symbols(x).items()}


def encode_planes(x: torch.Tensor, books: Dict[str, Codebook],
                  scheme_name: str, *, chunk: Optional[int] = DEFAULT_CHUNK,
                  nl: int = 0):
    """Split ``x`` into symbol planes and single-stage encode each one,
    every rank of its ``nl`` leading rank dims at once.

    ``chunk=None`` → monolithic (words batch + (capacity,), bits batch);
    ``chunk=c``    → chunked wire format (words batch + (NB, cap), bits
    batch + (NB,)), each rank's stream cut on its own.
    Returns plane → (words, bits, symbols batch + (n,) uint8).
    """
    from ..kernels.ops import encode_monolithic, encode_rows
    enc = {}
    for plane, sym in planes_of(x, scheme_name, nl).items():
        b = books[plane]
        lead, n = sym.shape[:-1], sym.shape[-1]
        (lut,) = b.device_tables("lut", sym.device)
        if chunk is None:
            words, bits = encode_monolithic(sym.reshape(-1, n), lut,
                                            max_len=b.max_len)
            enc[plane] = (words.reshape(*lead, -1), bits.reshape(lead), sym)
            continue
        words, bits = encode_rows(sym.reshape(-1, n), lut, chunk=chunk,
                                  max_len=b.max_len)
        nb = max(-(-n // chunk), 1)
        enc[plane] = (words.reshape(*lead, nb, -1), bits.reshape(*lead, nb),
                      sym)
    return enc


def decode_plane(words: torch.Tensor, book: Codebook, n_symbols: int
                 ) -> torch.Tensor:
    """Monolithic decode of plane streams (..., capacity) → (..., n)
    through the book's codec: each stream is one chunk of n symbols, all
    in one launch."""
    return codec_for_book(book).decode_plane(words, book, n_symbols)


def decode_blocks(words: torch.Tensor, counts: torch.Tensor, book: Codebook,
                  chunk: int, backend: str) -> torch.Tensor:
    """(NB, cap) words + (NB,) counts → (NB, chunk) symbol blocks through
    the book's codec, which resolves and validates ``backend``."""
    return codec_for_book(book).decode_blocks(words, counts, book, chunk,
                                              backend)


def decode_gathered_chunk(gw: torch.Tensor, count: int, book: Codebook,
                          chunk: int, backend: str) -> torch.Tensor:
    """Decode one chunk gathered from every peer: (..., cap) → (...,
    chunk); to the decoder a peer is just another chunk, so every peer
    of every rank decodes in one launch."""
    rows = gw.reshape(-1, gw.shape[-1])
    counts = torch.full((rows.shape[0],), count, dtype=torch.int32,
                        device=gw.device)
    out = decode_blocks(rows, counts, book, chunk, backend)
    return out.reshape(*gw.shape[:-1], chunk)


def reassemble(planes: Dict[str, torch.Tensor], scheme_name: str, shape,
               dtype) -> torch.Tensor:
    """Symbol planes → values (inverse of the scheme's plane extractor)."""
    if scheme_name == "bf16":
        return bf16_from_planes(planes["lo"], planes["hi"]).reshape(shape)
    if scheme_name == "e4m3":
        return planes["b0"].to(torch.uint8).view(
            torch.float8_e4m3fn).reshape(shape)
    raise ValueError(f"no reassembly for scheme {scheme_name}")


def _full(axis: Axis, value, device) -> torch.Tensor:
    """A replicated stat: ``value`` on every rank, float64."""
    return torch.full(axis.batch, float(value), dtype=torch.float64,
                      device=device)


def _sum_bits(bits: torch.Tensor, nl: int) -> torch.Tensor:
    """A rank's bit counts summed, as float64 of shape batch."""
    return bits.to(torch.int64).reshape(*bits.shape[:nl], -1).sum(-1).to(
        torch.float64)


# ------------------------------------------------------------ transports
class Transport:
    """One wire strategy for bitexact compressed collectives.

    Subclasses implement ``all_gather`` and ``all_reduce``; every op
    returns ``(result, stats)`` where stats follow the module's
    replication convention.  ``reduce_scatter`` and ``all_to_all`` have
    endpoint-decode defaults built on the subclass's ``all_gather``; the
    ring transport overrides them with true per-hop-coded rings.
    """

    name: str = "?"

    @staticmethod
    def wire_factor(op: str, n: int) -> float:
        """Analytic per-device egress factor for ``op`` on an n-ring."""
        return RING_FACTORS[op](n)

    def all_gather(self, x, axis: Axis, books: Dict[str, Codebook],
                   scheme_name: str = "bf16", *, chunk: int = DEFAULT_CHUNK,
                   decode_backend: str = DEFAULT_DECODE_BACKEND):
        raise NotImplementedError

    def all_reduce(self, x, axis: Axis, books: Dict[str, Codebook],
                   scheme_name: str = "bf16", *, chunk: int = DEFAULT_CHUNK,
                   decode_backend: str = DEFAULT_DECODE_BACKEND,
                   carry: str = "wire"):
        raise NotImplementedError

    def _rescale_wire(self, stats, op: str, n: int):
        """Endpoint ops ship the same gathered streams as ``all_gather``;
        the estimate of a ring's per-device egress for ``op`` rescales
        the payload probe by the op's analytic ring factor."""
        out = dict(stats)
        f = self.wire_factor(op, n)
        out["raw_wire_bits"] = stats["payload_raw_bits"] / n * f
        out["coded_wire_bits"] = stats["payload_coded_bits"] / n * f
        return out

    def reduce_scatter(self, x, axis: Axis, books: Dict[str, Codebook],
                       scheme_name: str = "bf16", *,
                       chunk: int = DEFAULT_CHUNK,
                       decode_backend: str = DEFAULT_DECODE_BACKEND,
                       carry: str = "wire"):
        """Endpoint-decode default: gather every peer's coded stream,
        decode, reduce locally, keep this rank's flat segment
        (``psum_scatter(tiled=True)`` on the flattened tensor, the tail
        zero-padded when indivisible)."""
        _require_wire_carry(self.name, carry)
        n, nl = axis.size, len(axis.batch)
        g, st = self.all_gather(x, axis, books, scheme_name, chunk=chunk,
                                decode_backend=decode_backend)
        lead, size = x.shape[:nl], x[(0,) * nl].numel()
        full = peer_sum(g.reshape(*lead, n, size), nl)
        seg_len = -(-size // n)
        flat = torch.nn.functional.pad(full.view(_BITS[x.dtype]),
                                       (0, n * seg_len - size))
        y = take_rows(flat.reshape(*lead, n, seg_len), axis.index(x.device),
                      nl).view(x.dtype)
        return y, self._rescale_wire(st, "reduce_scatter", n)

    def all_to_all(self, x, axis: Axis, books: Dict[str, Codebook],
                   scheme_name: str = "bf16", *, chunk: int = DEFAULT_CHUNK,
                   decode_backend: str = DEFAULT_DECODE_BACKEND):
        """Endpoint-decode default: gather every peer's coded payload
        and keep the shards addressed to this rank (``split_axis=0``:
        x.shape[0] == n per rank, shard j goes to rank j)."""
        n, nl = axis.size, len(axis.batch)
        if x.shape[nl] != n:
            raise ValueError(f"all_to_all needs x.shape[0] == axis size "
                             f"({n}), got {tuple(x.shape[nl:])}")
        g, st = self.all_gather(x, axis, books, scheme_name, chunk=chunk,
                                decode_backend=decode_backend)
        lead = x.shape[:nl]
        gg = g.reshape(*lead, n, n, -1).movedim(nl + 1, nl)
        y = take_rows(gg.view(_BITS[x.dtype]), axis.index(x.device), nl)
        return y.view(x.dtype).reshape(x.shape), self._rescale_wire(
            st, "all_to_all", n)


TRANSPORTS: Dict[str, Transport] = {}


def register_transport(cls):
    """Class decorator: instantiate and register under ``cls.name``."""
    TRANSPORTS[cls.name] = cls()
    return cls


def get_transport(name: str) -> Transport:
    try:
        return TRANSPORTS[name]
    except KeyError:
        raise ValueError(f"unknown transport {name!r}; "
                         f"registered: {sorted(TRANSPORTS)}") from None


def _gathered_shape(x: torch.Tensor, nl: int, n: int):
    s = x.shape[nl:]
    return (*x.shape[:nl], n * s[0], *s[1:])


@register_transport
class MonolithicTransport(Transport):
    """One stream per plane per rank; endpoint decode.

    The wire payload is the fixed-capacity word buffer + true bit count;
    coded stats are the actual summed stream sizes, not an estimate.
    """

    name = "monolithic"

    def all_gather(self, x, axis, books, scheme_name="bf16", *,
                   chunk=DEFAULT_CHUNK, decode_backend=DEFAULT_DECODE_BACKEND):
        n, nl = axis.size, len(axis.batch)
        enc = encode_planes(x, books, scheme_name, chunk=None, nl=nl)
        out_planes = {}
        coded = _full(axis, 0, x.device)
        for plane, (words, n_bits, sym) in enc.items():
            gw = axis.all_gather(words)                # batch + (n, cap)
            gb = axis.all_gather(n_bits)               # batch + (n,)
            dec = decode_plane(gw, books[plane], sym.shape[-1])
            out_planes[plane] = dec.reshape(*x.shape[:nl], -1)
            coded = coded + _sum_bits(gb, nl)
        scheme = SCHEMES[scheme_name]
        y = reassemble(out_planes, scheme_name, _gathered_shape(x, nl, n),
                       x.dtype)
        raw = float(x[(0,) * nl].numel() * scheme.total_symbol_bits()) * n
        stats = {"raw_wire_bits": _full(axis, raw * (n - 1) / n, x.device),
                 "coded_wire_bits": coded * (n - 1) / n,
                 "payload_raw_bits": _full(axis, raw, x.device),
                 "payload_coded_bits": coded}
        return y, stats

    def all_reduce(self, x, axis, books, scheme_name="bf16", *,
                   chunk=DEFAULT_CHUNK, decode_backend=DEFAULT_DECODE_BACKEND,
                   carry="wire"):
        """Gather streams, decode, add at the endpoint (decode-then-add)."""
        _require_wire_carry(self.name, carry)
        g, stats = self.all_gather(x, axis, books, scheme_name)
        n, nl = axis.size, len(axis.batch)
        y = peer_sum(g.reshape(*x.shape[:nl], n, *x.shape[nl:]), nl)
        return y, stats


@register_transport
class ChunkedTransport(Transport):
    """Streaming wire format: per-chunk gathers + on-device decode.

    Each chunk of each plane rides its own gather; bit-exact with the
    monolithic transport (identical results and raw/coded wire-bit
    stats; per-chunk 32-bit headers reported as
    ``payload_header_bits``).
    """

    name = "chunked"

    def all_gather(self, x, axis, books, scheme_name="bf16", *,
                   chunk=DEFAULT_CHUNK, decode_backend=DEFAULT_DECODE_BACKEND):
        n, nl = axis.size, len(axis.batch)
        enc = encode_planes(x, books, scheme_name, chunk=chunk, nl=nl)
        out_planes = {}
        coded = _full(axis, 0, x.device)
        header = 0.0
        for plane, (words, bits, sym) in enc.items():
            nb, n_sym = words.shape[-2], sym.shape[-1]
            coded = coded + _sum_bits(axis.all_gather(bits), nl)
            segs = []
            for c in range(nb):
                count = min(chunk, n_sym - c * chunk)
                gw = axis.all_gather(words[..., c, :])   # batch + (n, cap)
                dec = decode_gathered_chunk(gw, count, books[plane], chunk,
                                            decode_backend)
                segs.append(dec[..., :count])
            out_planes[plane] = torch.cat(segs, dim=-1).reshape(
                *x.shape[:nl], -1)
            header += 32.0 * nb * n
        scheme = SCHEMES[scheme_name]
        y = reassemble(out_planes, scheme_name, _gathered_shape(x, nl, n),
                       x.dtype)
        raw = float(x[(0,) * nl].numel() * scheme.total_symbol_bits()) * n
        stats = {"raw_wire_bits": _full(axis, raw * (n - 1) / n, x.device),
                 "coded_wire_bits": coded * (n - 1) / n,
                 "payload_raw_bits": _full(axis, raw, x.device),
                 "payload_coded_bits": coded,
                 "payload_header_bits": _full(axis, header, x.device)}
        return y, stats

    def all_reduce(self, x, axis, books, scheme_name="bf16", *,
                   chunk=DEFAULT_CHUNK, decode_backend=DEFAULT_DECODE_BACKEND,
                   carry="wire"):
        """Per-chunk gather → decode → add; chunk-local reduction, the
        same numbers and wire stats as the monolithic transport."""
        _require_wire_carry(self.name, carry)
        n, nl = axis.size, len(axis.batch)
        lead = x.shape[:nl]
        enc = encode_planes(x, books, scheme_name, chunk=chunk, nl=nl)
        first = next(iter(enc.values()))
        n_sym, nb = first[2].shape[-1], first[0].shape[-2]
        coded = _full(axis, 0, x.device)
        for _, bits, _ in enc.values():            # headers: one gather/plane
            coded = coded + _sum_bits(axis.all_gather(bits), nl)
        segs = []
        for c in range(nb):
            count = min(chunk, n_sym - c * chunk)
            dec_planes = {}
            for plane, (words, _, _) in enc.items():
                gw = axis.all_gather(words[..., c, :])
                dec_planes[plane] = decode_gathered_chunk(
                    gw, count, books[plane], chunk,
                    decode_backend)[..., :count]
            seg = reassemble(dec_planes, scheme_name, (*lead, n, count),
                             x.dtype)
            segs.append(peer_sum(seg, nl))                # decode-then-add
        y = torch.cat([s.view(_BITS[x.dtype]) for s in segs], dim=-1).view(
            x.dtype).reshape(x.shape)
        scheme = SCHEMES[scheme_name]
        raw = float(x[(0,) * nl].numel() * scheme.total_symbol_bits()) * n
        header = 32.0 * nb * len(enc) * n
        stats = {"raw_wire_bits": _full(axis, raw * (n - 1) / n, x.device),
                 "coded_wire_bits": coded * (n - 1) / n,
                 "payload_raw_bits": _full(axis, raw, x.device),
                 "payload_coded_bits": coded,
                 "payload_header_bits": _full(axis, header, x.device)}
        return y, stats


@register_transport
class RingTransport(Transport):
    """Ring of ppermutes; decode → reduce → re-encode at every hop.

    Delegates to ``repro_torch.comm.ring``; registered here so
    spec-driven dispatch reaches it.
    """

    name = "ring"

    def all_gather(self, x, axis, books, scheme_name="bf16", *,
                   chunk=DEFAULT_CHUNK, decode_backend=DEFAULT_DECODE_BACKEND):
        from .ring import ring_all_gather
        return ring_all_gather(x, axis, books, scheme_name, chunk=chunk,
                               decode_backend=decode_backend)

    def all_reduce(self, x, axis, books, scheme_name="bf16", *,
                   chunk=DEFAULT_CHUNK, decode_backend=DEFAULT_DECODE_BACKEND,
                   carry="wire"):
        from .ring import ring_all_reduce
        return ring_all_reduce(x, axis, books, scheme_name, chunk=chunk,
                               decode_backend=decode_backend, carry=carry)

    def reduce_scatter(self, x, axis, books, scheme_name="bf16", *,
                       chunk=DEFAULT_CHUNK,
                       decode_backend=DEFAULT_DECODE_BACKEND, carry="wire"):
        from .ring import ring_reduce_scatter
        return ring_reduce_scatter(x, axis, books, scheme_name, chunk=chunk,
                                   decode_backend=decode_backend, carry=carry)

    def all_to_all(self, x, axis, books, scheme_name="bf16", *,
                   chunk=DEFAULT_CHUNK,
                   decode_backend=DEFAULT_DECODE_BACKEND):
        from .ring import ring_all_to_all
        return ring_all_to_all(x, axis, books, scheme_name, chunk=chunk,
                               decode_backend=decode_backend)


# -------------------------------------------------------------- dispatch
def all_gather_compressed(x, axis: Axis, books: Dict[str, Codebook], spec
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Registry-driven bitexact all-gather: transport named by the spec."""
    t = get_transport(spec.transport)
    return t.all_gather(x, axis, books, spec.scheme_name, chunk=spec.chunk,
                        decode_backend=spec.decode_backend)


def all_reduce_compressed(x, axis, books: Dict[str, Codebook], spec
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Registry-driven bitexact all-reduce: transport named by the spec.

    When ``spec.axes = (inner, outer)`` is set the op runs as the
    hierarchical two-axis ring, and ``axis`` must map those names to
    their axes (``loopback_mesh``, or a dict of ``ProcessGroupAxis``).
    """
    if getattr(spec, "axes", None):
        from .hierarchy import hierarchical_all_reduce
        if not isinstance(axis, Mapping):
            raise ValueError(f"spec.axes={spec.axes!r} needs a mapping of "
                             f"axis names to axes, got {axis!r}")
        return hierarchical_all_reduce(
            x, tuple(axis[a] for a in spec.axes), books, spec.scheme_name,
            chunk=spec.chunk, decode_backend=spec.decode_backend,
            carry=getattr(spec, "carry", "wire"))
    t = get_transport(spec.transport)
    return t.all_reduce(x, axis, books, spec.scheme_name, chunk=spec.chunk,
                        decode_backend=spec.decode_backend,
                        carry=getattr(spec, "carry", "wire"))


def reduce_scatter_compressed(x, axis: Axis, books: Dict[str, Codebook],
                              spec) -> Tuple[torch.Tensor,
                                             Dict[str, torch.Tensor]]:
    """Registry-driven bitexact reduce-scatter: this rank's flat
    ``ceil(size/n)`` segment of the global sum."""
    t = get_transport(spec.transport)
    return t.reduce_scatter(x, axis, books, spec.scheme_name,
                            chunk=spec.chunk,
                            decode_backend=spec.decode_backend,
                            carry=getattr(spec, "carry", "wire"))


def all_to_all_compressed(x, axis: Axis, books: Dict[str, Codebook], spec
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Registry-driven bitexact all-to-all (``split_axis=0``: x.shape[0]
    of each rank must equal the axis size)."""
    t = get_transport(spec.transport)
    return t.all_to_all(x, axis, books, spec.scheme_name, chunk=spec.chunk,
                        decode_backend=spec.decode_backend)
