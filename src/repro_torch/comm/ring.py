"""Ring-compressed collectives: the payload stays Huffman-coded on every
hop (port of ``repro.comm.ring``).

Every hop of a ring

    decode (B4 for ``auto``/``multisym`` Huffman books, B3 for ``scan``,
      B6 for QLC books)
      → reduce (add for reduce-type ops, forward for gather-type)
        → re-encode (B1 → B2) before forwarding

so every wire transfer carries coded bits and the ledger records the
measured per-hop traffic.  The family, as in the reference:

  ``ring_all_gather``      n−1 hops, forwards unchanged symbols
  ``ring_reduce_scatter``  n−1 decode→add→re-encode hops; rank i ends
                           owning segment i of the global sum
  ``ring_all_reduce``      reduce-scatter phase + all-gather phase,
                           2(n−1) hops
  ``ring_all_to_all``      n−1 rotated-permutation rounds; each shard
                           leaves its source exactly once

A ring runs over an ``Axis`` (``comm.axis``).  On a ``LoopbackAxis``
every rank of the ring is a slice of the leading rank dims, so a hop's
decode is one launch over every rank's chunks and its encode one B1 and
one B2, a plane a hop.  A segment's padded tail (its last chunk past the
segment's end) gets code length 0 in the encode, so it ships no bits,
bit-identical to the reference's count-masked recode.  A gather's last
hop is decoded and not re-encoded: that stream would never ship.  On CUDA tensors
every hop launches the kernels or raises; on CPU tensors the wrappers
run their plain versions.

Numerics: gather-type ops forward values unchanged, so they are
bit-exact for any input.  Reduce-type ops add in the wire dtype by
default (``carry="wire"``), each add as XLA does it (``wire_add``: bf16
through float32; e4m3 through float32 with the reference's overflow to
NaN); ``carry="f32"`` keeps float32 partial sums and ships each hop as
two wire-dtype components (the rounded value and its residual), at 2×
hop payload.

Stats follow the transport convention (replicated values = global/n,
float64 of the axis's batch shape) plus ``hop_coded_bits`` (batch +
(hops,)) and ``hops``.  The payload probe ``payload_coded_bits`` is
B5's histogram · lengths (``kernels.ops.message_bits``), one call a
rank and plane.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..core.codebook import Codebook
from ..core.encoder import DEFAULT_CHUNK, chunk_counts_for
from ..core.symbols import SCHEMES
from .axis import Axis, put_rows, take_rows
from .transport import (_full, _sum_bits, decode_blocks, encode_planes,
                        planes_of, reassemble)
from .wire import _BITS, to_wire, wire_add

__all__ = ["ring_all_gather", "ring_all_reduce", "ring_reduce_scatter",
           "ring_all_to_all", "RING_CARRIES", "DEFAULT_RING_BACKEND"]

RING_CARRIES = ("wire", "f32")
# "auto" resolves per codec inside decode_blocks: huffman → multisym
# (B4), qlc → scan (B6).
DEFAULT_RING_BACKEND = "auto"


def _bits_sum(enc, nl: int) -> torch.Tensor:
    out = 0
    for words_bits in enc.values():
        out = out + _sum_bits(words_bits[1], nl)
    return out


def _coded_payload_bits(x: torch.Tensor, books: Dict[str, Codebook],
                        scheme_name: str, nl: int) -> torch.Tensor:
    """Exact coded size of each rank's payload (B5's histogram · lengths),
    float64 of the batch shape: equals the summed encoded bit counts
    without making the streams."""
    from ..kernels.ops import message_bits
    coded = 0
    for plane, sym in planes_of(x, scheme_name, nl).items():
        rows = sym.reshape(-1, sym.shape[-1])
        bits = torch.stack([message_bits(r, books[plane].lengths)
                            for r in rows])
        coded = coded + bits.reshape(sym.shape[:-1]).to(torch.float64)
    return coded


def _stack_hops(hop_coded, like: torch.Tensor) -> torch.Tensor:
    if hop_coded:
        return torch.stack(hop_coded, dim=-1)
    return like.new_zeros((*like.shape, 0))


def _recode(blocks: torch.Tensor, n: int, book, lead, nb):
    """(R * nb, chunk) symbol blocks of ``n``-symbol segments → (words
    batch + (nb, cap), bits batch + (nb,)), B1 → B2 with each segment's
    padded tail given no bits."""
    from ..kernels.ops import recode_with_book
    words, bits = recode_with_book(blocks, n, book)
    return words.reshape(*lead, nb, -1), bits.reshape(*lead, nb)


def ring_all_gather(x: torch.Tensor, axis: Axis, books: Dict[str, Codebook],
                    scheme_name: str = "bf16", *, chunk: int = DEFAULT_CHUNK,
                    decode_backend: str = DEFAULT_RING_BACKEND
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """All-gather over a ring; every hop decodes and re-encodes.

    Hop h forwards the stream received at hop h−1 (starting with the
    local shard's own).  The incoming chunks are decoded (appended to
    the gathered result) and their blocks re-encoded before the next
    forward.  The codebook is fixed and the codec lossless, so the
    re-encoded stream is bit-identical to the original and the summed
    hop traffic equals the monolithic transport's coded wire bits.
    """
    n, lead = axis.size, axis.batch
    nl = len(lead)
    dev = x.device
    scheme = SCHEMES[scheme_name]
    planes0 = planes_of(x, scheme_name, nl)
    n_sym = next(iter(planes0.values())).shape[-1]
    eff_chunk = max(1, min(chunk, n_sym))
    counts_np = chunk_counts_for(n_sym, eff_chunk)
    nb = int(counts_np.shape[0])
    counts = torch.from_numpy(counts_np).to(dev).repeat(math.prod(lead))

    cur = {plane: (words, bits) for plane, (words, bits, _) in
           encode_planes(x, books, scheme_name, chunk=eff_chunk,
                         nl=nl).items()}
    payload_coded = axis.psum(_bits_sum(cur, nl))

    # rel[plane][h] = symbols of the shard that originated h hops upstream
    rel = {plane: [sym] for plane, sym in planes0.items()}
    hop_coded = []
    for h in range(n - 1):
        hop_coded.append(axis.psum(_bits_sum(cur, nl)) / n)
        nxt = {}
        for plane, (words, bits) in cur.items():
            rw, _ = axis.ppermute((words, bits), 1)
            blocks = decode_blocks(rw.reshape(-1, rw.shape[-1]), counts,
                                   books[plane], eff_chunk, decode_backend)
            rel[plane].append(blocks.reshape(*lead, -1)[..., :n_sym].to(
                torch.uint8))
            if h < n - 2:                  # last hop's recode never ships
                nxt[plane] = _recode(blocks, n_sym, books[plane], lead, nb)
        cur = nxt

    # hop-relative → absolute shard order: rel[h] came from rank (i−h)%n
    idx = (axis.index(dev)[..., None] - torch.arange(n, device=dev)) % n
    out_planes = {plane: take_rows(torch.stack(lst, dim=nl), idx,
                                   nl).reshape(*lead, -1)
                  for plane, lst in rel.items()}
    s = x.shape[nl:]
    y = reassemble(out_planes, scheme_name, (*lead, n * s[0], *s[1:]),
                   x.dtype)

    size = x[(0,) * nl].numel()
    raw = float(size * scheme.total_symbol_bits()) * n
    coded_wire = sum(hop_coded, _full(axis, 0, dev))
    stats = {"raw_wire_bits": _full(axis, raw * (n - 1) / n, dev),
             "coded_wire_bits": coded_wire,
             "payload_raw_bits": _full(axis, raw, dev),
             "payload_coded_bits": payload_coded,
             "payload_header_bits": _full(
                 axis, 32.0 * nb * len(planes0) * (n - 1), dev),
             "hop_coded_bits": _stack_hops(hop_coded, coded_wire),
             "hops": _full(axis, (n - 1) / n, dev)}
    return y, stats


class _SegmentRing:
    """Shared geometry + hop codec for the segment-based ring ops.

    Splits each rank's flat tensor into n ``seg_len`` segments (the last
    zero-padded to a whole number of chunks) and provides the per-hop
    encode / ppermute-decode steps that ``ring_reduce_scatter`` and
    ``ring_all_reduce`` compose.  ``carry`` selects the accumulation
    dtype across hops: ``"wire"`` reduces in the scheme dtype; ``"f32"``
    ships each hop as two wire-dtype components (rounded value +
    residual) and accumulates in float32.
    """

    def __init__(self, x: torch.Tensor, axis: Axis,
                 books: Dict[str, Codebook], scheme_name: str, chunk: int,
                 decode_backend: str, carry: str):
        if carry not in RING_CARRIES:
            raise ValueError(f"unknown carry {carry!r}; one of "
                             f"{RING_CARRIES}")
        self.axis = axis
        self.books = books
        self.scheme_name = scheme_name
        self.scheme = SCHEMES[scheme_name]
        self.decode_backend = decode_backend
        self.carry = carry
        self.dtype = x.dtype
        self.n = n = axis.size
        self.lead = lead = axis.batch
        self.nl = nl = len(lead)
        self.device = x.device
        self.size = x[(0,) * nl].numel()
        self.seg_len = -(-self.size // n)
        self.acc_dtype = torch.float32 if carry == "f32" else x.dtype
        self.ncomp = 2 if carry == "f32" else 1
        flat = x.reshape(*lead, -1)
        if carry == "f32":
            flat = flat.float()
        self.acc = self._pad(flat, n * self.seg_len).reshape(
            *lead, n, self.seg_len)
        self.i = axis.index(self.device)
        self.eff_chunk = max(1, min(chunk, self.seg_len))
        counts_np = chunk_counts_for(self.seg_len, self.eff_chunk)
        self.nb = int(counts_np.shape[0])
        self.counts = torch.from_numpy(counts_np).to(self.device).repeat(
            math.prod(lead))
        self.pad_len = self.nb * self.eff_chunk

    # ---------------------------------------------------------- helpers
    def _pad(self, v: torch.Tensor, length: int) -> torch.Tensor:
        """Zero-pad the last dim to ``length`` (through an integer view:
        torch pads no fp8)."""
        if v.shape[-1] == length:
            return v
        bits = _BITS[v.dtype]
        return torch.nn.functional.pad(v.view(bits), (
            0, length - v.shape[-1])).view(v.dtype)

    def local_seg(self, idx: torch.Tensor) -> torch.Tensor:
        """Padded local copy of segment ``idx % n`` in the carry dtype."""
        seg = take_rows(self.acc, idx % self.n, self.nl)
        return self._pad(seg, self.pad_len)

    def to_comps(self, vals: torch.Tensor):
        """Padded acc-dtype values → wire-dtype hop components."""
        if self.carry == "wire":
            return (vals,)
        hi = to_wire(vals, self.dtype)
        lo = to_wire(vals - hi.float(), self.dtype)
        return (hi, lo)

    def from_comps(self, comps) -> torch.Tensor:
        if self.carry == "wire":
            return comps[0]
        return comps[0].float() + comps[1].float()

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A hop's reduce: the wire dtype's add, or float32's."""
        return a + b if self.carry == "f32" else wire_add(a, b)

    def encode_cur(self, vals: torch.Tensor):
        """Planes of each component on the padded layout, packed by the
        block recode (pad slots ship no bits)."""
        enc = {}
        for ci, cv in enumerate(self.to_comps(vals)):
            for plane, sym in planes_of(cv, self.scheme_name,
                                        self.nl).items():
                enc[(ci, plane)] = _recode(
                    sym.reshape(-1, self.eff_chunk), self.seg_len,
                    self.books[plane], self.lead, self.nb)
        return enc

    def decode_hop(self, enc):
        """ppermute the coded words (with their bit-count headers) one
        rank on and decode them to blocks, one launch a plane for every
        rank.  Returns (blocks by (component, plane), component values):
        the blocks feed the gather-phase recode, the values the add."""
        blocks = {}
        for key, (words, bits) in enc.items():
            rw, _ = self.axis.ppermute((words, bits), 1)
            blocks[key] = decode_blocks(
                rw.reshape(-1, rw.shape[-1]), self.counts,
                self.books[key[1]], self.eff_chunk, self.decode_backend)
        comps = tuple(
            reassemble({p: blocks[(ci, p)].reshape(*self.lead, -1)
                        for p in self.scheme.planes},
                       self.scheme_name, (*self.lead, self.pad_len),
                       self.dtype)
            for ci in range(self.ncomp))
        return blocks, comps

    def recode(self, blocks):
        """Gather-phase recode: unchanged symbol blocks → coded words."""
        return {key: _recode(bl, self.seg_len, self.books[key[1]],
                             self.lead, self.nb)
                for key, bl in blocks.items()}

    def hop_bits(self, enc) -> torch.Tensor:
        return self.axis.psum(_bits_sum(enc, self.nl)) / self.n

    def reduce_phase(self, start_offset: int, *, encode_final: bool):
        """n−1 decode → add → re-encode hops.

        Rank i starts with its local copy of segment
        ``(i + start_offset) % n`` and ends owning the fully reduced
        segment ``(i + start_offset + 1) % n``.  Returns
        ``(cur, enc, hop_coded)``: the owned padded segment in the carry
        dtype, its coded form (``None`` unless ``encode_final``) and the
        measured per-hop coded bits.
        """
        hop_coded = []
        cur = self.local_seg(self.i + start_offset)
        enc = self.encode_cur(cur)
        for t in range(self.n - 1):
            hop_coded.append(self.hop_bits(enc))
            _, comps = self.decode_hop(enc)
            local = self.local_seg(self.i + start_offset - t - 1)
            cur = self.add(self.from_comps(comps), local)
            enc = (self.encode_cur(cur)
                   if (t < self.n - 2 or encode_final) else None)
        return cur, enc, hop_coded

    def out_dtype(self, v: torch.Tensor) -> torch.Tensor:
        """Carry-dtype values → the payload's dtype."""
        return to_wire(v, self.dtype) if self.carry == "f32" else v

    def full(self, value) -> torch.Tensor:
        return _full(self.axis, value, self.device)

    def header_bits(self, hops: int) -> torch.Tensor:
        return self.full(32.0 * self.nb * len(self.scheme.planes)
                         * self.ncomp * hops)

    def raw_seg_bits(self) -> float:
        return float(self.seg_len * self.scheme.total_symbol_bits()
                     * self.ncomp)

    def payload_raw_bits(self) -> torch.Tensor:
        return self.full(float(self.size * self.scheme.total_symbol_bits())
                         * self.n)


def ring_reduce_scatter(x: torch.Tensor, axis: Axis,
                        books: Dict[str, Codebook],
                        scheme_name: str = "bf16", *,
                        chunk: int = DEFAULT_CHUNK,
                        decode_backend: str = DEFAULT_RING_BACKEND,
                        carry: str = "wire"
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Ring reduce-scatter: the all_reduce's first phase, stopped before
    the gather phase — n−1 decode→add→re-encode hops.

    Each rank's tensor flattens into n segments of ``ceil(size/n)``
    elements (tail zero-padded).  Rank i returns the fully reduced
    segment i of the global sum (``psum_scatter(tiled=True)`` on the
    flattened tensor).  The final partial sum is never re-encoded, so
    exactly n−1 coded transfers ride the wire.
    """
    r = _SegmentRing(x, axis, books, scheme_name, chunk, decode_backend,
                     carry)
    payload_coded = axis.psum(_coded_payload_bits(x, books, scheme_name,
                                                  r.nl))
    # start offset −1: rank i ends owning segment (i − 1 + 1) % n = i.
    cur, _, hop_coded = r.reduce_phase(-1, encode_final=False)
    y = r.out_dtype(cur[..., :r.seg_len])

    coded_wire = sum(hop_coded, r.full(0))
    stats = {"raw_wire_bits": r.full((r.n - 1) * r.raw_seg_bits()),
             "coded_wire_bits": coded_wire,
             "payload_raw_bits": r.payload_raw_bits(),
             "payload_coded_bits": payload_coded,
             "payload_header_bits": r.header_bits(r.n - 1),
             "hop_coded_bits": _stack_hops(hop_coded, coded_wire),
             "hops": r.full((r.n - 1) / r.n)}
    return y, stats


def ring_all_reduce(x: torch.Tensor, axis: Axis, books: Dict[str, Codebook],
                    scheme_name: str = "bf16", *, chunk: int = DEFAULT_CHUNK,
                    decode_backend: str = DEFAULT_RING_BACKEND,
                    carry: str = "wire"
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Ring all-reduce (reduce-scatter + all-gather), coded on every hop.

    Reduce-scatter phase (n−1 hops): each hop moves the coded
    partial-sum segment one rank on, decodes it, adds the local
    contribution and re-encodes it; the last reduce hop's encode is the
    first gather send.  All-gather phase (n−1 hops): the fully reduced
    segments travel the ring, each hop re-encoding the decoder's blocks.
    Total 2(n−1) coded hops; analytic raw volume 2(n−1)/n × payload.
    ``carry`` as in ``_SegmentRing``.
    """
    r = _SegmentRing(x, axis, books, scheme_name, chunk, decode_backend,
                     carry)
    n, i, nl = r.n, r.i, r.nl
    payload_coded = axis.psum(_coded_payload_bits(x, books, scheme_name, nl))

    # --- reduce-scatter: n−1 decode → add → re-encode hops -------------
    cur, enc, hop_coded = r.reduce_phase(0, encode_final=True)

    # rank i now owns the fully reduced segment (i+1)%n; `enc` already
    # holds its coded form — the first gather hop ships it as it is.
    bits = _BITS[r.acc_dtype]
    out = torch.zeros((*r.lead, n, r.seg_len), dtype=bits, device=r.device)
    out = put_rows(out, (i + 1) % n, cur[..., :r.seg_len].view(bits), nl)

    # --- all-gather: n−1 hops, blocks recode directly ------------------
    for t in range(n - 1):
        hop_coded.append(r.hop_bits(enc))
        blocks, comps = r.decode_hop(enc)
        out = put_rows(out, (i - t) % n,
                       r.from_comps(comps)[..., :r.seg_len].view(bits), nl)
        if t < n - 2:                      # last hop's recode never ships
            enc = r.recode(blocks)

    flat = out.view(r.acc_dtype).reshape(*r.lead, -1)[..., :r.size]
    y = r.out_dtype(flat).reshape(x.shape)

    coded_wire = sum(hop_coded, r.full(0))
    stats = {"raw_wire_bits": r.full(2.0 * (n - 1) * r.raw_seg_bits()),
             "coded_wire_bits": coded_wire,
             "payload_raw_bits": r.payload_raw_bits(),
             "payload_coded_bits": payload_coded,
             "payload_header_bits": r.header_bits(2 * (n - 1)),
             "hop_coded_bits": _stack_hops(hop_coded, coded_wire),
             "hops": r.full(2 * (n - 1) / n)}
    return y, stats


def ring_all_to_all(x: torch.Tensor, axis: Axis, books: Dict[str, Codebook],
                    scheme_name: str = "bf16", *, chunk: int = DEFAULT_CHUNK,
                    decode_backend: str = DEFAULT_RING_BACKEND
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """All-to-all over rotated ppermute rounds, coded on every wire.

    Each rank's ``x`` carries the n destination shards on its leading
    axis (``split_axis=0``): shard j of rank i is destined for rank j.
    Round t ∈ {1, …, n−1} ships the shard destined t ranks downstream,
    coded in the chunked block layout, through the rotation i → (i+t) %
    n, and decodes the shard arriving from t ranks upstream.  Every
    shard leaves its source exactly once: per-rank egress is the
    all-to-all minimum (n−1)/n × payload; ``hop_coded_bits[t−1]`` is
    round t's measured coded bits.  Values are forwarded unchanged, so
    the result is bit-exact for any input.
    """
    n, lead = axis.size, axis.batch
    nl = len(lead)
    dev = x.device
    if x.shape[nl] != n:
        raise ValueError(f"ring_all_to_all needs x.shape[0] == axis size "
                         f"({n}), got {tuple(x.shape[nl:])}")
    scheme = SCHEMES[scheme_name]
    bits_dt = _BITS[x.dtype]
    rows = x.reshape(*lead, n, -1).view(bits_dt)
    blk = rows.shape[-1]
    eff_chunk = max(1, min(chunk, blk))
    counts_np = chunk_counts_for(blk, eff_chunk)
    nb = int(counts_np.shape[0])
    counts = torch.from_numpy(counts_np).to(dev).repeat(math.prod(lead))
    i = axis.index(dev)

    payload_coded = axis.psum(_coded_payload_bits(x, books, scheme_name, nl))

    # the shard for this rank never rides the wire
    out = put_rows(torch.zeros_like(rows), i, take_rows(rows, i, nl), nl)
    hop_coded = []
    for t in range(1, n):
        row = take_rows(rows, (i + t) % n, nl).view(x.dtype)
        enc = encode_planes(row, books, scheme_name, chunk=eff_chunk, nl=nl)
        hop_coded.append(axis.psum(sum(
            (_sum_bits(e[1], nl) for e in enc.values()), _full(axis, 0, dev)))
            / n)
        dec_planes = {}
        for plane, (words, bits, _) in enc.items():
            rw, _ = axis.ppermute((words, bits), t)
            blocks = decode_blocks(rw.reshape(-1, rw.shape[-1]), counts,
                                   books[plane], eff_chunk, decode_backend)
            dec_planes[plane] = blocks.reshape(*lead, -1)[..., :blk]
        val = reassemble(dec_planes, scheme_name, (*lead, blk), x.dtype)
        out = put_rows(out, (i - t) % n, val.view(bits_dt), nl)

    y = out.view(x.dtype).reshape(x.shape)
    raw_local = float(x[(0,) * nl].numel() * scheme.total_symbol_bits())
    coded_wire = sum(hop_coded, _full(axis, 0, dev))
    stats = {"raw_wire_bits": _full(axis, raw_local * (n - 1) / n, dev),
             "coded_wire_bits": coded_wire,
             "payload_raw_bits": _full(axis, raw_local * n, dev),
             "payload_coded_bits": payload_coded,
             "payload_header_bits": _full(
                 axis, 32.0 * nb * len(scheme.planes) * (n - 1), dev),
             "hop_coded_bits": _stack_hops(hop_coded, coded_wire),
             "hops": _full(axis, (n - 1) / n, dev)}
    return y, stats
