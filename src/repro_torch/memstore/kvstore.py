"""CodedKVStore — coded-at-rest KV cache for serve decode steps (port of
``repro.memstore.kvstore``).

Wraps the Engine's cache tree: every attention cache node (``{"k", "v",
"pos"}`` dicts from ``models.layers.attn_cache_init``, stacked per group
as ``(L, B, slots, KV, hd)`` with ``pos (L, slots)``) has its newly
written slots encoded each step with per-plane books, and decoded back
on read.  Other cache state passes through raw and is counted on both
sides of the ledger.

The write path is **differential**: ``ingest(caches)`` compares each
node's ``pos`` with the last one seen, on the host (one read of ``pos``
per node, so a coded step waits for the device there), and encodes
exactly the slots whose absolute position changed — the whole prompt
after prefill, one slot per decode step.  Segments replay in ingest
order on ``read``, so a re-written slot resolves to its latest contents;
reads rebuild from zeros, which matches ``attn_cache_init`` exactly, so
the round trip is bit-exact.  Where the reference decodes segment by
segment, ``read`` here decodes all segments of one node and plane (one
book, one chunk size) in one call — one B4 or B6 launch per plane — with
the same result.

Books: given, or built at the first ingest from the K/V byte-plane
histograms of every dirty segment (kernel B5 on the device), through the
codec registry, and then pinned for the store's lifetime.

Ledger: ``kv_hbm_raw_bits`` counts the bf16 bits of every ingested
slot's K/V (plus raw pass-through state and the host ``pos`` vectors);
``kv_hbm_coded_bits`` the tight coded payload + per-chunk headers (plus
the same pass-through), as the reference counts them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.codec import default_codec, get_codec
from ..core.symbols import bf16_from_planes, bf16_planes
from ..device import resolve_device
from .store import (PLANES, PlaneStream, decode_plane_streams, encode_blocks,
                    tighten)

__all__ = ["DEFAULT_KV_CHUNK", "CodedKVStore"]

DEFAULT_KV_CHUNK = 512


def _is_kv_node(x) -> bool:
    return isinstance(x, dict) and "k" in x and "v" in x and "pos" in x


def _nodes(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(name, node) for every KV node or other leaf, named as JAX's
    ``keystr`` names the reference's paths."""
    if _is_kv_node(tree) or not isinstance(tree, (dict, list, tuple)):
        return [(path, tree)]
    if isinstance(tree, dict):
        items = [(f"{path}[{k!r}]", tree[k]) for k in sorted(tree)]
    else:
        items = [(f"{path}[{i}]", v) for i, v in enumerate(tree)]
    return [nv for p, sub in items for nv in _nodes(sub, p)]


def _rebuild(tree, fn: Callable[[str, Any], Any], path: str = ""):
    """``tree`` with every node of ``_nodes`` replaced by ``fn(name,
    node)``."""
    if _is_kv_node(tree) or not isinstance(tree, (dict, list, tuple)):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{path}[{k!r}]") for k, v in tree.items()}
    return type(tree)(_rebuild(v, fn, f"{path}[{i}]")
                      for i, v in enumerate(tree))


def _coded(node) -> bool:
    return _is_kv_node(node) and node["k"].dtype == torch.bfloat16


@dataclass
class _Segment:
    """Coded K/V for one batch of slots of one cache node."""
    slots: torch.Tensor                     # (s,) int64 slot indices
    shape: Tuple[int, ...]                  # (..., s, KV, hd)
    k_planes: Dict[str, PlaneStream]
    v_planes: Dict[str, PlaneStream]

    @property
    def raw_bits(self) -> int:
        return 2 * 16 * int(np.prod(self.shape))

    @property
    def coded_bits(self) -> int:
        return (sum(p.stored_bits for p in self.k_planes.values())
                + sum(p.stored_bits for p in self.v_planes.values()))


class CodedKVStore:
    """Coded-at-rest KV cache: differential coded appends, decode on
    read.  See module docstring."""

    def __init__(self, books: Optional[Mapping[str, Any]] = None, *,
                 codec: Optional[str] = None,
                 chunk: int = DEFAULT_KV_CHUNK, backend: str = "auto",
                 device=None):
        if books is not None:
            for p in PLANES:
                if p not in books:
                    raise ValueError(f"books must map byte plane {p!r}")
        self._init_books = dict(books) if books is not None else None
        self.codec = (codec
                      or (getattr(next(iter(books.values())), "codec_name",
                                  None) if books else None)
                      or default_codec())
        get_codec(self.codec)                # validate eagerly
        self.chunk = int(chunk)
        self.backend = backend
        self.device = resolve_device(device)
        self.reset()

    def reset(self) -> None:
        self.books = (dict(self._init_books)
                      if self._init_books is not None else None)
        self._segments: Dict[str, List[_Segment]] = {}
        self._pos: Dict[str, np.ndarray] = {}
        self._pos_dev: Dict[str, torch.Tensor] = {}
        self._raw: Dict[str, Any] = {}
        self.last_read_chunks: Dict[str, int] = {}

    def _ensure_books(self, arrays) -> None:
        """Build the books from the first ingest's K/V data when none were
        supplied: B5 histograms of both byte planes across every dirty
        segment, one read of the counts, one build per plane.  Floor
        smoothing keeps the books lossless for any later appends."""
        if self.books is not None:
            return
        from ..kernels.histogram import histogram256
        codec = get_codec(self.codec)
        counts = {p: torch.zeros(256, dtype=torch.int64, device=self.device)
                  for p in PLANES}
        for arr in arrays:
            planes = bf16_planes(arr)
            for p in PLANES:
                counts[p] += histogram256(planes[p])
        host = torch.stack([counts[p] for p in PLANES]).cpu().numpy()
        self.books = {p: codec.build_book(host[i], key=("kv", "bf16", p))
                      for i, p in enumerate(PLANES)}

    # ------------------------------------------------------------------
    def ingest(self, caches) -> int:
        """Encode every cache slot whose ``pos`` changed since the last
        ingest (prefill: all occupied slots; decode: the step's slot).
        Returns the number of slots newly coded."""
        dirty = []
        for name, node in _nodes(caches):
            if not _coded(node):
                self._raw[name] = node
                continue
            pos = node["pos"].cpu().numpy().astype(np.int32)
            prev = self._pos.get(name)
            if prev is None:
                prev = np.full_like(pos, -1)
            # a slot is dirty if ANY row's absolute position changed onto
            # it (the slot axis is last)
            mask = (pos != prev) & (pos >= 0)
            if mask.ndim > 1:
                mask = mask.reshape(-1, mask.shape[-1]).any(axis=0)
            changed = np.nonzero(mask)[0]
            self._pos[name] = pos
            self._pos_dev[name] = node["pos"].clone()
            if changed.size == 0:
                continue
            # k/v are (..., slots, heads, head_dim): the slot axis is -3
            slots = torch.from_numpy(changed).to(node["k"].device)
            axis = node["k"].dim() - 3
            dirty.append((name, slots, node["k"].index_select(axis, slots),
                          node["v"].index_select(axis, slots)))
        if not dirty:
            return 0
        self._ensure_books([a for _, _, k, v in dirty for a in (k, v)])
        coded = []                      # B1 → B2 for every plane first,
        for name, slots, k_seg, v_seg in dirty:     # then one bits read
            planes = []
            for kv, seg in (("k", k_seg), ("v", v_seg)):
                sym = bf16_planes(seg)
                planes += [(kv, p, encode_blocks(sym[p], self.books[p],
                                                 chunk=self.chunk))
                           for p in PLANES]
            coded.append((name, slots, k_seg, planes))
        bits = torch.cat([b for *_, planes in coded
                          for _, _, (_, b) in planes]).cpu().numpy()
        wrote, row = 0, 0
        for name, slots, k_seg, planes in coded:
            streams: Dict[str, Dict[str, PlaneStream]] = {"k": {}, "v": {}}
            for kv, p, (words, dev_bits) in planes:
                nb = words.shape[0]
                streams[kv][p] = tighten(words, dev_bits, bits[row:row + nb],
                                         k_seg.numel(), chunk=self.chunk,
                                         max_len=self.books[p].max_len)
                row += nb
            self._segments.setdefault(name, []).append(_Segment(
                slots=slots, shape=tuple(k_seg.shape),
                k_planes=streams["k"], v_planes=streams["v"]))
            wrote += int(slots.numel())
        return wrote

    def read(self, like):
        """Rebuild the cache tree by decoding every segment (in ingest
        order) into zero-initialised k/v tensors — the exact inverse of
        the ``attn_cache_init`` + slot-write path.  ``last_read_chunks``
        then maps each coded node to the chunks that each byte plane's
        decode call of this read took."""
        self.last_read_chunks = {}

        def rebuild(name, node):
            if not _coded(node):
                return self._raw.get(name, node)
            k = torch.zeros_like(node["k"])
            v = torch.zeros_like(node["v"])
            segs = self._segments.get(name, [])
            if segs:
                streams = {p: [s for seg in segs for s in (seg.k_planes[p],
                                                           seg.v_planes[p])]
                           for p in PLANES}
                self.last_read_chunks[name] = sum(
                    len(s.bit_counts) for s in streams[PLANES[0]])
                sym = {p: decode_plane_streams(streams[p], self.books[p],
                                               backend=self.backend)
                       for p in PLANES}
                axis = k.dim() - 3
                for i, seg in enumerate(segs):
                    for j, dst in enumerate((k, v)):
                        dst.index_copy_(axis, seg.slots, bf16_from_planes(
                            sym["lo"][2 * i + j], sym["hi"][2 * i + j]
                        ).reshape(seg.shape))
            pos = self._pos_dev.get(name)
            rebuilt = dict(node)
            rebuilt.update(k=k, v=v, pos=(pos.clone() if pos is not None
                                          else node["pos"]))
            return rebuilt

        return _rebuild(like, rebuild)

    # ------------------------------------------------------------------
    def _raw_leaf_bits(self) -> int:
        bits = 0
        for node in self._raw.values():
            for _, leaf in _nodes(list(node.values())
                                  if isinstance(node, dict) else node):
                bits += leaf.numel() * leaf.element_size() * 8
        for pos in self._pos.values():
            bits += pos.nbytes * 8
        return bits

    @property
    def kv_hbm_raw_bits(self) -> int:
        seg = sum(s.raw_bits for segs in self._segments.values()
                  for s in segs)
        return seg + self._raw_leaf_bits()

    @property
    def kv_hbm_coded_bits(self) -> int:
        seg = sum(s.coded_bits for segs in self._segments.values()
                  for s in segs)
        return seg + self._raw_leaf_bits()
