"""Compressed checkpoints — the paper's codec applied to weight storage
(port of ``repro.checkpoint.compressed``).

Each bf16 leaf is split into byte planes and coded with one book per
plane built from the whole checkpoint's plane counts (kernel B5 on the
card), through the codec registry.  The npz holds, per leaf and plane,
the chunked coded stream with every chunk trimmed to its own
``(bits + 31) // 32 + 1`` words and concatenated — the at-rest layout of
``memstore.PlaneStream`` — plus the books' lengths and a JSON manifest
(dtypes, shapes, per-chunk [bits, symbols], codec, book epoch, chunk).
The manifest is the reference's format exactly, so a manifest written by
either package opens in the other, and ``load_compressed_store``
re-labels the stored words into a ``CompressedParamStore`` with no
decode round trip.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.codec import default_codec, get_codec
from ..core.symbols import bf16_planes
from ..device import resolve_device
from ..memstore.store import (PLANES, CodedLeaf, CompressedParamStore,
                              PlaneStream, RawLeaf, encode_plane)
from .ckpt import (_flatten, _skeleton, dtype_name, leaf_from_numpy,
                   leaf_to_numpy)

__all__ = ["save_compressed", "load_compressed", "load_compressed_store"]

_CHUNK = 1 << 16          # symbols per coded chunk (manifest "chunk")
_MIN_SIZE = 1024          # leaves below this stay raw


def save_compressed(path: str, tree, extra_meta: Optional[Dict] = None, *,
                    codec: Optional[str] = None, chunk: int = _CHUNK,
                    book_epoch: int = 0, device=None) -> Dict[str, float]:
    """Code ``tree`` on ``device`` (CUDA unless named) and write the
    manifest.  Returns {raw_bytes, stored_bytes, ratio}."""
    from ..kernels.histogram import histogram256
    dev = resolve_device(device)
    codec_name = codec or default_codec()
    codec_obj = get_codec(codec_name)
    flat = _flatten(tree)
    bf16_keys = [k for k, v in flat.items()
                 if v.dtype == torch.bfloat16 and v.numel() >= _MIN_SIZE]
    counts = {p: torch.zeros(256, dtype=torch.int64, device=dev)
              for p in PLANES}
    for k in bf16_keys:
        for p, s in bf16_planes(flat[k].to(dev)).items():
            counts[p] += histogram256(s)
    books = {p: codec_obj.build_book(c.cpu().numpy(), key=("ckpt", "bf16", p))
             for p, c in counts.items()}

    blob: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {"dtypes": {}, "shapes": {}, "bits": {},
                            "compressed": bf16_keys,
                            "codec": codec_name,
                            "book_epoch": int(book_epoch),
                            "chunk": int(chunk),
                            "extra": extra_meta or {}}
    raw_bytes = stored = 0
    for k, v in flat.items():
        meta["dtypes"][k] = dtype_name(v)
        meta["shapes"][k] = list(v.shape)
        raw_bytes += v.numel() * v.element_size()
        if k in bf16_keys:
            meta["bits"][k] = {}
            for p, sym in bf16_planes(v.to(dev)).items():
                ps = encode_plane(sym, books[p], chunk=chunk)
                words = ps.words.cpu().numpy().view(np.uint32)
                blob[f"{k}::{p}"] = words
                meta["bits"][k][p] = [
                    [int(nb), int(ns)] for nb, ns in
                    zip(ps.bit_counts, ps.chunk_counts())]
                stored += words.nbytes
        else:
            arr = leaf_to_numpy(v)
            blob[k] = arr
            stored += arr.nbytes
    for p, b in books.items():
        lengths = np.asarray(b.lengths).astype(np.int32)
        blob[f"__book_{p}__"] = lengths
        stored += lengths.nbytes
    blob["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                     dtype=np.uint8)
    np.savez(path, **blob)
    return {"raw_bytes": float(raw_bytes), "stored_bytes": float(stored),
            "ratio": stored / max(raw_bytes, 1)}


def load_compressed_store(path: str, like=None, *,
                          expect_codec: Optional[str] = None, device=None
                          ) -> Tuple[CompressedParamStore, Dict]:
    """Open a compressed manifest as a ``CompressedParamStore`` on
    ``device`` (CUDA unless named) — no decode round trip: the stored
    per-plane words ARE the store's at-rest streams; the books are
    rebuilt from the recorded lengths through the recorded codec
    (manifests without one are ``huffman`` / epoch 0).

    like:          optional template tree — required later by
                   ``materialize_tree()`` if omitted here.
    expect_codec:  refuse (ValueError) manifests coded differently.
    Returns (store, extra_meta).
    """
    dev = resolve_device(device)
    blob = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(blob["__meta__"]).decode())
    codec_name = meta.get("codec", "huffman")
    book_epoch = int(meta.get("book_epoch", 0))
    chunk = int(meta.get("chunk", 1 << 22))
    if expect_codec is not None and expect_codec != codec_name:
        raise ValueError(
            f"manifest {path!r} is coded with {codec_name!r}, caller "
            f"requires {expect_codec!r}")
    codec_obj = get_codec(codec_name)
    books = {p: codec_obj.book_from_lengths(
                 np.asarray(blob[f"__book_{p}__"], np.int32),
                 key=("ckpt", "bf16", p))
             for p in PLANES}

    entries: Dict[str, Any] = {}
    for k, dtype in meta["dtypes"].items():
        shape = tuple(meta["shapes"][k])
        if k in meta["compressed"]:
            planes = {}
            for p in PLANES:
                bits = meta["bits"][k][p]
                n_symbols = sum(int(ns) for _, ns in bits)
                # a leaf shorter than one chunk was encoded as a single
                # n-symbol block; chunk_counts_for must reproduce the
                # recorded per-chunk symbol counts
                leaf_chunk = (chunk if n_symbols > int(bits[0][1])
                              else int(bits[0][1]))
                words = np.asarray(blob[f"{k}::{p}"], np.uint32)
                planes[p] = PlaneStream(
                    words=torch.from_numpy(words.view(np.int32)).to(dev),
                    bit_counts=np.asarray([nb for nb, _ in bits], np.int64),
                    n_symbols=n_symbols, chunk=leaf_chunk,
                    max_len=books[p].max_len)
            entries[k] = CodedLeaf(shape=shape, planes=planes)
        else:
            entries[k] = RawLeaf(value=leaf_from_numpy(
                blob[k], dtype, dev).reshape(shape))
    if like is not None:
        entries = {k: entries[k] for k in _flatten(like)}
    store = CompressedParamStore(
        entries, books, codec=codec_name, book_epoch=book_epoch,
        chunk=chunk, treedef=_skeleton(like) if like is not None else None,
        device=dev)
    return store, meta["extra"]


def load_compressed(path: str, like, *, expect_codec: Optional[str] = None,
                    device=None) -> Tuple[Any, Dict]:
    """Materialized load: open as a store, decode every leaf."""
    store, extra = load_compressed_store(path, like,
                                         expect_codec=expect_codec,
                                         device=device)
    return store.materialize_tree(like), extra
