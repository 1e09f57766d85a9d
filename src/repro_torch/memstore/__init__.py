"""Compressed-at-rest serving memory: coded params and KV cache in
device memory (port of ``repro.memstore``).

``store.CompressedParamStore`` holds bf16 param leaves as chunked coded
byte-plane streams; ``kvstore.CodedKVStore`` does the same for the
Engine's KV cache, differentially per decode step.  The fused consume
path is ``kernels.decode_matmul`` (B7/B8);
``checkpoint.load_compressed_store`` opens a compressed checkpoint
manifest as a store without a decode round trip.
"""
from .store import (CodedLeaf, CompressedParamStore, PlaneStream, RawLeaf,
                    decode_plane_stream, encode_plane)
from .kvstore import CodedKVStore

__all__ = [
    "CodedLeaf", "CodedKVStore", "CompressedParamStore", "PlaneStream",
    "RawLeaf", "decode_plane_stream", "encode_plane",
]
