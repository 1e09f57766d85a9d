"""Checkpoints (port of ``repro.checkpoint``): flat npz snapshots and
compressed manifests that open as a ``memstore.CompressedParamStore``."""
from .ckpt import load_pytree, save_pytree
from .compressed import (load_compressed, load_compressed_store,
                         save_compressed)

__all__ = ["load_pytree", "save_pytree", "load_compressed",
           "load_compressed_store", "save_compressed"]
