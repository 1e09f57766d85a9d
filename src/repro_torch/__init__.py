"""PyTorch/CUDA port of the single-stage Huffman wire (``repro`` is the
JAX reference it is held against).

Layout mirrors the reference package: ``core`` (books, symbol planes,
wire format and plain-torch codecs), ``kernels`` (hand-written Hopper
CUDA kernels behind ctypes wrappers, each with its plain-torch twin),
``comm`` (compression spec, transports and compressed collectives),
``lifecycle`` (drift monitor, epoch-versioned books, agreement),
``memstore`` and ``checkpoint`` (coded at rest), ``models`` (dense
attention transformer), ``optim``, ``data`` and ``train`` (the train
step with its gradient probe), ``configs``, ``serve`` and ``launch``.

Entry points run on the card: without ``device="cpu"`` they ask for
CUDA and raise where there is none.  The package imports ``torch`` and
never ``jax``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
