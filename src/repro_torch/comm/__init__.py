"""Compressed collective-communication layer (port of ``repro.comm``):
the paper's deployment surface, fixed-codebook Huffman compression of
collective payloads.

Bitexact wire strategies are pluggable transports (``transport.py``):
monolithic endpoint-decode, chunked streaming, and the ring
(``ring.py``) that decodes → reduces → re-encodes on every hop, with the
two-axis hierarchical ring (``hierarchy.py``).  Ledger mode
(``collectives.py``) runs the plain collective and accounts its coded
size.  Every collective runs over an ``Axis`` (``axis.py``): a loopback
axis stacks all ranks in one process (one card), a process-group axis
runs one rank a process.
"""
from .axis import (Axis, LoopbackAxis, ProcessGroupAxis, loopback_mesh,
                   process_group_mesh)
from .collectives import (all_gather, all_gather_bitexact,
                          all_gather_bitexact_chunked, all_gather_compressed,
                          all_reduce, all_reduce_compressed, all_to_all,
                          all_to_all_compressed, merge_stats, ppermute,
                          psum_bitexact, psum_bitexact_chunked, reduce_scatter,
                          reduce_scatter_compressed, zero_stats)
from .compression import (KNOWN_TRANSPORTS, CompressionSpec, histogram256,
                          payload_stats, shannon_bits)
from .hierarchy import hierarchical_all_reduce, hierarchical_wire_factor
from .ledger import CollectiveLedger, LedgerEntry
from .ring import (ring_all_gather, ring_all_reduce, ring_all_to_all,
                   ring_reduce_scatter)
from .transport import (TRANSPORTS, ChunkedTransport, MonolithicTransport,
                        RingTransport, Transport, get_transport,
                        register_transport)

__all__ = [k for k in dir() if not k.startswith("_")]
