"""Compression spec, payload accounting and plane encode/decode (port
of ``repro.comm``; the transports and rings wait for ROADMAP A4)."""
from .compression import CompressionSpec, payload_stats

__all__ = ["CompressionSpec", "payload_stats"]
