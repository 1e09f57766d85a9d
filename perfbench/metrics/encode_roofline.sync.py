"""encode_roofline.sync: B1 + B2 (``encode_lookup``, ``pack_blocks``)
against their roofline, %: one sync's encode bytes (a byte read a
symbol, each coded bit written once; ``roofline.ring``) at 3.35 TB/s
over B1 + B2's device time in the profiled sync."""
from perfbench.lib.trace import ops_matching
from perfbench.roofline.peaks import HBM_BYTES_PER_S
from perfbench.roofline.ring import codec_bytes


def read(rec):
    tr = rec.get("trace")
    t = ops_matching(tr, ("encode_lookup", "pack_blocks")) if tr else 0.0
    if t <= 0:
        return None
    b = codec_bytes(rec["buckets"], rec["hop_bits"], rec["ranks"])
    return 100.0 * b / HBM_BYTES_PER_S / t
