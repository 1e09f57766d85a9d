"""decode_roofline.sync: B4 (``decode_multisym``) against its roofline,
%: one sync's decode bytes (each coded bit read once, a byte written a
symbol; ``roofline.ring``) at 3.35 TB/s over B4's device time in the
profiled sync."""
from perfbench.lib.trace import ops_matching
from perfbench.roofline.peaks import HBM_BYTES_PER_S
from perfbench.roofline.ring import codec_bytes


def read(rec):
    tr = rec.get("trace")
    t = ops_matching(tr, ("decode_multisym",)) if tr else 0.0
    if t <= 0:
        return None
    b = codec_bytes(rec["buckets"], rec["hop_bits"], rec["ranks"])
    return 100.0 * b / HBM_BYTES_PER_S / t
