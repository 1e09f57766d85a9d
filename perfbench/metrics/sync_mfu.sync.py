"""sync_mfu.sync: the share (%) of the HBM peak that bounds the whole
sync: its least bytes (``roofline.ring.sync_bytes``) at 3.35 TB/s over
the median untraced sync's wall time."""
import statistics

from perfbench.roofline.peaks import HBM_BYTES_PER_S
from perfbench.roofline.ring import sync_bytes


def read(rec):
    if not rec.get("sync_s"):
        return None
    b = sync_bytes(rec["buckets"], rec["hop_bits"], rec["ranks"])
    return 100.0 * b / HBM_BYTES_PER_S / statistics.median(rec["sync_s"])
