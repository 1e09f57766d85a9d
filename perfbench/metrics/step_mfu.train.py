"""step_mfu.train: model FLOPs of a train step (3 × the analytic
forward, no recomputation counted; ``roofline.least.train_flops``) at
989 TFLOP/s, over the median untraced step's wall time, %."""
import statistics

from perfbench.roofline.least import train_flops
from perfbench.roofline.peaks import BF16_FLOPS


def read(rec):
    if not rec.get("step_s"):
        return None
    f = train_flops(rec["model"], rec["batch"], rec["seq_len"])
    return 100.0 * f / BF16_FLOPS / statistics.median(rec["step_s"])
