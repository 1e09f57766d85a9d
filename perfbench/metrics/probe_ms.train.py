"""probe_ms.train: device ms of the profiled step in the gradient
probe's histograms (B5 ``histogram256``)."""
from perfbench.lib.trace import ops_matching


def read(rec):
    tr = rec.get("trace")
    t = ops_matching(tr, ("histogram256",)) if tr else 0.0
    return t * 1e3 if t > 0 else None
