"""itl_p95_ms: the 95th percentile of the gaps between a request's
tokens after its first, in ms.  Every request of a call gets a token at
each decode step, so the gaps are the engine's ``step_seconds`` (host
clock around the replay, the sample and the step's one host sync), each
counted once a request."""
import numpy as np


def read(rec):
    if "calls" not in rec:
        return None
    steps = [s for c in rec["calls"] for s in c["steps"]]
    if not steps:
        return None
    return float(np.percentile(np.repeat(steps, rec["batch"]), 95)) * 1e3
