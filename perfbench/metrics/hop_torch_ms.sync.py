"""hop_torch_ms.sync: device ms of one whole sync outside the codec's
kernels (B1, B2, B4, B5): the hops' adds, rolls, merges, casts and
copies, from the profiled sync."""
from perfbench.lib.trace import ops_matching

CODEC = ("encode_lookup", "pack_blocks", "decode_multisym", "histogram256")


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return (sum(tr["op_s"].values()) - ops_matching(tr, CODEC)) * 1e3
