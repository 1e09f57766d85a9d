"""codec_ms.serve: device ms a decode step in the wire's kernels (B1
``encode_lookup``, B2 ``pack_blocks``, B4 ``decode_multisym``, B5
``histogram256``), from the profiled call's trace."""
from perfbench.lib.trace import ops_matching

KERNELS = ("encode_lookup", "pack_blocks", "decode_multisym",
           "histogram256")


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    s = ops_matching(tr, KERNELS)
    if s <= 0:
        return None
    return s / (rec["new_tokens"] - 1) * 1e3
