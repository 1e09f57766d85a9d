"""step_mfu.serve: the share (%) of the chip's peak that bounds each
served step, over the calls outside the profiled one: for the prefill
and every decode step, the larger of its FLOPs at 989 TFLOP/s and its
least HBM bytes at 3.35 TB/s (``roofline.least``), summed, over the
calls' wall time."""
from perfbench.roofline import least


def read(rec):
    m, b = rec["model"], rec["batch"]
    npre, new = rec["prefix_len"], rec["new_tokens"]
    bound = wall = 0.0
    for c in rec.get("calls", []):
        if c["traced"]:
            continue
        s_tok = c["prompt_len"]
        seq = npre + s_tok
        bound += least.prefill_bound_s(m, b, seq, s_tok, rec["cache_len"])
        bound += sum(least.decode_bound_s(m, b, seq + i)
                     for i in range(new - 1))
        wall += c["wall_s"]
    return 100.0 * bound / wall if wall else None
