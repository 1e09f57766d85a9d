"""allreduce_gbps: one rank's raw bf16 gradient bytes (2 bytes a
parameter) times the whole-model syncs completed in the window, over the
window's seconds, in GB/s (10^9): the algorithm bandwidth as nccl-tests
defines it; host clock."""


def read(rec):
    if "syncs" not in rec:
        return None
    return 2.0 * rec["size"] * rec["syncs"] / rec["window_s"] / 1e9
