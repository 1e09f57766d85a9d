"""decode_step_ms.serve: the median decode step of the window, in ms:
the engine's ``step_seconds`` over the calls outside the profiled one."""
import statistics


def read(rec):
    steps = [s for c in rec.get("calls", []) if not c["traced"]
             for s in c["steps"]]
    return statistics.median(steps) * 1e3 if steps else None
