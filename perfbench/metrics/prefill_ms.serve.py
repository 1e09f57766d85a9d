"""prefill_ms.serve: the median over calls (outside the profiled one) of
a call's wall time less its decode steps, in ms: the prefill, the first
sample and the tokens' copy to the host.  The engine does not wait for
the prefill before its first step, whose ``step_seconds`` so holds the
prefill's unfinished device time: that step counts as a median step and
its excess goes to the prefill."""
import statistics


def read(rec):
    rest = []
    for c in rec.get("calls", []):
        if c["traced"] or len(c["steps"]) < 2:
            continue
        typical = statistics.median(c["steps"][1:])
        rest.append(c["wall_s"] - sum(c["steps"][1:]) - typical)
    return statistics.median(rest) * 1e3 if rest else None
