"""Render hillclimb records (``launch.hillclimb --out``) into a perf log
(port of ``repro.roofline.perf_log_md``): a table a pair, each
iteration's roofline terms and its step bound against the pair's first
record, then the hypotheses.

    python -m repro_torch.roofline.perf_log_md results/hillclimb.json
"""
from __future__ import annotations

import json
import sys

from .report_md import fmt_s


def perf_log(records) -> str:
    out = []
    pairs = []
    for r in records:
        if r["pair"] not in pairs:
            pairs.append(r["pair"])
    for pair in pairs:
        rows = [r for r in records if r["pair"] == pair]
        base = rows[0]
        out.append(f"\n### {pair}\n")
        out.append("| iteration | compute | memory | collective | "
                   "step ≥ | HBM/dev | Δstep vs baseline | verdict |")
        out.append("|---|---|---|---|---|---|---|---|")
        for r in rows:
            hbm = r["bytes_per_device"]["peak_hbm_est"] / 1e9
            speedup = base["roofline_step_s"] / r["roofline_step_s"]
            out.append(
                f"| {r['iteration']} | {fmt_s(r['analytic_compute_s'])} "
                f"| {fmt_s(r['analytic_memory_s'])} "
                f"| {fmt_s(r['collective_s'])} "
                f"| {fmt_s(r['roofline_step_s'])} | {hbm:.0f} GB "
                f"| {speedup:.2f}× | {r['bottleneck']}-bound |")
        out.append("\nhypothesis log:")
        for r in rows:
            out.append(f"* **{r['iteration']}** — {r['hypothesis']}")
    return "\n".join(out)


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(perf_log(json.load(f)))
