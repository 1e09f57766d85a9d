"""Render the plan records (``launch.dryrun --sweep --out``) into
markdown tables (port of ``repro.roofline.report_md``: ``fmt_bytes``,
``fmt_s``, ``roofline_table`` and ``pick_hillclimb`` are the
reference's; ``dryrun_table`` has the port's columns)."""
from __future__ import annotations

import json
import sys
from typing import Dict, List

from ..launch.mesh import H100_SXM


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}µs"


def dryrun_table(records: List[Dict], mesh: str) -> str:
    """The plan table: the reference's, with the port's columns (the
    analytic FLOPs a device where the reference has XLA's, no compile
    time, the fit in an H100's memory)."""
    rows = ["| arch | shape | status | FLOPs/dev | bytes/dev "
            f"(params+opt+cache+in) | fits {H100_SXM.hbm_bytes / 1e9:.0f}G "
            "| collectives (count) | note |",
            "|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r["mesh"] != mesh and r.get("status") != "skipped":
            continue
        if r.get("status") == "skipped":
            if mesh == "16x16" and r["mesh"] != mesh:
                continue
            rows.append(f"| {r['arch']} | {r['shape']} | SKIP | — | — | — "
                        f"| — | {r['note']} |")
            continue
        mem = r["bytes_per_device"]
        colls = ", ".join(f"{k}×{v}" for k, v in
                          sorted(r["collectives"]["counts"].items()))
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok "
            f"| {r['analytic_flops']:.2e} | {fmt_bytes(mem['peak_hbm_est'])} "
            f"| {'✓' if r.get('hbm_ok') else '✗'} | {colls or '—'} "
            f"| {r.get('note', '')} |")
    return "\n".join(rows)


def roofline_table(records: List[Dict], mesh: str = "16x16") -> str:
    rows = ["| arch | shape | compute | memory | collective | bottleneck "
            "| MODEL_FLOPS/HLO | note |",
            "|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r.get("status") != "ok" or r["mesh"] != mesh:
            continue
        comp = r.get("analytic_compute_s", r["compute_s"])
        mem = r.get("analytic_memory_s", r["memory_s"])
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(comp)} "
            f"| {fmt_s(mem)} | {fmt_s(r['collective_s'])} "
            f"| **{r['bottleneck']}** | {r['useful_flops_ratio']:.2f} "
            f"| {r.get('note', '')} |")
    return "\n".join(rows)


def pick_hillclimb(records: List[Dict]) -> Dict[str, Dict]:
    """The single-pod combinations a hillclimb starts from: the
    ``train_4k`` one with the least useful-FLOPs ratio, and the one with
    the largest collective term."""
    ok = [r for r in records if r.get("status") == "ok"
          and r["mesh"] == "16x16"]
    worst_useful = min((r for r in ok if r["shape"] == "train_4k"),
                       key=lambda r: r["useful_flops_ratio"])
    most_coll = max(ok, key=lambda r: r["collective_s"])
    return {"worst_useful_flops": worst_useful,
            "most_collective_bound": most_coll}


if __name__ == "__main__":
    records = json.load(open(sys.argv[1]))
    mesh = sys.argv[2] if len(sys.argv) > 2 else "16x16"
    print(dryrun_table(records, mesh))
    print()
    print(roofline_table(records, mesh))
    for k, r in pick_hillclimb(records).items():
        print(f"\n{k}: {r['arch']} × {r['shape']} "
              f"(compute={fmt_s(r['compute_s'])}, "
              f"coll={fmt_s(r['collective_s'])}, "
              f"useful={r['useful_flops_ratio']:.2f})")
