"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's workload file (``perfbench/workloads/<cell>.json``) names its
configuration (``perfbench/configs/``), its driver (``perfbench/drivers/``)
and its traffic; ``BENCHMARK.json`` names the metrics it reports, each
read by ``perfbench/metrics/<metric>.py`` from the driver's record.  The
driver sets up (weights and traffic from the seed, books, every shape
warmed up and captured), measures for ``--seconds``, and holds what the
window produced to the plain reference.  ``setup_s`` runs from the start
of this process to the window's start.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit,
which also close standard error.  Without CUDA, or with fewer cards than
the cell asks for, or with the JAX package or JAX loaded once the window
has closed, it prints no result and exits non-zero.  Kernel builds and
compiler caches stay under ``.perfbench_cache/`` in the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def environment(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout; the program and the
    benchmark on the import path; no JAX through other libraries."""
    cache = root / ".perfbench_cache"
    os.environ["REPRO_TORCH_KERNEL_DIR"] = str(cache / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(root), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({k.split(".")[0] for k in list(sys.modules)
                   if k.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides=None, faults=None,
             root: Path = ROOT):
    """Set up, measure and check one run of ``name``; returns the result
    dict (without the device's name and power, which ``main`` adds)."""
    from perfbench.lib import cell
    from perfbench.lib.compare import passed
    from perfbench.lib.trace import Tracer, breakdown
    bench = cell.benchmark(root)
    w = cell.workload(name)
    conf = cell.config(w["config"])
    overrides = overrides or {}
    ctx = cell.Ctx(name=name, workload=w, conf=conf,
                   model=dict(conf["model"], **overrides.get("model", {})),
                   seed=seed, seconds=seconds, trace=trace, device=device,
                   t_start=t_start, overrides=overrides,
                   faults=faults or {})
    tracer = Tracer(trace)
    out = cell.load_module("drivers", w["driver"]).run(ctx, tracer)
    rec = out["record"]
    values = {}
    for mt in cell.cell_metrics(bench, name, trace):
        v = cell.load_module("metrics", mt["name"]).read(rec)
        if v is not None:
            values[mt["name"]] = {"value": float(v), "unit": mt["unit"]}
    result = {"correct": passed(out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": values,
              "device": {"memory_peak_bytes": out["memory_peak_bytes"]}}
    if trace and tracer.summary is not None:
        result["device"]["busy_s"] = tracer.summary["busy_s"]
        result["device"]["window_s"] = tracer.summary["slice_s"]
        result["breakdown"] = breakdown(tracer.summary)
    result["info"] = getattr(ctx, "info", {})
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in out["checks"]}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    import torch
    from perfbench.lib import cell
    chips = {w["name"]: w["chips"]
             for w in cell.benchmark()["workloads"]}.get(args.workload)
    if chips is None:
        print(f"perfbench: {args.workload!r} is not a cell of "
              f"BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules that must not load were loaded: "
              f"{found}", file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["device"] = dict(
        platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
        power_limit=power_limit(), **result["device"])
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
