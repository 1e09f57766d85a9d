"""Finding a cell's files by name: the benchmark's entry in
``BENCHMARK.json``, the workload, its configuration, its driver and the
readers of its metrics.  Nothing here names a cell, a configuration or
a metric: adding one is adding its files.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def workload(name: str) -> Dict[str, Any]:
    path = BENCH_DIR / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no workload file {path}")
    w = load_json(path)
    if w.get("name") != name:
        raise ValueError(f"{path} names itself {w.get('name')!r}")
    return w


def config(name: str) -> Dict[str, Any]:
    c = load_json(BENCH_DIR / "configs" / f"{name}.json")
    if c.get("name") != name:
        raise ValueError(f"config file {name}.json names itself "
                         f"{c.get('name')!r}")
    return c


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict[str, Any], cell: str, trace: bool
                 ) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    (trace 0) or its per-layer metrics (trace 1).  A metric without a
    ``workloads`` key belongs to every cell that reports the end-to-end
    metric it moves (per-layer) or to every cell (end-to-end)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def model_config(conf: Dict[str, Any], overrides: Optional[Dict] = None):
    """The port's ``ModelConfig`` holding the configuration file's sizes
    (``model``, with ``overrides`` on top for the CPU tests' tiny
    sizes): every size is set from the file, so the file is what runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.common import BlockGroup
    m = dict(conf["model"], **(overrides or {}))
    base = get_config(conf["arch"])
    fields = {k: v for k, v in m.items()
              if k not in ("block", "n_layers", "dtype")}
    unknown = [k for k in fields if not hasattr(base, k)]
    if unknown:
        raise ValueError(f"{conf['name']}: sizes the model has no field "
                         f"for: {unknown}")
    return replace(base, blocks=(BlockGroup((m["block"],), m["n_layers"]),),
                   dtype=getattr(torch, m["dtype"]), **fields)


@dataclass
class Ctx:
    """What a driver gets: the cell's files, the run's arguments, and
    the set-up clock's start."""
    name: str
    workload: Dict[str, Any]
    conf: Dict[str, Any]
    model: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    overrides: Dict[str, Any] = field(default_factory=dict)
    faults: Dict[str, Any] = field(default_factory=dict)
    info: Dict[str, Any] = field(default_factory=dict)

    @property
    def traffic(self) -> Dict[str, Any]:
        return dict(self.workload["traffic"],
                    **self.overrides.get("traffic", {}))

    @property
    def check(self) -> Dict[str, Any]:
        return self.workload["check"]
