"""The benchmark's files: every cell, configuration, driver and metric of
``BENCHMARK.json`` is a file of its own, found by name, and a new
workload file runs with no other file of the harness edited."""
import json
import re
import shutil
import time

import pytest

from perfbench.lib import cell
from perfbench.tests import tiny

BENCH = cell.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51


def test_every_cell_has_its_files():
    known_drivers = {p.stem for p in (cell.BENCH_DIR / "drivers").glob(
        "*.py")}
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        conf = cell.config(c["name"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        wl = cell.workload(w["name"])
        assert wl["config"] == w["config"] and w["config"] in configs
        assert wl["driver"] in known_drivers
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        e2e = cell.cell_metrics(BENCH, w["name"], False)
        layer = cell.cell_metrics(BENCH, w["name"], True)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer, w["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert hasattr(cell.load_module("metrics", m["name"]), "read")
        for name in m.get("workloads", []):
            assert name in {w["name"] for w in BENCH["workloads"]}


def test_per_layer_metrics_move_a_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for name in m["workloads"]:
            assert name in moved.get("workloads", [name])
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all("\n" not in name for name in layers)


@pytest.mark.parametrize("driver", ["serve", "grad_sync"])
def test_a_new_workload_file_is_found(tmp_path, monkeypatch, driver):
    """A cell added as one workload file (and its entry in
    ``BENCHMARK.json``) runs through the harness as it stands."""
    shutil.copytree(cell.BENCH_DIR, tmp_path / "perfbench")
    src = next(w for w in BENCH["workloads"]
               if cell.workload(w["name"])["driver"] == driver)
    new = dict(cell.workload(src["name"]))
    new["name"] = src["name"] + "_copy"
    (tmp_path / "perfbench" / "workloads" / f"{new['name']}.json"
     ).write_text(json.dumps(new))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(src, name=new["name"],
                                   traffic=src["traffic"] + "_copy"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if src["name"] in m.get("workloads", []):
            m["workloads"].append(new["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(cell, "BENCH_DIR", tmp_path / "perfbench")
    import torch
    from perfbench.run import run_cell
    r = run_cell(new["name"], 5, 0.05, False, torch.device("cpu"),
                 time.perf_counter(), overrides=tiny.overrides(new),
                 root=tmp_path)
    assert r["correct"], r["checks"]
    assert "setup_s" in r["metrics"]
