"""What a run loads: after each driver's set-up and window (a tiny run
on the CPU, in a fresh process), no module has the whole top-level name
``jax``, ``jaxlib``, ``flax`` or ``repro``; and the reference loads
nothing of the program."""
import ast
import subprocess
import sys
import textwrap

import pytest

from perfbench.lib import cell

ROOT = cell.ROOT


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cell.benchmark()["workloads"]])
def test_a_run_loads_no_jax_and_no_jax_package(workload):
    last = _fresh(f"""
        import sys, time, json
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        import torch
        from perfbench.run import environment, forbidden_modules, run_cell
        from perfbench.lib import cell
        from perfbench.tests import tiny
        environment()
        w = cell.workload({workload!r})
        r = run_cell({workload!r}, 3, 0.05, False, torch.device("cpu"),
                     time.perf_counter(), overrides=tiny.overrides(w))
        assert "repro_torch" in sys.modules
        print(json.dumps(forbidden_modules()))
        """)
    assert last == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from perfbench.run import forbidden_modules
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in forbidden_modules()
    assert all(n in ("jax", "jaxlib", "flax", "repro")
               for n in forbidden_modules())


def test_the_reference_imports_nothing_of_the_program():
    ref = cell.BENCH_DIR / "reference"
    for path in ref.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro",
                                               "jax", "jaxlib"), (path, n)
    last = _fresh(f"""
        import sys, json, pkgutil, importlib
        sys.path[:0] = [{str(ROOT)!r}]
        import perfbench.reference as r
        for m in pkgutil.iter_modules(r.__path__):
            importlib.import_module("perfbench.reference." + m.name)
        print(json.dumps(sorted(k for k in sys.modules
                                if k.split(".")[0] in
                                ("repro_torch", "repro", "jax"))))
        """)
    assert last == "[]"
