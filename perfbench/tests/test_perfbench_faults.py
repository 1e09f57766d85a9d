"""A run with its timed path broken underneath comes out not correct:
the harness's look for a chip skipped, the rest of a run driven at a
tiny size on the CPU, once for each fault its cell can have; and the
same run unbroken comes out correct."""
import time

import pytest
import torch

from perfbench.lib import cell
from perfbench.run import run_cell
from perfbench.tests import tiny

FAULTS = {
    "serve": ["alter_token", "stale_state"],
    "grad_sync": ["alter_answer", "no_exchange"],
    "train": ["half_batch", "state_unchanged"],
}
CASES = [(w["name"], f) for w in cell.benchmark()["workloads"]
         for f in [None] + FAULTS[cell.workload(w["name"])["driver"]]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_fault_makes_the_run_incorrect(workload, fault):
    w = cell.workload(workload)
    r = run_cell(workload, 2**31 + 9, 0.05, False, torch.device("cpu"),
                 time.perf_counter(), overrides=tiny.overrides(w),
                 faults={fault: True} if fault else {})
    assert r["correct"] is (fault is None), r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cell.benchmark()["workloads"]])
def test_the_control_in_the_programs_place_is_judged(workload):
    """With the control on, its readings stand under the program's
    names and limits, and the program's follow unjudged."""
    w = cell.workload(workload)
    r = run_cell(workload, 2**31 + 9, 0.05, False, torch.device("cpu"),
                 time.perf_counter(), overrides=tiny.overrides(w),
                 faults={"control": "fp8"})
    shown = [k[len("program_"):] for k in r["checks"]
             if k.startswith("program_")]
    assert any(r["checks"][k]["limit"] is not None for k in shown), \
        r["checks"]
    assert all(r["checks"]["program_" + k]["limit"] is None
               for k in shown)
