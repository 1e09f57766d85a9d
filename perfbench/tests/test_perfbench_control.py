"""The controls on the card, at each cell's own size: with the control
(the reference in fp8) in the program's place, or with a fault planted
in the timed path, a run comes out not correct; beside the control, the
program's own readings stay within their limits.  Skipped without
CUDA; on the card:
``python -m pytest perfbench/tests/test_perfbench_control.py``."""
import time

import pytest

SEED = 3900000001
# (cell, the fault planted; None: the control in the program's place)
CASES = [
    ("mamba2-780m.serve_chat", None),
    ("mamba2-780m.serve_chat", "alter_token"),
    ("mamba2-780m.serve_chat", "stale_state"),
    ("internvl2-26b.serve_image", None),
    ("mamba2-780m.grad_sync", None),
    ("mamba2-780m.train_4k", None),
    ("mamba2-780m.train_4k", "half_batch"),
]


@pytest.mark.card
@pytest.mark.parametrize("workload,fault", CASES)
def test_the_control_and_each_fault_fail(card, workload, fault):
    from perfbench.run import environment, run_cell
    environment()
    faults = {fault: True} if fault else {"control": "fp8"}
    r = run_cell(workload, SEED, 2.0, False, card, time.perf_counter(),
                 faults=faults)
    assert not r["correct"], r["checks"]
    checks = r["checks"]
    for k, c in checks.items():
        if k.startswith("program_"):
            limit = checks[k[len("program_"):]]["limit"]
            if limit is not None:
                assert c["value"] <= limit, checks
