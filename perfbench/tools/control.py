"""The comparisons' readings on the chip, for setting and re-checking
their limits: each seed's run of a cell with the control computed
beside it.

    python3 perfbench/tools/control.py --workload <cell> \\
        --seeds 101 102 103 --seconds 5 [--control fp8]

Every seed runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, the reference) in this one process, and also computes
the control: the reference in the precision below the configuration's
put in the program's place (a served model: the gap of the tokens the
lower precision picks; the ring: its sums against the reference's).
One JSON line a seed gives every number compared and the control's.
The benchmark's own runs never compute the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from perfbench.run import environment, run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", default="fp8",
                    help="the control's precision, or 'none'")
    ap.add_argument("--fault", action="append", default=[],
                    help="a fault planted in the timed path (the drivers' "
                         "names: alter_token, alter_answer, no_exchange, "
                         "half_batch, state_unchanged)")
    args = ap.parse_args(argv)
    environment()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    t_start = T_START
    for seed in args.seeds:
        r = run_cell(args.workload, seed, args.seconds, False,
                     torch.device("cuda", 0), t_start,
                     faults=dict({} if args.control == "none"
                                 else {"control": args.control},
                                 **{f: True for f in args.fault}))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "faults": args.fault, "correct": r["correct"],
                          "checks": r["checks"], "info": r["info"],
                          "metrics": r["metrics"]}), flush=True)
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
