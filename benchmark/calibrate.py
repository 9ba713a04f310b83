#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from: one workload over
many seeds in one process, each run's compared numbers beside the
control's on the same inputs (harness/control.py), one JSON line a seed.

    python3 benchmark/calibrate.py --workload <name> --seconds <s> [--fault F] SEED...

Run from the root of a checkout on the card. With --fault, the program runs
with that fault of harness/faults.py planted, and its numbers are the
fault's readings. The benchmark's own runs never run the control or a
fault. Lines also go to chiprun_out/calibrate.jsonl.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default=None)
    ap.add_argument("seeds", type=int, nargs="+")
    a = ap.parse_args(argv)
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    torch.set_num_threads(1)
    from harness import cell, control, faults
    if a.fault:
        faults.plant(a.fault)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    t = T_START
    for seed in a.seeds:
        ctrl = {}
        res = cell.run(ROOT, a.workload, seed, a.seconds, False, device=a.device,
                       t_start=t, on_check=lambda **kw: ctrl.update(
                           program=dict(kw["numbers"]), control=control.numbers(**kw)))
        line = json.dumps({"workload": a.workload, "seed": seed, "fault": a.fault,
                           "correct": res["correct"], "program": ctrl["program"],
                           "control": ctrl["control"], "metrics": res["metrics"],
                           "attempted": res["attempted"], "failed": res["failed"]})
        print(line, flush=True)
        with open(os.path.join(out_dir, "calibrate.jsonl"), "a") as f:
            f.write(line + "\n")
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
