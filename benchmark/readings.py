#!/usr/bin/env python3
"""Read the numbers that decide ``correct`` for many seeds in one process,
for the program as a cell runs it and for its control.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 \
        [--control float16 | --fault <name>] [--seconds 0]

Each seed is one run of the cell (``--seconds 0``: set-up and one fit); one
JSON line a seed gives its numbers.  ``--control float16`` runs the control
of the check: the same fits with the draws stored in float16
(``sample(posterior_dtype="float16")``), the step below the float32 the
configuration states.  ``--fault`` plants one of ``harness/faults.py``'s
faults underneath the run.  The benchmark's own runs never run either; the
limits of ``workloads/<cell>.json`` lie between the program's readings and
the control's or the faults'."""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONTROLS = {"float16": {"posterior_dtype": "float16"}}


def readings(cell_name, seeds, control=None, seconds=0.0, device=None,
             root=ROOT, fault=None):
    """One dict a seed: its numbers and whether the run was correct."""
    from benchmark.harness import cell as cellmod
    from benchmark.harness.faults import FAULTS

    out = []
    for seed in seeds:
        r = cellmod.run(cell_name, seed, seconds, 0, root=root,
                        t_start=time.time(), device=device,
                        control=CONTROLS[control] if control else None,
                        hook=FAULTS[fault] if fault else None)
        out.append({"workload": cell_name, "seed": seed, "control": control,
                    "fault": fault,
                    "correct": r["correct"], "attempted": r["attempted"],
                    "checks": {k: v["value"] for k, v in r["checks"].items()}})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", choices=sorted(CONTROLS))
    ap.add_argument("--fault")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for row in readings(args.workload, seeds, args.control, args.seconds,
                        fault=args.fault):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
