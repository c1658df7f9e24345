"""Readings of the check on the card, a job of the program beside each
control (the reference with its delta math in float32, or with both
filters at half their stated size), on several seeds, in one process:

    python3 bqsr_bench/control.py --workload <cell> --seeds 11,12,13

One JSON line a seed.  The benchmark's own runs do not run this; the
limits in ``harness/runner.py`` were set from its readings (PERF.md)."""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    from bqsr_bench.harness import runner, spec
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(runner.control_readings(cell, seed)), flush=True)
