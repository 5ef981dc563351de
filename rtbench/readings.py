#!/usr/bin/env python3
"""The readings a cell's limit is set from, in one process on the card.

    python3 rtbench/readings.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 3

For each seed, a run of the cell with a short window (as many answers as
a run compares: every finished job) prints the program's compared
numbers, and on the control's seeds the control's (the reference in
bfloat16 in the program's place): one JSON line a seed.  The lower reading of a number is the largest the program
gives; the upper, the smallest the control gives.  The benchmark's own
runs never run the control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from rtbench import harness

    if not torch.cuda.is_available():
        print("readings are taken on a CUDA card", file=sys.stderr)
        return 3
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               control=torch.bfloat16 if seed in ctl else None)
        print(json.dumps({
            "seed": seed, "correct": res["correct"],
            "program": {k: v["value"] for k, v in res["compared"].items()},
            "control": res.get("control"), "frames": res["attempted"],
            "frame_ms": res["metrics"]["frame_ms"]["value"],
            "check_s": res["check_s"], "s": time.perf_counter() - t0}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
