#!/usr/bin/env python3
"""Readings that a cell's limits are set from: the program's numbers on
many seeds and the lower-precision control's (the program's own bfloat16
path) on a few, each a short run at the cell's own size, in one process:

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 5 --out <file.jsonl>

Each run's judged numbers go to ``--out`` as one JSON line. The
benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import harness  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control-dtype", default="bfloat16")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), args.control_dtype)
             for s in args.control_seeds.split(",") if s]
    with open(args.out, "a") as fh:
        for seed, dtype in runs:
            t0 = time.perf_counter()
            res = harness.run(args.workload, seed, args.seconds, dtype=dtype)
            line = {"workload": args.workload, "seed": seed,
                    "side": "control" if dtype else "program",
                    "dtype": dtype, "correct": res["correct"],
                    "numbers": res["judged"], "card": res["card"],
                    "seconds": time.perf_counter() - t0}
            fh.write(json.dumps(line) + "\n")
            fh.flush()
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
