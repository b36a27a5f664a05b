#!/usr/bin/env python3
"""Runs of a cell as the check makes them, each a new process of
``perfbench/run.py``, and the spread of each metric over them:

    python3 perfbench/sets.py --workload <cell> --seeds 1,2,3 \
        --seconds 30 [--trace 1] --out <file.jsonl>

The spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) over the median. Each run's result
line goes to ``--out``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    values = {}
    for seed in args.seeds.split(","):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload",
             args.workload, "--seed", seed, "--seconds", str(args.seconds),
             "--trace", str(args.trace)], capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        rec = {"workload": args.workload, "seed": int(seed),
               "rc": proc.returncode, "wall_s": wall, "result": res,
               "stderr_tail": proc.stderr[-3000:]}
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        short = {k: v["value"] for k, v in (res or {}).get(
            "metrics", {}).items()}
        print(json.dumps({"seed": int(seed), "rc": proc.returncode,
                          "wall_s": round(wall, 1),
                          "correct": (res or {}).get("correct"),
                          "metrics": short}), flush=True)
        if res is None:
            print(proc.stderr[-3000:], flush=True)
        for k, v in short.items():
            values.setdefault(k, []).append(v)
    print(json.dumps({k: {"median": statistics.median(v),
                          "spread": spread(v), "n": len(v)}
                      for k, v in values.items()}), flush=True)


if __name__ == "__main__":
    main()
