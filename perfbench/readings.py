#!/usr/bin/env python3
"""The readings a cell's limits are set from: the check's numbers of the
program over many seeds, and of the control (the plain reference in the
program's place, in a lower precision) over some of them, in one process.

    python3 perfbench/readings.py --workload text-bandit-256 \
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 10 \
        --control tf32

Each seed makes its own inputs and serves a window of ``--seconds`` at the
cell's own load; the control answers the same window's requests. One JSON
line per reading. The benchmark's runs never run this.
"""
import argparse
import gc
import json
import sys
import time

import run as bench  # perfbench/run.py: sets up the import paths
import torch

from perfbench.harness import spec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", default="tf32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in sorted(set(seeds) | ctrl):
        run = bench.serve_window(cell, seed, args.seconds, False, dev,
                                 time.perf_counter())
        gc.collect()
        torch.cuda.empty_cache()
        out = {"workload": args.workload, "seed": seed,
               "attempted": len(run.records)}
        if seed in seeds:
            out["program"] = bench.check_run(run, seed)
        if seed in ctrl:
            out["control_" + args.control] = bench.check_run(
                run, seed, bench.control_answers(run, args.control))
        print(json.dumps(bench._finite(out)), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
