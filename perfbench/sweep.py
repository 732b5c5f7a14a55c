#!/usr/bin/env python3
"""Sweep an open-loop cell's offered rate once, to find the knee: the
highest rate the program sustains without a growing backlog. The cell's
mix then fixes a rate below it; the benchmark's runs never sweep.

    python3 perfbench/sweep.py --workload text-stage1-open \
        --rates 6,9,12,15,18 --seconds 20 --seed 5

One JSON line per rate: answered per second, latency p50 / p95 from the
intended send time, and the mean latency of the window's last quarter of
requests over its first quarter (near 1 when sustained, growing past it).
"""
import argparse
import json
import statistics
import sys
import time

import run as bench  # perfbench/run.py: sets up the import paths
import torch

from perfbench.harness import spec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = spec.cell(args.workload)
        cell.traffic["rate_per_s"] = rate
        run = bench.serve_window(cell, args.seed, args.seconds, False, dev,
                                 time.perf_counter())
        lat = [r.latency_s for r in run.records]
        q = max(1, len(lat) // 4)
        ok = [x for x in lat if x != float("inf")]
        print(json.dumps({
            "rate": rate, "sent": len(lat),
            "qps": len(run.completed_in_window()) / args.seconds,
            "failed": len(lat) - len(ok),
            "p50_ms": statistics.median(ok) * 1e3 if ok else None,
            "p95_ms": run.latency_quantile_ms(0.95),
            "last_over_first": (statistics.mean(lat[-q:])
                                / statistics.mean(lat[:q])) if ok else None,
        }), flush=True)
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
