#!/usr/bin/env python3
"""Where a benchmark cell's batches spend their time, by the program's own
spans and trip counters: one untraced window of the cell, then per batch
of the window (bandit batches for the trip figures) the trips, the trip
loop's host and blocked time a trip, the share of trips that replayed a
trip graph, and the mean ``admit``, ``stage1``, ``queued``, ``step`` and
``held`` spans, with the client's p95 latency beside them.

    python3 tools/trip_times.py --workload text-bandit-256 --seed 7 \
        [--seconds 30] [--root CHECKOUT]

``--root`` runs another checkout's program and benchmark (e.g. a
``git archive`` of the parent unpacked under ``build/``); a program that
counts no ``graph_trips`` reports its share as null. Needs a CUDA card.
Prints one JSON line.
"""
import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    for p in (str(root / "perfbench"), str(root / "src"), str(root)):
        sys.path.insert(0, p)
    import torch
    from perfbench import run as bench
    from perfbench.harness import program_spans as ps
    from perfbench.harness import spec
    from repro_torch import spans

    if not torch.cuda.is_available():
        raise SystemExit("trip_times: needs a CUDA card")
    dev = torch.device("cuda")
    cell = spec.cell(args.workload, root=root, bench=root / "perfbench")
    run = bench.serve_window(cell, args.seed, args.seconds, False, dev,
                             T_START)
    batches = ps.clear(run, ps.recorded(run))
    bandit = [b for b in batches if b.flavor == "bandit"]
    trips = sum(b.counter("trips") for b in bandit)
    loop_ns = sum(b.counter("loop_ns") for b in bandit)
    wait_ns = sum(b.counter("wait_ns") for b in bandit)
    graphed = (sum(b.counter("graph_trips") for b in bandit)
               if "graph_trips" in spans.COUNTERS else None)
    lat = sorted(r.done - r.intended for r in run.completed_in_window())
    out = {
        "workload": args.workload, "seed": args.seed, "root": str(root),
        "device": torch.cuda.get_device_name(0),
        "batches": len(batches), "bandit_batches": len(bandit),
        "trips_per_batch": trips / len(bandit) if bandit else None,
        "trip_host_us": (loop_ns - wait_ns) / trips / 1e3 if trips else None,
        "trip_wait_us": wait_ns / trips / 1e3 if trips else None,
        "graph_trip_share": (graphed / trips if trips and graphed is not None
                             else None),
        "span_mean_ms": {n: ps.mean_span_ms(run, n) for n in
                         ("admit", "stage1", "queued", "step", "held")},
        "latency_p95_ms": (lat[int(0.95 * (len(lat) - 1))] * 1e3
                           if lat else None),
        "answered": len(lat), "setup_s": run.setup_s,
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
