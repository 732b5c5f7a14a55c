#!/usr/bin/env python3
"""What the engine's spans and counters (``repro_torch.spans``) cost on
the host, in ns: a batch's stamps as the threaded engine takes them, the
trip loop's two stamps a trip, and the collector hook a collection.

    PYTHONPATH=src python3 tools/span_cost.py [--n 200000]

Each figure is the median of 7 timed repetitions of ``--n`` rounds. The
trip and collection figures are differences: with the stamps against the
same loop without them, and ``gc.collect(0)`` with the hook installed
against without it. Prints one JSON line.
"""
import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import spans  # noqa: E402


def batch_stamps() -> None:
    """The stamps of one batch through the admit and dispatch threads."""
    st = spans.new()
    spans.begin(st, spans.ADMIT)
    prev = spans.open_batch(st)
    spans.begin(st, spans.STAGE1)
    spans.end(st, spans.STAGE1)
    st[spans.STAGE1_QUERIES] += 16
    spans.begin(st, spans.UPLOAD)
    spans.end(st, spans.UPLOAD)
    spans.open_batch(prev)
    spans.end(st, spans.ADMIT)
    spans.instant(st, spans.QUEUED, st[spans.ADMIT + 2])
    spans.end(st, spans.QUEUED)
    spans.begin(st, spans.STEP)
    prev = spans.open_batch(st)
    spans.open_batch(prev)
    spans.end(st, spans.STEP)
    spans.instant(st, spans.HELD, st[spans.STEP + 2])
    spans.end(st, spans.HELD)
    spans.begin(st, spans.HARVEST)
    spans.begin(st, spans.DOWNLOAD)
    spans.end(st, spans.DOWNLOAD)
    spans.end(st, spans.HARVEST)
    spans.begin(st, spans.DELIVER)
    spans.end(st, spans.DELIVER)


def _median_ns(fn, n: int) -> float:
    reps = []
    for _ in range(7):
        t = time.perf_counter_ns()
        fn(n)
        reps.append((time.perf_counter_ns() - t) / n)
    return statistics.median(reps)


def per_batch(n: int) -> float:
    def loop(n):
        for _ in range(n):
            batch_stamps()
    return _median_ns(loop, n)


def per_trip(n: int) -> float:
    """``run_loop``'s added work a trip: two stamps around the continue
    test, two additions."""
    now = time.time_ns

    def plain(n):
        go = True
        for _ in range(n):
            go = bool(go)

    def stamped(n):
        go = True
        wait = reads = 0
        for _ in range(n):
            t = now()
            go = bool(go)
            wait += now() - t
            reads += 1

    return _median_ns(stamped, n) - _median_ns(plain, n)


def per_collection(n: int) -> float:
    def collect(n):
        for _ in range(n):
            gc.collect(0)

    bare = _median_ns(collect, n)
    spans.hook_gc()
    try:
        hooked = _median_ns(collect, n)
    finally:
        spans.unhook_gc()
    return hooked - bare


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    args = ap.parse_args(argv)
    out = {"batch_ns": per_batch(args.n), "trip_ns": per_trip(args.n),
           "collection_ns": per_collection(max(args.n // 20, 1000)),
           "time_ns_call_ns": _median_ns(
               lambda n: [time.time_ns() for _ in range(n)], args.n)}
    print(json.dumps({k: round(v, 1) for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
