#!/usr/bin/env python3
"""Time the pooled bandit rerank step of two or more checkouts, in turns.

    python3 tools/bandit_ab.py NAME=PATH [NAME=PATH ...] [--rounds 10]
    python3 tools/bandit_ab.py --log OUTPUT    # summarize an earlier run

Each NAME=PATH is a checkout (``PATH/src/repro_torch``); ``.`` is this
tree. Every run is a fresh process on one CUDA card that imports that
checkout's package, builds a 4,096-doc corpus at the serving widths (L =
M = 128, T = 32; phase 4's generator and seed), takes stage-1 candidates
(16 queries, 256 candidates each) and times ``make_serving_step("bandit")``
with the fused and the chain round body: the median of 5 warm calls (host
clock, synchronised), the trips of one call (from its stats: (rounds +
lockstep waste) / 16) and the time per trip, and the reveal launches of one
call. Runs go A, B, ..., then in reverse order, ``--rounds`` times, so drift
hits every checkout alike; with two checkouts the summary also gives the
second's time per trip over the first's, per round (one pair). The
bandit's trip cost does not depend on the corpus size, only on the batch's
shape, so 4,096 docs stand in for phase 4's 65,536. Prints the card's name
and power limit, and one JSON line per run.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CHILD = r'''
import json, statistics, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.data.synthetic import make_retrieval_dataset
from repro_torch.kernels import _build
from repro_torch.retrieval.index import from_numpy
from repro_torch.retrieval.pipeline import candidates_for
from repro_torch.retrieval.service import make_serving_step
try:
    from repro_torch.core.draws import TorchDraws
    seeds = lambda n: TorchDraws().keys(0, n, "cuda")
except ImportError:                          # one generator per run
    from repro_torch.core.frontier import TorchDraws
    seeds = lambda n: TorchDraws(0, "cuda")
torch.backends.cuda.matmul.allow_tf32 = False
ds = make_retrieval_dataset(n_docs=4096, doc_len=128, min_doc_len=32,
                            query_len=32, dim=128, n_queries=16, seed=0)
idx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device="cuda")
q = torch.as_tensor(ds.queries, device="cuda")
cand = candidates_for(idx.doc_embs, idx.doc_mask, q, kprime=10,
                      max_candidates=256, support=(0.0, 1.0))
args = (idx.doc_embs, idx.doc_mask, q, cand.doc_ids, cand.a, cand.b)
out = {}
for engine in ("pooled", "pooled_chain"):
    step = make_serving_step("bandit", topk=5, engine=engine)
    step(*args, seeds(16))
    torch.cuda.synchronize()
    _build.reset_launches()
    res = step(*args, seeds(16))
    torch.cuda.synchronize()
    launches = sum(_build.LAUNCHES.values())
    times = []
    for _ in range(5):
        t = time.perf_counter()
        step(*args, seeds(16))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    stats = res[3].tolist()
    trips = (stats[1] + stats[2]) / 16
    out[engine] = dict(ms=statistics.median(times), trips=trips,
                       ms_per_trip=statistics.median(times) / trips,
                       launches=launches,
                       reveal_fraction=float(res[2].mean()))
print("RESULT " + json.dumps(out))
'''


def summarize(runs):
    """Medians, quartiles and extremes of each checkout's runs; with two
    checkouts, the second's time per trip over the first's per pair."""
    for name, rs in runs.items():
        for e in rs[0]:
            per_trip = sorted(x[e]["ms_per_trip"] for x in rs)
            q1, _, q3 = statistics.quantiles(per_trip, n=4)
            ms = statistics.median(x[e]["ms"] for x in rs)
            print(f"{name} {e}: median {ms:.3f} ms per batch of 16, "
                  f"{statistics.median(per_trip):.4f} ms per trip "
                  f"(quartiles {q1:.4f} / {q3:.4f}, min {per_trip[0]:.4f}, "
                  f"max {per_trip[-1]:.4f}); trips {rs[0][e]['trips']}, "
                  f"launches {rs[0][e]['launches']}", flush=True)
    if len(runs) == 2:
        (a, ra), (b, rb) = runs.items()
        for e in ra[0]:
            pairs = [(x[e]["ms_per_trip"], y[e]["ms_per_trip"])
                     for x, y in zip(ra, rb)]
            ratio = sorted(y / x for x, y in pairs)
            print(f"{b} / {a} {e} ms per trip, {len(ratio)} pairs: median "
                  f"{statistics.median(ratio):.4f}, min {ratio[0]:.4f}, max "
                  f"{ratio[-1]:.4f}; {b} slower in "
                  f"{sum(y > x for x, y in pairs)} pairs, median difference "
                  f"{statistics.median(y - x for x, y in pairs):+.4f} ms",
                  flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--log", help="summarize the run lines of an earlier "
                    "run's output instead of running")
    opts = ap.parse_args()
    if opts.log:
        runs = {}
        for line in open(opts.log):
            if line.startswith("run "):
                name, res = line[4:].split(": ", 1)
                runs.setdefault(name, []).append(
                    json.loads(res[:res.rindex("}") + 1]))
        summarize(runs)
        return
    trees = [t.split("=", 1) for t in opts.trees]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    runs = {name: [] for name, _ in trees}
    for r in range(opts.rounds):
        order = trees if r % 2 == 0 else trees[::-1]
        for name, path in order:
            t = time.perf_counter()
            p = subprocess.run([sys.executable, "-c", CHILD,
                                os.path.abspath(path)], capture_output=True,
                               text=True)
            line = [x for x in p.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if p.returncode or not line:
                print(p.stdout[-2000:], p.stderr[-4000:], file=sys.stderr)
                sys.exit(f"bandit_ab: run of {name} failed")
            res = json.loads(line[0][7:])
            runs[name].append(res)
            print(f"run {name}: {json.dumps(res)} "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)
    summarize(runs)


if __name__ == "__main__":
    main()
