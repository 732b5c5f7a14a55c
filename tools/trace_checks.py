#!/usr/bin/env python3
"""One traced benchmark run, and what the program's own spans say beside
the harness's: run from a checkout's root on a card,

    python3 tools/trace_checks.py --workload text-dense-64 --seed 7 \
        --seconds 30

Serves the cell's window as ``perfbench/run.py --trace 1`` does, prints
its result line, then one JSON line ``checks``:

* ``idle_in_engine_le_idle_share``: the device-idle time under an engine
  span does not exceed the idle share of the same run;
* ``stage1``: the summed program ``stage1`` spans against the summed
  harness spans around ``_stage1`` that hold them (same thread), and the
  ratio of the two sums;
* ``client_gaps``: the idle gaps the harness's breakdown names ``client``
  (no patched engine call open at their middle), their total, and the
  share of it under each program span, under any of them (``engine``),
  under a collector pause (``gc``) and under either;
* ``gc``: the window's collector pauses by generation; ``span_ms``: each
  span's mean, median and 95th percentile over the window's batches.
"""
import json
import sys
from pathlib import Path

ROOT = Path.cwd()
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import run as bench  # noqa: E402  (the process's start time)

import argparse  # noqa: E402
import gc  # noqa: E402

import torch  # noqa: E402

from perfbench.harness import program_spans as ps  # noqa: E402
from perfbench.harness import spec  # noqa: E402


def stage1_sums(run) -> dict:
    """The run's program stage-1 spans, each paired with the harness span
    that holds it."""
    theirs = [sp for sp in run.spans if sp[0] == "stage1"]
    ours = [sp for b in ps.recorded(run)
            if (sp := b.span("stage1")) is not None]
    pairs = []
    for tid, s, e in ours:
        h = next((h for h in theirs if h[1] == tid and h[2] <= s
                  and e <= h[3]), None)
        if h is not None:
            pairs.append((e - s, h[3] - h[2]))
    prog = sum(p for p, _ in pairs)
    harness = sum(h for _, h in pairs)
    return {"calls": len(ours), "matched": len(pairs),
            "program_s": prog / 1e9, "harness_s": harness / 1e9,
            "ratio": prog / harness if harness else None}


def client_gaps(run) -> dict:
    tr = run.trace
    busy = tr.busy()
    gaps = [g for g in ps.gaps(busy, tr.t0, tr.t1)
            if tr._host_at((g[0] + g[1]) // 2) == "client"]
    total = sum(e - s for s, e in gaps)
    recs = ps.recorded(run)
    out = {"gaps": len(gaps), "total_s": total / 1e9}
    if not total:
        return out
    every = []
    for name in ("admit", "stage1", "upload", "queued", "step", "held",
                 "harvest", "download", "deliver"):
        iv = ps.merged((sp[1], sp[2]) for b in recs
                       if (sp := b.span(name)) is not None)
        every += iv
        out[name] = ps.overlap_ns(gaps, iv) / total
    engine = ps.merged(every)
    pauses = ps.merged((s, e) for _, _, s, e in (ps.gc_events() or []))
    out["engine"] = ps.overlap_ns(gaps, engine) / total
    out["gc"] = ps.overlap_ns(gaps, pauses) / total
    out["engine_or_gc"] = ps.overlap_ns(gaps,
                                        ps.merged(engine + pauses)) / total
    return out


def pauses(run) -> dict:
    """The window's collector pauses by generation: count, seconds and
    the longest in ms."""
    lo, hi = ps.window_ns(run)
    out = {}
    for gen, _, s, e in ps.gc_events() or []:
        if lo <= s and e <= hi:
            g = out.setdefault(str(gen), {"n": 0, "s": 0.0, "max_ms": 0.0})
            g["n"] += 1
            g["s"] += (e - s) / 1e9
            g["max_ms"] = max(g["max_ms"], (e - s) / 1e6)
    return out


def span_ms(run) -> dict:
    """Mean, median and 95th percentile (ms) of each span over the
    window's batches clear of the profiler."""
    bs = ps.clear(run, ps.recorded(run))
    out = {}
    for name in ("admit", "stage1", "upload", "queued", "step", "held",
                 "harvest", "download", "deliver"):
        v = sorted((sp[2] - sp[1]) / 1e6 for b in bs
                   if (sp := b.span(name)) is not None)
        if v:
            out[name] = [sum(v) / len(v), v[len(v) // 2],
                         v[min(len(v) - 1, int(0.95 * len(v)))]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = bench.serve_window(cell, args.seed, args.seconds, True, dev,
                             bench.T_START)
    gc.collect()
    torch.cuda.empty_cache()
    nums = bench.check_run(run, args.seed)
    out = bench.report(run, nums, True, torch.cuda.get_device_name(0))
    print(json.dumps(bench._finite(out), allow_nan=False))
    m = out["metrics"]
    idle_in = m.get("idle_in_engine_pct.qps", {}).get("value")
    idle = (m.get("idle_share.qps") or m.get("idle_share.p95")
            or {}).get("value")
    checks = {"idle_in_engine_pct": idle_in,
              "idle_share_pct": idle,
              "idle_in_engine_le_idle_share": (
                  None if idle_in is None or idle is None
                  else idle_in <= idle),
              "stage1": stage1_sums(run),
              "client_gaps": client_gaps(run),
              "gc": pauses(run),
              "span_ms": span_ms(run),
              "batches": len(run.batches),
              "batches_with_spans": len(ps.recorded(run))}
    print(json.dumps({"checks": checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
