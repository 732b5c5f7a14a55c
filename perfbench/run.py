#!/usr/bin/env python3
"""One run of one benchmark cell of ``repro_torch``'s Col-Bandit serving.

    python3 perfbench/run.py --workload text-bandit-256 --seed 7 \
        --seconds 30 --trace 0

Makes the cell's corpus, queries and candidate lists on the card from the
seed, sets up the serving engine and warms the cell's buckets (all of
which is ``setup_s``), drives the cell's traffic for ``--seconds``, waits
for the answers due, checks them against the plain reference, and prints
as its last line one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``:
its per-layer metrics, read from a device trace of a short sub-window),
``device`` and, last, ``checks`` (each compared number beside its limit,
also the last lines on standard error). Exits non-zero without a CUDA
card, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench.harness import spec  # noqa: E402
from perfbench.harness.context import Run  # noqa: E402
from perfbench.harness.guard import forbidden_modules  # noqa: E402
from perfbench.harness.serve import Served, make_inputs  # noqa: E402
from perfbench.harness import trace as tracing  # noqa: E402
from perfbench.reference import check  # noqa: E402
from perfbench.reference.maxsim import exhaustive_topk  # noqa: E402

ANSWER_GRACE_S = 60.0


def serve_window(cell: spec.Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float, fault=None) -> Run:
    """Set up, warm, drive the window and collect what the program said."""
    from repro_torch.kernels import _build

    wl, mix = cell.workload, cell.traffic
    clock = time.perf_counter
    inputs = make_inputs(cell.config, mix, seed, device)
    served = Served(inputs, wl, mix, seed, device, clock)
    served.warm(int(wl["warm_requests"]))
    if fault is not None:
        fault(served)
    if trace and device.type == "cuda":
        tracing.prime()
    lead = float(mix.get("lead_s", 0.0))
    if lead > 0:
        # The stream runs ahead of the window, so that the window opens on
        # a pipeline in its steady state; these requests are not counted.
        spec.loop(mix["loop"]).run(served.send, mix, lead,
                                   np.random.default_rng([seed, 3]), clock)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    eng = served.engine
    n_comp0, n_batch0 = len(eng.metrics.completions), len(eng.metrics.batches)
    _build.reset_launches()
    setup_s = clock() - t_start

    rng = np.random.default_rng([seed, 1])
    loop = spec.loop(mix["loop"])
    t0 = clock()
    raw, profiled = None, None
    if trace:
        # The profiler runs on this thread; the traffic on another.
        got = {}
        th = threading.Thread(target=lambda: got.update(records=loop.run(
            served.send, mix, seconds, rng, clock)), name="perfbench-traffic")
        th.start()
        raw, profiled = tracing.profile_window(
            t0 + tracing.TRACE_LEAD * seconds, tracing.TRACE_S)
        th.join()
        records = got["records"]
    else:
        records = loop.run(served.send, mix, seconds, rng, clock)
    t_end = t0 + seconds
    grace = clock() + ANSWER_GRACE_S
    while clock() < grace and any(r.completion is None and r.error is None
                                  for r in records):
        time.sleep(0.005)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    tr = tracing.reduce(raw, served.spans) if raw is not None else None
    launches = dict(_build.LAUNCHES)
    batches = list(eng.metrics.batches[n_batch0:])
    n_served = len(eng.metrics.completions) - n_comp0
    served.stop()
    return Run(cell=cell, seed=seed, seconds=seconds, setup_s=setup_s,
               t0=t0, t_end=t_end, records=records, batches=batches,
               n_served=n_served, launches=launches, trace=tr,
               memory_peak_bytes=int(peak), inputs=inputs,
               spans=list(served.spans.spans), profiled=profiled)


def check_run(run: Run, seed: int, answers=None, prec: str = "f32") -> dict:
    """The check's numbers over the answers due in the window, or over
    ``answers`` {request index: (ids, scores)} standing in for them."""
    wl, mix = run.cell.workload, run.cell.traffic
    inp = run.inputs
    recs = run.records
    if answers is None:
        answers = {r.i: (r.completion.topk_ids, r.completion.topk_scores)
                   for r in recs if r.ok}
    missing = sum(1 for r in recs if r.i not in answers)
    keys = sorted(answers)
    rng = np.random.default_rng([seed, 2])
    n = min(int(wl["check_max"]), len(keys))
    pick = sorted(rng.choice(len(keys), size=n, replace=False)) if n else []
    keys = [keys[j] for j in pick]
    pools = torch.as_tensor([inp.pool_index(i) for i in keys],
                            dtype=torch.long, device=inp.corpus.embs.device)
    k = int(mix["k"])
    ids = torch.as_tensor(np.stack([answers[i][0] for i in keys])
                          if keys else np.zeros((0, k)), dtype=torch.long,
                          device=pools.device)
    scores = torch.as_tensor(np.stack([answers[i][1] for i in keys])
                             if keys else np.zeros((0, k)),
                             dtype=torch.float32, device=pools.device)
    eng = wl["engine"]
    return check.numbers(
        inp.corpus.embs, inp.corpus.mask, inp.pool.queries[pools],
        None if inp.cands is None else inp.cands[pools], ids, scores, k=k,
        missing=missing, kprime=int(eng.get("stage1_kprime", 0)),
        n_stage1=int(eng.get("stage1_candidates", 0)), prec=prec)


def control_answers(run: Run, prec: str) -> dict:
    """The control: the plain reference in the program's place, in the
    lower precision ``prec``, answering every request sent in the window
    {request index: (ids, scores)}."""
    inp, k = run.inputs, int(run.cell.traffic["k"])
    eng = run.cell.workload["engine"]
    idx = [r.i for r in run.records]
    out = {}
    for j in range(0, len(idx), 64):
        part = idx[j:j + 64]
        pools = torch.as_tensor([inp.pool_index(i) for i in part],
                                device=inp.corpus.embs.device)
        q = inp.pool.queries[pools]
        if inp.cands is None:
            cands = check.reference_candidates(
                inp.corpus.embs, inp.corpus.mask, q,
                int(eng["stage1_kprime"]), int(eng["stage1_candidates"]),
                prec)
        else:
            cands = inp.cands[pools]
        ids, top, _ = exhaustive_topk(inp.corpus.embs, inp.corpus.mask, q,
                                      cands, k, prec)
        for i, a, b in zip(part, ids.cpu().numpy(), top.cpu().numpy()):
            out[i] = (a, b)
    return out


def report(run: Run, nums: dict, trace: bool, kind: str) -> dict:
    cell = run.cell
    run.check = nums
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    verdict = check.judge(nums, cell.workload["limits"])
    device = {"platform": "gpu", "kind": kind,
              "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": all(v["ok"] for v in verdict.values()),
           "attempted": len(run.records),
           "failed": sum(1 for r in run.records if not r.ok),
           "metrics": metrics, "device": device}
    if trace:
        steps = sorted(sp[2:4] for sp in run.spans if sp[0] == "step")
        on = run.trace.on
        gap = max([b[0] - a[1] for a, b in zip(steps, steps[1:])
                   if b[0] >= on and a[1] <= run.trace.t1] or [0]) / 1e9
        lost = run.trace.lost
        print(f"trace: {len(run.trace.ops)} device records in "
              f"{run.trace.window_s:.3f} s; {run.trace.launches} kernel "
              f"launches, "
              f"{'unknown' if lost is None else len(lost)} without a record; "
              f"{len(run.trace.whole_steps())} steps traced whole; the "
              f"profiler took {run.trace.start_s:.3f} s to start and "
              f"{run.trace.stop_s:.3f} s to stop; the longest wait between "
              f"two steps while it was on {gap:.3f} s", file=sys.stderr)
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {name: {"value": v["value"], "limit": v["limit"]}
                     for name, v in verdict.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    import repro_torch
    if ROOT / "src" not in Path(repro_torch.__file__).resolve().parents:
        print(f"perfbench: repro_torch was loaded from {repro_torch.__file__},"
              f" not from this checkout's src/", file=sys.stderr)
        return 5
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = serve_window(cell, args.seed, args.seconds, bool(args.trace), dev,
                       T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark measures "
              "repro_torch alone", file=sys.stderr)
        return 4
    gc.collect()
    torch.cuda.empty_cache()
    t_check = time.perf_counter()
    nums = check_run(run, args.seed)
    print(f"info check_s: {time.perf_counter() - t_check:.3f}",
          file=sys.stderr)
    out = report(run, nums, bool(args.trace), torch.cuda.get_device_name(0))
    svc = [b.service_s for b in run.batches]
    if svc:
        print(f"info batches: {len(svc)}, service_s mean "
              f"{np.mean(svc):.4f} cv {np.std(svc) / np.mean(svc):.3f}, "
              f"occupancy {np.mean([b.occupancy for b in run.batches]):.3f}, "
              f"rounds mean {np.mean([b.total_rounds for b in run.batches]):.1f}",
              file=sys.stderr)
    for name in sorted(set(nums) - set(out["checks"])):
        print(f"info {name}: {nums[name]!r}", file=sys.stderr)
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(_finite(out), allow_nan=False))
    return 0


def _finite(x):
    """``x`` with every non-finite float as null (strict JSON)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return None if isinstance(x, float) and not math.isfinite(x) else x


if __name__ == "__main__":
    sys.exit(main())
