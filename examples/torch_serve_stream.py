"""Streaming serving example on the PyTorch/CUDA port: a Poisson query
stream through ``repro_torch.serve.RetrievalEngine``.

Arrivals are simulated on a virtual clock (deterministic queue waits and
deadline misses, independent of host speed); batch execution runs for
real, so the printed reveal fractions and flavors are genuine. Mixed query
lengths exercise the shape buckets: after ``warmup()`` the whole stream
serves with zero builds. ``--autotune`` times the kernels' launch shapes
per shape bucket before warmup (on the card; a no-op on the CPU), reusing
and writing ``--tuning-table``; ``--audit`` audits every warmed bucket
(host reads, dtypes, residency, peak) and prints its report.

  PYTHONPATH=src python examples/torch_serve_stream.py [--n-requests 64]
  PYTHONPATH=src python examples/torch_serve_stream.py --autotune --audit \
      --tuning-table /tmp/tuning.json
  PYTHONPATH=src python examples/torch_serve_stream.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.data.synthetic import make_retrieval_dataset
from repro_torch.serve import EngineConfig, Request, RetrievalEngine


class SimClock:
    """Manually-advanced clock for deterministic arrival simulation."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (plain versions)")
    ap.add_argument("--n-docs", type=int, default=256)
    ap.add_argument("--n-requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="mean arrival rate (requests / simulated second)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--deadline-ms", type=float, default=20.0,
                    help="per-request completion deadline")
    ap.add_argument("--flavor", default="auto",
                    choices=("auto", "dense", "bandit"))
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--autotune", action="store_true",
                    help="time the kernels' launch shapes before warmup")
    ap.add_argument("--tuning-table", default=None,
                    help="tuning table JSON to load and write")
    ap.add_argument("--audit", action="store_true",
                    help="audit every warmed bucket after warmup")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    print(f"building corpus: {args.n_docs} docs on {args.device} ...")
    ds = make_retrieval_dataset(n_docs=args.n_docs, n_queries=args.n_requests,
                                doc_len=48, min_doc_len=12, query_len=32,
                                dim=64, seed=args.seed)

    clock = SimClock()
    cfg = EngineConfig(batch_size=args.batch_size,
                       deadline_s=args.deadline_ms / 1e3,
                       token_buckets=(8, 16, 32), cand_buckets=(32, 64),
                       max_k=10, flavor=args.flavor, bandit_min_candidates=64,
                       alpha_ef=args.alpha, stage1_candidates=32,
                       seed=args.seed, autotune=args.autotune,
                       tuning_table=args.tuning_table, audit=args.audit)
    engine = RetrievalEngine(ds.doc_embs, ds.doc_mask, cfg, clock=clock,
                             device=args.device)

    t0 = time.time()
    buckets = engine.warmup()
    print(f"warmup built {len(buckets)} buckets in {time.time() - t0:.1f}s:")
    for key in buckets:
        print(f"  {key}")
    m = engine.metrics
    if args.autotune or args.tuning_table:
        print(f"autotune: {m.autotune_buckets} kernel buckets tuned (timed on "
              f"the card; untimed on the CPU) in "
              f"{m.autotune_s:.2f}s, {m.tuning_entries_loaded} table "
              "entries loaded")
    if args.audit:
        # warmup() audited every bucket (and raised on a broken contract)
        for key, rep in engine.audit_reports.items():
            print(f"  audit {key}: host reads {rep.host_reads} over "
                  f"{rep.trips} trips, collective {rep.collective_total} B, "
                  f"peak {rep.peak_bytes:.0f} B")

    # Poisson arrivals, mixed query lengths, mixed candidate provenance:
    # half the requests bring their own stage-1 list, half use the engine's.
    gaps = rng.exponential(1.0 / args.rate, args.n_requests)
    arrivals = np.cumsum(gaps)
    done = []
    t0 = time.time()
    for i in range(args.n_requests):
        # serve any admission deadline that expires before the next arrival
        while True:
            exp = engine.next_expiry()
            if exp is None or exp > arrivals[i]:
                break
            clock.t = exp
            done += engine.poll()
        clock.t = float(arrivals[i])
        n_tok = int(rng.integers(4, 33))
        cand = (rng.choice(args.n_docs, 48, replace=False)
                if rng.random() < 0.5 else None)
        engine.submit(Request(query=ds.queries[i][:n_tok], k=10,
                              deadline_s=args.deadline_ms / 1e3,
                              cand_ids=cand))
        done += engine.poll()
    clock.t = float(arrivals[-1]) + cfg.deadline_s + 1e-6
    done += engine.drain()
    wall = time.time() - t0

    for c in done[:8]:
        print(f"  rid={c.rid:3d} flavor={c.flavor:6s} bucket={c.bucket} "
              f"wait={1e3 * c.queue_wait_s:6.2f}ms "
              f"reveal={100 * c.reveal_fraction:5.1f}% "
              f"miss={c.deadline_miss} top1={int(c.topk_ids[0])}")
    if len(done) > 8:
        print(f"  ... ({len(done) - 8} more)")

    s = m.summary()
    print(f"\nserved {s['n_requests']} requests in {s['n_batches']} batches "
          f"({wall:.2f}s wall):")
    print(f"  queue wait p50/p99 (simulated): "
          f"{s['queue_wait_p50_ms']:.2f} / {s['queue_wait_p99_ms']:.2f} ms")
    print(f"  deadline miss rate: {100 * s['deadline_miss_rate']:.1f}%")
    print(f"  mean batch occupancy: {100 * s['mean_occupancy']:.1f}%")
    print(f"  mean reveal fraction: {100 * s['mean_reveal_fraction']:.1f}%")
    print(f"  compiles after warmup: {s['compiles_after_warmup']}")
    return engine, done


if __name__ == "__main__":
    main()
