#!/usr/bin/env python3
"""Count the PyTorch ops a pooled bandit trip issues, on the CPU.

    python3 tools/trip_ops.py [PATH ...] [--ops]

Each PATH is a checkout (``PATH/src/repro_torch``; default ``.``). For
each, a child process runs ``make_serving_step("bandit")`` once per round
body (fused, chain) on a small seeded batch on the CPU (256 docs, 4
queries, 32 candidates) under a ``TorchDispatchMode`` that logs every
aten op, and cuts the log at each call of the draw source's ``round`` (one
per trip). It prints the ops of the middle trip, leaving out views (ops
that launch nothing on a card), and how many of them read a value back
to the host (``_local_scalar_dense``); with ``--ops``, the op counts by
name. It also prints the ops of one ``TorchDraws.round`` at the serving
widths (W = 8, T = 32), after a first, where the checkout has
``core/draws.py``. The counts say what a trip asks of the host, not how
long a card takes.
"""
import argparse
import os
import subprocess
import sys

CHILD = r'''
import collections, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.data.synthetic import make_retrieval_dataset
from repro_torch.retrieval.index import from_numpy
from repro_torch.retrieval.pipeline import candidates_for
from repro_torch.retrieval.service import make_serving_step
try:
    from repro_torch.core.draws import TorchDraws
    seeds = lambda n: TorchDraws().keys(0, n, "cpu")
    per_slot = True
except ImportError:                          # one generator per run
    from repro_torch.core.frontier import TorchDraws
    seeds = lambda n: TorchDraws(0, "cpu")
    per_slot = False
VIEWS = {"aten.slice.Tensor", "aten.view.default", "aten.select.int",
         "aten.unsqueeze.default", "aten.expand.default", "aten.alias.default",
         "aten._unsafe_view.default", "aten.t.default", "aten.permute.default",
         "aten.detach.default", "aten.lift_fresh.default"}


class Log(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def counted(ops):
    return collections.Counter(o for o in ops if o not in VIEWS)


def show(label, c):
    print(f"{label}: {sum(c.values())} ops, "
          f"{c['aten._local_scalar_dense.default']} host reads")
    if sys.argv[2] == "1":
        print("    " + ", ".join(f"{k[5:]} {v}"
                              for k, v in sorted(c.items())))


ds = make_retrieval_dataset(n_docs=256, doc_len=16, min_doc_len=4,
                            query_len=8, dim=16, n_queries=4, seed=0)
idx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device="cpu")
q = torch.as_tensor(ds.queries)
cand = candidates_for(idx.doc_embs, idx.doc_mask, q, kprime=10,
                      max_candidates=32, support=(0.0, 1.0))
args = (idx.doc_embs, idx.doc_mask, q, cand.doc_ids, cand.a, cand.b)
real_round = TorchDraws.round
for engine in ("pooled", "pooled_chain"):
    step = make_serving_step("bandit", topk=5, engine=engine)
    log, marks = Log(), []

    def marked(self, *a, **k):
        marks.append(len(log.ops))
        return real_round(self, *a, **k)

    TorchDraws.round = marked
    with log:
        step(*args, seeds(4))
    TorchDraws.round = real_round
    trips = [log.ops[a:b] for a, b in zip(marks, marks[1:])]
    show(f"{engine} middle trip of {len(marks)}",
         counted(trips[len(trips) // 2]))
if per_slot:
    d = TorchDraws()
    state, _ = d.init(d.keys(0, 16, "cpu"), None, None, 256, 32)
    state, _, _ = d.round(state, 8, 32)      # a trip after the first
    log = Log()
    with log:
        d.round(state, 8, 32)
    show("TorchDraws.round(W=8, T=32)", counted(log.ops))
'''


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", default=["."])
    ap.add_argument("--ops", action="store_true")
    opts = ap.parse_args()
    for path in opts.trees:
        print(f"== {path}", flush=True)
        p = subprocess.run([sys.executable, "-c", CHILD,
                            os.path.abspath(path), "1" if opts.ops else "0"],
                           capture_output=True, text=True)
        print(p.stdout, end="", flush=True)
        if p.returncode:
            sys.exit(f"trip_ops: {path} failed\n{p.stderr[-4000:]}")


if __name__ == "__main__":
    main()
